"""The port's single-modality entry points and ``inference()`` against the
JAX parity engine on one small random bundle, on the CPU.

``bridge.random_state(small_config())`` gives both engines the same weights
(a JAX ``ModelBundle`` is built from the tree directly); generation runs
beam-4 over 8-24 new tokens. Bars: ``classify_image_batch`` and
``classify_text_batch`` (the towers' warm-up heads, BASELINE configs 1-2)
within 1e-5 of the JAX parity engine's probabilities, with identical
thresholded disease vectors; ``inference()`` within 1e-5 on its disease
probabilities and identical on its disease vector, report text and model
version. The JAX engine runs its towers and generation under ``jax.jit``.
The port's fast and turbo engines answer the same calls with [B, 13]
probabilities in [0, 1], fast within 0.1 of parity (the JAX package's
fast-vs-parity bound).

Each test is held to 120 s by an alarm, and a watchdog ends a worker
blocked past 180 s, so that a hang fails one test.
"""
import dataclasses
import faulthandler
import io
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from mmdx_tpu_torch.checkpoints import bridge

TEXTS = ["62 year old male, cough and fever for 3 days", "chest pain",
         "follow-up after pneumonia, shortness of breath on exertion", ""]


def _images():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, (80, 96, 3), dtype=np.uint8),
            rng.integers(0, 256, (80, 96), dtype=np.uint8),
            rng.integers(0, 256, (70, 70, 3), dtype=np.uint8)]


@pytest.fixture(autouse=True)
def time_guard():
    """An alarm raises in a test still running Python code at 120 s; a
    watchdog thread ends the process at 180 s if its main thread is blocked
    in native code, where the alarm cannot run."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module")
def bundles():
    from mmdx_tpu.checkpoints.bundle import ModelBundle
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig

    cfg = bridge.small_config()
    cfg = dataclasses.replace(cfg, generation=dataclasses.replace(
        cfg.generation, max_new_tokens=24, min_new_tokens=8))
    variables = bridge.random_state(cfg, 5)
    tb = bridge.bundle_from_variables(variables, cfg)
    jb = ModelBundle(config=JaxConfig.from_json(cfg.to_json()),
                     variables=jax.tree.map(jnp.asarray, variables),
                     bert_vocab=tb.bert_vocab, t5_vocab=tb.t5_vocab,
                     class_names=tb.class_names, thresholds=tb.thresholds,
                     t5_scores=tb.t5_scores)
    return jb, tb


@pytest.fixture(scope="module")
def engines(bundles):
    from mmdx_tpu.runtime.engine import InferenceEngine as JaxEngine
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    jb, tb = bundles
    return JaxEngine(jb, mode="parity"), InferenceEngine(tb, mode="parity", device="cpu")


def _vectors(engine, probs):
    return [engine.result_dict(p, "")["disease_vector"] for p in probs]


def test_classify_image_batch_matches_jax(engines):
    jax_engine, port = engines
    ref = jax_engine.classify_image_batch(_images())
    got = port.classify_image_batch(_images())
    assert got.shape == ref.shape == (3, 13) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert _vectors(port, got) == _vectors(jax_engine, ref)


def test_classify_text_batch_matches_jax(engines):
    jax_engine, port = engines
    ref = jax_engine.classify_text_batch(TEXTS)
    got = port.classify_text_batch(TEXTS)
    assert got.shape == ref.shape == (4, 13) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert _vectors(port, got) == _vectors(jax_engine, ref)


def test_inference_matches_jax(bundles):
    from mmdx_tpu.pipelines.inference_pipeline import inference as jax_inference
    from mmdx_tpu_torch.pipelines.inference_pipeline import clear_model_bundle, inference

    jb, tb = bundles
    buf = io.BytesIO()
    Image.fromarray(_images()[0]).save(buf, "PNG")
    ref = jax_inference(jb, buf.getvalue(), TEXTS[0])
    got = inference(tb, buf.getvalue(), TEXTS[0], device="cpu")
    clear_model_bundle()
    assert set(got) == set(ref) == {"report_text", "disease_probs", "disease_vector",
                                    "model_version"}
    assert list(got["disease_probs"]) == list(ref["disease_probs"])
    np.testing.assert_allclose(list(got["disease_probs"].values()),
                               list(ref["disease_probs"].values()), rtol=0, atol=1e-5)
    assert got["disease_vector"] == ref["disease_vector"]
    assert got["report_text"] == ref["report_text"]
    assert got["model_version"] == ref["model_version"]


def test_inference_caches_one_parity_engine(bundles):
    from mmdx_tpu_torch.pipelines import inference_pipeline as ip

    _, tb = bundles
    gen = {"max_new_tokens": 9, "min_new_tokens": 2}
    a = ip.inference(tb, _images()[2], TEXTS[1], device="cpu", gen_kwargs=gen)
    engine = ip.get_engine(tb, device="cpu")
    assert engine.mode == "parity" and len(ip._ENGINES) == 1
    b = ip.inference(tb, _images()[2], TEXTS[1], device="cpu", gen_kwargs=gen)
    assert ip.get_engine(tb, device="cpu") is engine and a == b
    ip.clear_model_bundle()


@pytest.mark.parametrize("mode", ["fast", "turbo"])
def test_fast_and_turbo_single_modality(bundles, engines, mode):
    """Fast: the bf16 towers (the text tower through K1/K2's wrappers, their
    plain versions on the CPU) within 0.1 of parity; turbo: the int8 image
    tower (calibrated on its first batch) and W8A8 text blocks answer in
    range. Gray-only batches take turbo's centered-gray stem."""
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    _, port = engines
    engine = InferenceEngine(bundles[1], mode=mode, device="cpu")
    imgs = _images() if mode == "fast" else [_images()[1], _images()[1][::-1].copy()]
    p_img, p_txt = engine.classify_image_batch(imgs), engine.classify_text_batch(TEXTS)
    for p, n in ((p_img, len(imgs)), (p_txt, len(TEXTS))):
        assert p.shape == (n, 13) and np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()
    if mode == "fast":
        assert np.abs(p_img - port.classify_image_batch(imgs)).max() < 0.1
        assert np.abs(p_txt - port.classify_text_batch(TEXTS)).max() < 0.1
