"""The port's serving slice against the JAX engine on one small bundle.

``new_random_bundle(small=True)`` with beam-4 over 8-24 new tokens; the port
gets the same weights through ``variables_to_torch``. Bars: parity
probabilities within 1e-5 of the JAX parity engine, identical thresholded
disease vectors and identical beam token ids; the port's fast mode (bf16
towers, kernel wrappers on their plain versions for CPU tensors) within 0.1
of its parity probabilities, the JAX package's own fast-vs-parity bound
(tests/test_bundle_engine.py:76).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from mmdx_tpu.checkpoints.bundle import new_random_bundle
from mmdx_tpu_torch.checkpoints.bridge import bundle_from_variables

TEXTS = ["62 year old male, cough and fever for 3 days", "chest pain",
         "follow-up after pneumonia, shortness of breath on exertion"]


def _images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (80, 96, 3), dtype=np.uint8),
            rng.integers(0, 256, (80, 96), dtype=np.uint8),
            rng.integers(0, 256, (70, 70, 3), dtype=np.uint8)]


@pytest.fixture(scope="module")
def bundles():
    bundle = new_random_bundle(seed=0, small=True)
    gen = dataclasses.replace(bundle.config.generation, max_new_tokens=24,
                              min_new_tokens=8)
    bundle.config = dataclasses.replace(bundle.config, generation=gen)
    tb = bundle_from_variables(jax.tree.map(np.asarray, bundle.variables),
                               bundle.config)
    return bundle, tb


@pytest.fixture(scope="module")
def jax_parity(bundles):
    from mmdx_tpu.runtime.engine import InferenceEngine

    engine = InferenceEngine(bundles[0], mode="parity")
    probs, z_img, z_txt = engine.classify_batch(_images(), TEXTS)
    ids = engine.generate_report_ids(z_img, z_txt)
    return np.asarray(probs), np.asarray(ids), engine


@pytest.fixture(scope="module")
def port_parity(bundles):
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(bundles[1], mode="parity", device="cpu")
    probs, z_img, z_txt = engine.classify_batch(_images(), TEXTS)
    return probs, engine.generate_report_ids(z_img, z_txt), engine


def test_parity_probs_and_vectors_match_jax(jax_parity, port_parity):
    np.testing.assert_allclose(port_parity[0], jax_parity[0], rtol=0, atol=1e-5)
    for pj, pt in zip(jax_parity[0], port_parity[0]):
        assert (jax_parity[2].result_dict(pj, "")["disease_vector"]
                == port_parity[2].result_dict(pt, "")["disease_vector"])


def test_parity_beam_token_ids_match_jax(jax_parity, port_parity):
    assert port_parity[1].shape == jax_parity[1].shape == (3, 25)
    np.testing.assert_array_equal(port_parity[1], jax_parity[1])


def test_fast_mode_close_to_parity(bundles, port_parity):
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(bundles[1], mode="fast", device="cpu")
    assert engine.dtype == torch.bfloat16
    probs, z_img, z_txt = engine.classify_batch(_images(), TEXTS)
    assert probs.shape == (3, 13) and np.isfinite(probs).all()
    assert np.max(np.abs(probs - port_parity[0])) < 0.1
    ids = engine.generate_report_ids(z_img, z_txt)
    assert ids.shape == (3, 25) and (ids[:, 0] == 0).all()
    out = engine.infer(_images()[0], TEXTS[0])
    assert set(out) == {"report_text", "disease_probs", "disease_vector", "model_version"}


def test_reference_bundle_pt_loads_like_the_bridge(bundles, port_parity, tmp_path):
    from mmdx_tpu.checkpoints.torch_export import bundle_to_torch
    from mmdx_tpu_torch.checkpoints.bridge import load_reference_bundle_pt
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    path = bundle_to_torch(bundles[0], tmp_path / "model_bundle.pt")
    loaded = load_reference_bundle_pt(path, config=bundles[0].config)  # strict load
    bridged = bundles[1].model.state_dict()
    for k, v in loaded.model.state_dict().items():
        if k in bridged:
            torch.testing.assert_close(v, bridged[k], rtol=0, atol=0)
    probs, _, _ = InferenceEngine(loaded, mode="parity", device="cpu").classify_batch(
        _images(), TEXTS)
    np.testing.assert_array_equal(probs, port_parity[0])


def test_unported_modes_raise(bundles):
    """Turbo is ported (it builds on the CPU, W8A8 text blocks on); a mesh
    still raises."""
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    turbo = InferenceEngine(bundles[1], mode="turbo", device="cpu")
    assert turbo.kernels and turbo.text_int8 and turbo.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError):
        InferenceEngine(bundles[1], mode="fast", device="cpu", mesh=object())


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_no_device_without_cuda_raises(bundles, mode, monkeypatch):
    """With no card the engine never picks the CPU by itself."""
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(bundles[1], mode=mode)
