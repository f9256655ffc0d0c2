"""Greedy report generation and the decode-layer switches through the port's
engine and WSGI app, on the CPU at small sizes (``bridge.small_config()``
weights from one numpy seed; the kernel wrappers run their plain versions
on CPU tensors).

* parity greedy token ids identical to the JAX parity engine's
  ``generate_report_ids(greedy=True)`` (as tests/test_torch_engine.py:70-72
  holds beam);
* the fused lm head (``MMDX_FUSED_LM_HEAD=1``) gives the dense route's
  greedy ids (tests/test_lm_head.py:149) and beam ids, beam scores to 1e-4
  (:196-197); the non-deferred beam read (``MMDX_DEFER_KV=0``) gives the
  deferred route's ids, scores to 1e-4 (tests/test_pallas_beam_attn.py:310-311).
  The beam comparisons run the fast routes at f32 on the parity engine's
  weights, as the JAX tests do: in bf16 the two routes round at different
  points and the random-weight beams part on near-ties;
* the switches are read once at construction in fast mode and ignored in
  parity mode; the int8 cache decodes greedy and beam;
* ``/api/predict/`` with greedy generation (``MMDX_GEN_MODE=greedy`` sets
  ``make_app(greedy=True)``) answers 200 with a report.
"""
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.decode.beam_search import (beam_expand, beam_search,
                                               make_generation_kwargs)
from mmdx_tpu_torch.runtime.engine import InferenceEngine


@pytest.fixture(scope="module")
def setup():
    """Small config with 8-24 new tokens; a chunk-aligned 512-token vocab
    variant for the lm-head routes; conditioning embeddings from a seed."""
    cfg = bridge.small_config()
    cfg = dataclasses.replace(cfg, generation=dataclasses.replace(
        cfg.generation, max_new_tokens=24, min_new_tokens=8))
    cfg512 = dataclasses.replace(cfg, report=dataclasses.replace(cfg.report,
                                                                 vocab_size=512))
    rng = np.random.default_rng(7)
    zi = rng.standard_normal((3, cfg.fusion.d_img)).astype(np.float32)
    zt = rng.standard_normal((3, cfg.fusion.d_txt)).astype(np.float32)
    return dict(
        cfg=cfg, variables=bridge.random_state(cfg, 0), zi=zi, zt=zt,
        bundle=bridge.bundle_from_variables(bridge.random_state(cfg, 0), cfg),
        bundle512=bridge.bundle_from_variables(bridge.random_state(cfg512, 0), cfg512))


def _engine(bundle, mode, monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    engine = InferenceEngine(bundle, mode=mode, device="cpu")
    for k in env:
        monkeypatch.delenv(k)
    return engine


def test_parity_greedy_ids_match_jax(setup):
    from mmdx_tpu.checkpoints.bundle import ModelBundle
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu.runtime.engine import InferenceEngine as JaxEngine

    cfg, tb = setup["cfg"], setup["bundle"]
    jb = ModelBundle(config=JaxConfig.from_json(cfg.to_json()),
                     variables=jax.tree.map(jnp.asarray, setup["variables"]),
                     bert_vocab=tb.bert_vocab, t5_vocab=tb.t5_vocab,
                     class_names=tb.class_names, thresholds=tb.thresholds,
                     t5_scores=tb.t5_scores)
    ref = JaxEngine(jb, mode="parity").generate_report_ids(setup["zi"], setup["zt"],
                                                           greedy=True)
    got = InferenceEngine(tb, mode="parity", device="cpu").generate_report_ids(
        setup["zi"], setup["zt"], greedy=True)
    assert got.shape == np.asarray(ref).shape == (3, 25)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_fast_greedy_fused_lm_head_matches_dense(setup, monkeypatch):
    tb = setup["bundle512"]
    dense = _engine(tb, "fast", monkeypatch)
    fused = _engine(tb, "fast", monkeypatch, MMDX_FUSED_LM_HEAD="1")
    assert fused.fused_lm_head and not dense.fused_lm_head
    ids = [e.generate_report_ids(setup["zi"], setup["zt"], greedy=True)
           for e in (dense, fused)]
    assert ids[0].shape == (3, 25) and (ids[0][:, 0] == 0).all()
    np.testing.assert_array_equal(ids[1], ids[0])


def _beam_f32(bundle, setup, **step_kw):
    """Beam search through the fast decode routes (kernel wrappers, their
    plain versions here) on the parity engine's f32 model."""
    model = InferenceEngine(bundle, mode="parity", device="cpu").model
    gen = bundle.config.generation
    nb, lmax = gen.num_beams, 1 + gen.max_new_tokens
    zi, zt = (beam_expand(torch.from_numpy(z), nb) for z in (setup["zi"], setup["zt"]))
    with torch.inference_mode():
        prep = model.prepare_generation(zi, zt, lmax, nb)

        def step(tokens, pos, anc):
            return model.decode_step_beam(tokens, pos, prep["cache"], anc,
                                          prep["static_kv"], prep["self_bias"],
                                          prep["enc_mask"], kernels=True, **step_kw)

        seqs, scores = beam_search(step, batch=3, vocab_size=bundle.config.report.vocab_size,
                                   device="cpu", **make_generation_kwargs(gen))
    return seqs.numpy(), scores.numpy()


@pytest.mark.parametrize("route", ["fused_lm_head", "nondeferred"])
def test_beam_routes_match_default(setup, route):
    tb = setup["bundle512"]
    base = _beam_f32(tb, setup)
    kw = dict(lazy_logits=True) if route == "fused_lm_head" else dict(defer=False)
    seqs, scores = _beam_f32(tb, setup, **kw)
    assert seqs.shape == (3, 25)
    np.testing.assert_array_equal(seqs, base[0])
    np.testing.assert_allclose(scores, base[1], rtol=1e-4)


def test_switches_read_at_construction(setup, monkeypatch):
    """Fast mode reads the three switches once; parity ignores them; the
    int8-KV + fused-head engine decodes greedy and beam to valid ids."""
    tb = setup["bundle512"]
    env = dict(MMDX_KV_INT8="1", MMDX_FUSED_LM_HEAD="1", MMDX_DEFER_KV="0")
    parity = _engine(tb, "parity", monkeypatch, **env)
    assert not parity.kv_int8 and not parity.fused_lm_head
    fast = _engine(tb, "fast", monkeypatch, **env)
    assert fast.kv_int8 and fast.fused_lm_head and not fast.defer_kv
    default = _engine(tb, "fast", monkeypatch)
    assert not default.kv_int8 and not default.fused_lm_head and default.defer_kv
    for greedy in (True, False):
        ids = fast.generate_report_ids(setup["zi"], setup["zt"], greedy=greedy)
        assert ids.shape == (3, 25) and (ids[:, 0] == 0).all()
        assert ((ids >= 0) & (ids < 512)).all()


def test_predict_greedy_through_app(setup, monkeypatch):
    from PIL import Image

    from mmdx_tpu_torch.config import DISEASES
    from mmdx_tpu_torch.serve.wsgi import make_app

    seen = []
    generate = InferenceEngine.generate_report_ids

    def spy(self, *args, greedy=False, **kw):
        seen.append(greedy)
        return generate(self, *args, greedy=greedy, **kw)

    monkeypatch.setattr(InferenceEngine, "generate_report_ids", spy)
    app = make_app(bundle=setup["bundle"], engine_mode="fast", generate_reports=True,
                   greedy=True, gen_overrides=dict(max_new_tokens=6, min_new_tokens=2),
                   device="cpu")
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (120, 100, 3), dtype=np.uint8)).save(buf, "PNG")
    boundary = b"greedyboundary"
    body = b"\r\n".join([
        b"--" + boundary, b'Content-Disposition: form-data; name="patient_details"',
        b"", b"31 year old male, cough",
        b"--" + boundary,
        b'Content-Disposition: form-data; name="image"; filename="x.png"',
        b"Content-Type: image/png", b"", buf.getvalue(), b"--" + boundary + b"--"])
    status = {}
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/api/predict/",
               "CONTENT_TYPE": "multipart/form-data; boundary=" + boundary.decode(),
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    try:
        raw = b"".join(app(environ, lambda s, h: status.setdefault("s", s)))
    finally:
        if app._batcher is not None:
            app._batcher.stop(drain=True)
    assert status["s"].startswith("200"), raw
    payload = json.loads(raw)
    assert [d["name"] for d in payload["diseases"]] == DISEASES
    assert isinstance(payload["report_text"], str)
    assert seen and all(seen)
