"""The port's turbo tier against the JAX package, on the CPU at small sizes.

* K5 (``ops/int8_gemm.py``): the plain versions against the Pallas int8 GEMMs
  in interpret mode, int8 outputs identical;
* K6, K7 (the W8A8 BERT blocks): plain versions against the Pallas int8
  blocks in interpret mode at f32, 1e-4;
* the int8 tower (``models/resnet_int8.py``) on the same int8 weights as the
  JAX tower (``bridge.qparams_from_jax``), and the port's own calibration and
  quantization against JAX's;
* gray preprocessing, the W8A8 text tower, and the turbo engine against the
  JAX turbo engine on one small bundle with the same persisted scales;
* the modules the port copies from the JAX package (tokenizers, resize
  matrices, config) against their originals.

Inputs are made from seeds with numpy and handed to both sides.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.models import resnet_int8 as ri
from mmdx_tpu_torch.ops import bert_attn, fused_ffn, int8_gemm

TEXTS = ["62 year old male, cough and fever for 3 days", "chest pain",
         "follow-up after pneumonia, shortness of breath on exertion"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------------------------------------------------------------------------
# K5: int8 GEMM + requant, bit-exact against the Pallas functions
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gemm_data():
    rng = np.random.default_rng(0)
    m, k, n = 96, 40, 64
    return dict(
        x=rng.integers(-127, 128, (m, k)).astype(np.int8),
        w=rng.integers(-127, 128, (k, n)).astype(np.int8),
        alpha=rng.uniform(1e-4, 1e-2, n).astype(np.float32),
        bias=rng.standard_normal(n).astype(np.float32),
        res=rng.integers(-127, 128, (m, n)).astype(np.int8),
        x2=rng.integers(-127, 128, (m, 2 * k)).astype(np.int8),
        w2=rng.integers(-127, 128, (2 * k, n)).astype(np.int8),
        alpha2=rng.uniform(1e-4, 1e-2, n).astype(np.float32),
        bias2=rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("case", ["requant_relu", "requant_no_relu", "residual", "dual"])
def test_int8_gemm_plain_matches_pallas(gemm_data, case):
    from mmdx_tpu.ops import pallas_int8_gemm as pg

    d = gemm_data
    s = np.float32(0.37)
    with pltpu.force_tpu_interpret_mode():
        if case.startswith("requant"):
            relu = case == "requant_relu"
            ref = pg.int8_gemm_requant(d["x"], d["w"], d["alpha"], d["bias"], s, relu=relu)
            got = int8_gemm.int8_gemm_requant(_t(d["x"]), _t(d["w"].T), _t(d["alpha"]),
                                              _t(d["bias"]), s, relu=relu)
        elif case == "residual":
            rs = np.float32(0.011)
            ref = pg.int8_gemm_res_requant(d["x"], d["w"], d["alpha"], d["bias"],
                                           d["res"], rs, s)
            got = int8_gemm.int8_gemm_res_requant(_t(d["x"]), _t(d["w"].T), _t(d["alpha"]),
                                                  _t(d["bias"]), _t(d["res"]), rs, s)
        else:
            ref = pg.int8_gemm_dual_requant(d["x"], d["w"], d["alpha"], d["bias"],
                                            d["x2"], d["w2"], d["alpha2"], d["bias2"], s)
            got = int8_gemm.int8_gemm_dual_requant(
                _t(d["x"]), _t(d["w"].T), _t(d["alpha"]), _t(d["bias"]), _t(d["x2"]),
                _t(d["w2"].T), _t(d["alpha2"]), _t(d["bias2"]), s)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_gemm_positional_bias_and_k_padding():
    """The gray stem's [P, N] bias map against the plain per-row arithmetic,
    and its K = 49 (no multiple of 16): the K-major weights [N, K] padded
    once with zero columns (``gemm_weight``) and the im2col's zero columns
    give the same product as the unpadded operands."""
    rng = np.random.default_rng(1)
    n = 64
    img = _t(rng.integers(0, 128, (3, 6, 4, 1)).astype(np.int8))
    w = _t(rng.integers(-127, 128, (7, 7, 1, n)).astype(np.int8))
    wk = ri.gemm_weight(w)
    assert wk.shape == (n, 64) and wk.shape[1] % int8_gemm.K_ALIGN == 0
    assert wk.is_contiguous()
    assert torch.equal(wk[:, :49], w.reshape(49, n).T) and not wk[:, 49:].any()
    x, ho, wo = ri.im2col_s8(img, 7, 2, 3)
    xp, _, _ = ri.im2col_s8(img, 7, 2, 3, wk.shape[1])
    assert x.shape == (3 * ho * wo, 49) and xp.shape == (3 * ho * wo, 64)
    assert torch.equal(xp[:, :49], x) and not xp[:, 49:].any()
    p = ho * wo
    alpha = _t(rng.uniform(1e-4, 1e-2, n).astype(np.float32))
    bmap = _t(rng.standard_normal((p, n)).astype(np.float32))
    got = int8_gemm.int8_gemm_requant(xp, wk, alpha, bmap, 0.25)
    assert torch.equal(got, int8_gemm.int8_gemm_requant(x, w.reshape(49, n).T, alpha, bmap,
                                                        0.25))
    for r in range(3 * p):
        row = int8_gemm.int8_gemm_requant(xp[r:r + 1], wk, alpha, bmap[r % p], 0.25)
        assert torch.equal(got[r], row[0])


# ---------------------------------------------------------------------------
# K6, K7: the W8A8 text blocks
# ---------------------------------------------------------------------------
def _mk(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# W8A8 bars (K6, K7). Both blocks quantize an f32 intermediate per row a second
# time (the tanh-GELU output, the attention context) before the output
# product. Its f32 value differs by an ulp or two between the two sides: XLA's
# CPU tanh, exp and fused multiply-adds are its own code, chosen for the
# host's vector width, and torch's are others. round(v / s) flips by one where
# v / s lies that close to a .5 tie, about once in 1e5 elements. One flip moves
# the output row by one quantization step, far above 1e-4 (on these shapes 2
# of 60 seeds flip a row on one host). So: the int8 values agree except for
# rare +-1 flips; the outputs agree to 1e-4 except at a flip-prone row (an
# element within TIE_MARGIN of a tie), at most MAX_FLIP_ROWS of them, each
# within one quantization step.
TIE_MARGIN = 2e-4      # |v/s| <= 127 and a few ulps each of v and s: ~6e-5
MAX_FLIP_FRACTION = 1e-3
MAX_FLIP_ROWS = 2


def _assert_int8_flips(got, ref):
    """int8 intermediates equal except +-1 flips in a small fraction."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1, d.max()
    assert np.count_nonzero(d) <= MAX_FLIP_FRACTION * d.size, np.count_nonzero(d)


def _assert_w8a8_rows_close(got, ref, v, y, w_out, ln_scale):
    """Outputs to 1e-4, except rows that one flip of the port's second row
    quantization (of ``v [M, K]`` f32, before the product with ``w_out
    [K, H]``) can move: those within one quantization step. A step moves the
    pre-LayerNorm row ``y`` by at most s * max|w_out|; the LayerNorm scales
    that by max|ln_scale| / std(y), and the mean and variance terms at most
    double it."""
    got, ref, v, y = (np.asarray(a, np.float64) for a in (got, ref, v, y))
    s = np.maximum(np.abs(v).max(-1), 1e-12) / 127.0
    r = np.abs(v / s[:, None])
    near_tie = (np.abs(r - np.floor(r) - 0.5) < TIE_MARGIN).any(-1)
    step = 2 * s * np.abs(w_out).max() * np.abs(ln_scale).max() / y.std(-1)
    diff = np.abs(got - ref)
    off = np.nonzero((diff > 1e-4 + 1e-4 * np.abs(ref)).any(-1))[0]
    assert len(off) <= MAX_FLIP_ROWS, off
    for row in off:
        assert near_tie[row], (row, diff[row].max())
        assert diff[row].max() <= step[row], (row, diff[row].max(), step[row])


def test_ffn_int8_plain_matches_pallas():
    """K6 plain vs the Pallas body in interpret mode; bars as stated above
    (the GELU output's requantization is the flip site)."""
    from mmdx_tpu.ops import pallas_ffn as pf

    rng = np.random.default_rng(1)
    m, h, f = 64, 128, 256
    x = _mk(rng, (m, h))
    wi, bi = _mk(rng, (h, f), 0.1), _mk(rng, (f,), 0.05)
    wo, bo = _mk(rng, (f, h), 0.1), _mk(rng, (h,), 0.05)
    lns, lnb = 1.0 + _mk(rng, (h,), 0.1), _mk(rng, (h,), 0.1)
    with pltpu.force_tpu_interpret_mode():
        ref = pf.fused_ffn_ln_int8(x, wi, bi, wo, bo, lns, lnb, block_rows=32)
    wi_q, wo_q = fused_ffn.quant_weight_cols(_t(wi)), fused_ffn.quant_weight_cols(_t(wo))
    got = fused_ffn.fused_ffn_ln_int8(_t(x), *wi_q, _t(bi), *wo_q, _t(bo), _t(lns),
                                      _t(lnb))
    # the port's intermediates, and the Pallas module's GELU + quantizer on
    # its own (jitted) mid
    xi, sx = fused_ffn.quant_rows(_t(x))
    g = fused_ffn.gelu_tanh(int8_gemm.exact_matmul_s8(xi, wi_q[0].T) * (sx[:, None] * wi_q[1])
                            + _t(bi))
    gi, sg = fused_ffn.quant_rows(g)
    y = int8_gemm.exact_matmul_s8(gi, wo_q[0].T) * (sg[:, None] * wo_q[1]) + _t(bo) + _t(x)

    @jax.jit
    def jax_gi(x, wi, bi):
        xq, xs = pf._quant_rows(x)
        wq, ws = pf.quant_weight_cols(wi)
        mid = jnp.dot(xq.astype(jnp.int32), wq.astype(jnp.int32)).astype(jnp.float32)
        return pf._quant_rows(pf._gelu_tanh(mid * (xs * ws) + bi))[0]

    _assert_int8_flips(gi.numpy(), jax_gi(x, wi, bi))
    _assert_w8a8_rows_close(got.numpy(), ref, g.numpy(), y.numpy(),
                            (wo_q[0].T.to(torch.float32) * wo_q[1]).numpy(), lns)


def test_attn_int8_plain_matches_pallas():
    """K7 plain vs the Pallas body in interpret mode; bars as stated above
    (the attention context's requantization is the flip site: the two sides
    compute the scores' scale and the softmax exp apart)."""
    from mmdx_tpu.ops import pallas_ffn as pf
    from mmdx_tpu.ops.pallas_bert_attn import fused_attention_block

    rng = np.random.default_rng(2)
    b, l, h, heads = 16, 8, 128, 4
    m, d = b * l, h // heads
    x = _mk(rng, (m, h))
    kmask = np.where(rng.random((m,)) < 0.15, -1e9, 0.0).astype(np.float32)
    wqkv, bqkv = _mk(rng, (h, 3 * h), 0.1), _mk(rng, (3 * h,), 0.05)
    wo, bo = _mk(rng, (h, h), 0.1), _mk(rng, (h,), 0.05)
    lns, lnb = 1.0 + _mk(rng, (h,), 0.1), _mk(rng, (h,), 0.1)
    with pltpu.force_tpu_interpret_mode():
        ref = fused_attention_block(x, kmask, wqkv, bqkv, wo, bo, lns, lnb, seq_len=l,
                                    num_heads=heads, int8_matmuls=True)
    wqkv_q, wo_q = fused_ffn.quant_weight_cols(_t(wqkv)), fused_ffn.quant_weight_cols(_t(wo))
    got = bert_attn.fused_attention_block_int8(
        _t(x), _t(kmask), *wqkv_q, _t(bqkv), *wo_q, _t(bo), _t(lns), _t(lnb),
        seq_len=l, num_heads=heads)
    xi, sx = fused_ffn.quant_rows(_t(x))
    qkv = (int8_gemm.exact_matmul_s8(xi, wqkv_q[0].T) * (sx[:, None] * wqkv_q[1])
           + _t(bqkv))
    ctx = bert_attn.attention_ctx_f32(qkv, _t(kmask), l, heads)
    ci, sc = fused_ffn.quant_rows(ctx)
    y = _t(x) + int8_gemm.exact_matmul_s8(ci, wo_q[0].T) * (sc[:, None] * wo_q[1]) + _t(bo)

    @jax.jit
    def jax_ci(x, kmask, wqkv, bqkv):  # _kernel_int8's chain, per sequence
        xq, xs = pf._quant_rows(x)
        wq, ws = pf.quant_weight_cols(wqkv)
        qkv = jnp.dot(xq.astype(jnp.int32), wq.astype(jnp.int32)).astype(jnp.float32)
        qkv = (qkv * (xs * ws) + bqkv).reshape(b, l, 3, heads, d)
        s = jnp.einsum("bqhd,bkhd->bhqk", qkv[:, :, 0], qkv[:, :, 1]) * (1.0 / d ** 0.5)
        s = s + kmask.reshape(b, 1, 1, l)
        e = jnp.exp(s - s.max(-1, keepdims=True))
        p = e / e.sum(-1, keepdims=True)
        ctx = jnp.einsum("bhqk,bkhd->bqhd", p, qkv[:, :, 2]).reshape(m, h)
        return pf._quant_rows(ctx)[0]

    _assert_int8_flips(ci.numpy(), jax_ci(x, kmask, wqkv, bqkv))
    _assert_w8a8_rows_close(got.numpy(), ref, ctx.numpy(), y.numpy(),
                            (wo_q[0].T.to(torch.float32) * wo_q[1]).numpy(), lns)


def test_text_tower_int8_matches_jax(tower):
    """The port's TextEncoder with W8A8 blocks vs the JAX TextEncoder with
    ``int8_matmuls`` in interpret mode (tests/test_int8_text.py:83-101), on
    the small config's text weights."""
    from mmdx_tpu.config import TextEncoderConfig
    from mmdx_tpu.models.bert import TextEncoder as JaxTextEncoder
    from mmdx_tpu_torch.models.bert import TextEncoder

    cfg = bridge.small_config().text
    c8 = TextEncoderConfig(**{**dataclasses.asdict(cfg), "use_fused_attn_block": True,
                              "use_fused_ffn": True, "int8_matmuls": True})
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg.vocab_size, (8, 16))
    mask = (np.arange(16)[None, :] < rng.integers(4, 17, (8, 1))).astype(np.int32)
    params = tower["variables"]["params"]["text_encoder"]
    with pltpu.force_tpu_interpret_mode():
        ref = JaxTextEncoder(config=c8).apply({"params": params}, ids, mask)["embeddings"]

    port = TextEncoder(cfg)
    state = bridge._text_state(params, type("C", (), {"text": cfg}))
    port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in state.items()}, strict=True)
    with torch.inference_mode():
        got = port.eval().quantize_int8_().encode(
            _t(ids).long(), _t(mask).long(), kernels=True, int8=True)
    ref = np.asarray(ref)
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 1e-4, rel


# ---------------------------------------------------------------------------
# the int8 tower
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tower():
    """Small-config weights (numpy, seeded), 64x64 inputs (3-channel
    normalized, and the centered gray), the JAX calibration and qparams."""
    from mmdx_tpu.models import resnet_int8 as jri

    cfg = bridge.small_config()
    variables = bridge.random_state(cfg, 0)
    rng = np.random.default_rng(3)
    # smooth blobs, not white noise (tests/test_resnet_int8.py)
    base = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x3 = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)
    x3 = (x3 + 0.1 * rng.standard_normal(x3.shape)).astype(np.float32)
    gray = np.clip(x3[..., :1] * 0.2 + 0.5, 0.0, 1.0).astype(np.float32) - 0.5
    scales = jri.calibrate_backbone(variables, x3)
    q_jax = jax.tree.map(np.asarray, jax.jit(
        lambda v: jri.quantize_backbone(v, scales, img_size=64))(variables))
    folded = ri.folded_backbone(
        bridge.bundle_from_variables(variables, cfg).model.image_encoder.backbone)
    return dict(variables=variables, x3=x3, gray=gray, scales=scales, q_jax=q_jax,
                folded=folded)


@pytest.mark.parametrize("channels", ["rgb", "gray"])
def test_int8_tower_matches_jax_on_same_int8_weights(tower, channels):
    from mmdx_tpu.models import resnet_int8 as jri

    x = tower["x3"] if channels == "rgb" else tower["gray"]
    # eager, as the Pallas int8 GEMM bodies compute: under jit XLA may
    # rewrite the requant's divide and the epilogue's multiply-add
    ref = np.asarray(jri.int8_backbone_apply(tower["q_jax"], x))
    got = ri.int8_backbone_apply(bridge.qparams_from_jax(tower["q_jax"]), _t(x)).numpy()
    assert got.shape == ref.shape == (2, 2048)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-3, rel


def test_calibration_matches_jax(tower):
    got = ri.calibrate_backbone(tower["folded"], _t(tower["x3"]))
    assert sorted(got) == sorted(ri.calibration_sites())
    for site, ref in tower["scales"].items():
        assert abs(got[site] - ref) <= 1e-4 * abs(ref), (site, got[site], ref)


def _weights_one_step_apart(q, ref) -> tuple[int, int]:
    """The port's qparams ``q`` against the JAX tree ``ref``: the same
    scales, every int8 weight within one step, the biases within 1e-5.
    -> (weights one step apart, weights)."""
    assert q["scales"] == bridge.qparams_from_jax(ref)["scales"]
    total = off = 0
    for name in ["stem", "stem_gray"] + [n for n in ref if n.startswith("layer")]:
        convs = {"": q[name]} if "w" in q[name] else q[name]
        refs = {"": ref[name]} if "w" in ref[name] else ref[name]
        assert convs.keys() == refs.keys()
        for k, c in convs.items():
            # every tensor contiguous but the HWIO "w", a view of the
            # K-major "wk" [co, K] (one copy of each weight)
            assert all(t.is_contiguous() for kk, t in c.items() if kk != "w"), (name, k)
            assert c["w"].data_ptr() == c["wk"].data_ptr(), (name, k)
            assert c["wk"].shape[0] == c["w"].shape[-1], (name, k)
            assert torch.equal(c["wk"], ri.gemm_weight(c["w"])), (name, k)
            d = c["w"].to(torch.int32).numpy() - refs[k]["w"].astype(np.int32)
            assert np.abs(d).max() <= 1, (name, k)
            total, off = total + d.size, off + np.count_nonzero(d)
            np.testing.assert_allclose(c["b"].numpy(), refs[k]["b"], rtol=1e-5, atol=1e-5)
    return off, total


def test_quantize_matches_jax(tower):
    q = ri.quantize_backbone(tower["folded"], tower["scales"], img_size=64)
    off, total = _weights_one_step_apart(q, tower["q_jax"])
    assert off < 1e-3 * total, (off, total)


def test_gray_preprocess_matches_jax():
    from mmdx_tpu.ops.preprocess import preprocess_batch_device_gray as jax_gray
    from mmdx_tpu_torch.ops.preprocess import preprocess_batch_device_gray

    imgs = np.random.default_rng(11).integers(0, 256, (2, 96, 80, 1), dtype=np.uint8)
    ref = np.asarray(jax_gray(jnp.asarray(imgs), img_size=48, resize_size=56))
    got = preprocess_batch_device_gray(_t(imgs), img_size=48, resize_size=56).numpy()
    assert got.shape == ref.shape == (2, 48, 48, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the slice: the turbo engine against the JAX turbo engine
# ---------------------------------------------------------------------------
def _turbo_engines(variables, scales, n_port: int = 1):
    """The JAX turbo engine and ``n_port`` port turbo engines on one small
    bundle with the same persisted int8 scales. The JAX engine on the CPU keeps its
    text tower bf16, so the port runs with MMDX_TEXT_INT8=0."""
    from mmdx_tpu.checkpoints.bundle import ModelBundle
    from mmdx_tpu.config import DiagnosisConfig as JaxConfig
    from mmdx_tpu.runtime.engine import InferenceEngine as JaxEngine
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    cfg = bridge.small_config()
    meta = {"int8_scales": dict(scales)}
    tb = bridge.bundle_from_variables(variables, cfg, metadata=meta)
    jb = ModelBundle(config=JaxConfig.from_json(cfg.to_json()),
                     variables=jax.tree.map(jnp.asarray, variables),
                     bert_vocab=tb.bert_vocab, t5_vocab=tb.t5_vocab,
                     class_names=tb.class_names, thresholds=tb.thresholds,
                     metadata=meta, t5_scores=tb.t5_scores)
    mp = pytest.MonkeyPatch()
    mp.setenv("MMDX_TEXT_INT8", "0")
    ports = [InferenceEngine(tb, mode="turbo", device="cpu") for _ in range(n_port)]
    mp.undo()
    return (JaxEngine(jb, mode="turbo"), *ports)


@pytest.fixture(scope="module")
def engines(tower):
    """Two port engines beside the JAX turbo engine: one quantizes the tower
    itself from the scales, one takes the JAX engine's int8 weights
    (``bridge.qparams_from_jax``)."""
    jax_engine, own, shared = _turbo_engines(tower["variables"], tower["scales"], 2)
    shared._qparams = bridge.qparams_from_jax(
        jax.tree.map(np.asarray, jax_engine._ensure_qparams(None)))
    return jax_engine, own, shared


def _jax_turbo_probs_eager_tower(jax_engine, imgs):
    """The JAX turbo engine's classify program (``engine.py:285-330``: its
    preprocessing, qparams, text tower and heads) with the int8 tower run op
    by op, as its Pallas GEMM bodies compute. Under ``jit`` XLA rewrites the
    tower's requant divides and multiply-adds, which moves its pooled
    features by 0.9-1.6% rel-L2 on this bundle; the port's tower is held to
    the eager one (test_int8_tower_matches_jax_on_same_int8_weights)."""
    from mmdx_tpu.models import resnet_int8 as jri
    from mmdx_tpu.models.diagnosis import MultiModalDiagnosisModel
    from mmdx_tpu.ops.preprocess import (preprocess_batch_device,
                                         preprocess_batch_device_gray)

    cfg = jax_engine.bundle.config.image
    x = jnp.asarray(jax_engine.prep_images(imgs))
    if x.shape[-1] == 1:
        x = preprocess_batch_device_gray(x, cfg.img_size, cfg.resize_size,
                                         out_dtype=jax_engine.model.dtype)
    else:
        x = preprocess_batch_device(x, cfg.img_size, cfg.resize_size, cfg.mean,
                                    cfg.std, out_dtype=jax_engine.model.dtype)
    feats = jri.int8_backbone_apply(jax_engine._ensure_qparams(None), x)
    tok = jax_engine.prep_texts(TEXTS)
    heads = jax.jit(functools.partial(
        jax_engine.model.apply, method=MultiModalDiagnosisModel.classify_from_image_feats))
    out = heads(jax_engine.variables, feats, tok["input_ids"], tok["attention_mask"],
                tok["token_type_ids"])
    return np.asarray(out["probs"], np.float32)


@pytest.mark.parametrize("channels", ["gray", "rgb", "gray-resized"])
def test_turbo_engine_matches_jax_turbo(engines, channels):
    """Gray and RGB images at the wire size the server submits (the shorter
    side already at resize_size: the device resize is an identity), and gray
    images that the device resize shrinks.

    Against the JAX turbo engine with its int8 tower eager, on the same int8
    weights the probabilities agree within 1e-2 at the wire size (bf16 noise
    of the two text towers). With the port's own quantization from the same scales, and
    against the jitted JAX engine itself, the bound is the JAX package's
    turbo guard, 0.05 (tests/test_resnet_int8.py:297): the port's BN fold
    keeps the JAX order, scale * rsqrt(var + eps), but XLA's CPU rsqrt is an
    estimate and the port's is rounded once from f64, so 4-11 of the 23.5M
    int8 weights land one step apart (bundle seeds 0-2;
    test_quantize_matches_jax), and the random-weight tower amplifies one
    step to ~1e-2 in probability (PERF.md, Open questions)."""
    jax_engine, own, shared = engines
    assert not own.text_int8 and not shared.text_int8
    rng = np.random.default_rng({"gray": 5, "rgb": 6, "gray-resized": 7}[channels])
    rs = own.bundle.config.image.resize_size
    side = rs + 44 if channels == "gray-resized" else rs
    shape = (side, side, 3) if channels == "rgb" else (side, side)
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in TEXTS]
    ref = _jax_turbo_probs_eager_tower(jax_engine, imgs)
    ref_jit = np.asarray(jax_engine.classify_batch(imgs, TEXTS)[0])
    assert own.prep_images(imgs).shape[-1] == (3 if channels == "rgb" else 1)
    got_shared, _, _ = shared.classify_batch(imgs, TEXTS)
    got_own, _, _ = own.classify_batch(imgs, TEXTS)
    for got in (got_shared, got_own):
        assert got.shape == (3, 13) and np.isfinite(got).all()
        assert np.abs(got - ref_jit).max() < 0.05
    # shrunk images: the two resizes' f32 sums round differently and flip
    # bf16 inputs of the int8 tower, so the shared weights get 0.05 there too
    shared_bound = 0.05 if channels == "gray-resized" else 1e-2
    assert np.abs(got_shared - ref).max() < shared_bound
    assert np.abs(got_own - ref).max() < 0.05
    assert own.calibration_ms is not None  # qparams built once, from the scales


def _spread_bn(variables, seed: int):
    """A copy of ``variables`` whose image BatchNorms carry the spread of a
    trained tower's statistics (a random bundle's lie near (0, 1)): running
    var log-uniform in [1e-3, 10], mean N(0, 0.5), and scale sqrt(var) times
    N(1, 0.3), so that each folded gain scale / sqrt(var + eps) stays near
    N(1, 0.3), as training keeps it, and 16 blocks of random weights do not
    overflow."""
    rng = np.random.default_rng(seed)
    out = copy.deepcopy(variables)
    bp = out["params"]["image_encoder"]["backbone"]
    bs = out["batch_stats"]["image_encoder"]["backbone"]
    for p, s in [(bp, bs)] + [(bp[n], bs[n]) for n in bs if n.startswith("layer")]:
        for bn in (k for k in s if "bn" in k):
            c = s[bn]["var"].shape[0]
            var = np.exp(rng.uniform(np.log(1e-3), np.log(10.0), c)).astype(np.float32)
            s[bn]["var"] = var
            s[bn]["mean"] = (0.5 * rng.standard_normal(c)).astype(np.float32)
            p[bn]["scale"] = (np.sqrt(var) * (1.0 + 0.3 * rng.standard_normal(c))).astype(
                np.float32)
    return out


def test_bn_fold_channel_scales_match_jax(tower):
    """The folded f32 channel scales themselves, on the spread statistics of
    every image BatchNorm (26,560 channels): the port's ``_fold_conv``
    against the JAX package's ``fold_bn`` under ``jax.jit``, each folding a
    kernel of ones, so its weight is the scale. XLA's CPU ``rsqrt`` is an
    estimate, so JAX's order of operations still leaves ~12% of the scales
    an ulp apart; the former divide, ``scale / sqrt(var + eps)``, left ~40%
    (PERF.md, Open questions). The bound lies between the two."""
    from mmdx_tpu.ops.pallas_bottleneck import fold_bn

    variables = _spread_bn(tower["variables"], seed=17)
    bp = variables["params"]["image_encoder"]["backbone"]
    bs = variables["batch_stats"]["image_encoder"]["backbone"]
    pairs = [(p[bn], s[bn]) for p, s in [(bp, bs)] + [(bp[n], bs[n]) for n in bs
                                                      if n.startswith("layer")]
             for bn in s if "bn" in bn]

    def cat(i, key):  # one BN vector of every layer, end to end
        return np.concatenate([np.asarray(pair[i][key], np.float32) for pair in pairs])

    scale, bias, mean, var = cat(0, "scale"), cat(0, "bias"), cat(1, "mean"), cat(1, "var")
    eps = bridge.small_config().image.bn_eps
    c = scale.size
    ref = np.asarray(jax.jit(lambda *a: fold_bn(*a, eps)[0])(
        np.ones(c, np.float32), scale, bias, mean, var))
    got = bridge._fold_conv(np.ones((1, 1, 1, c), np.float32), {"scale": scale, "bias": bias},
                            {"mean": mean, "var": var}, eps)[0].reshape(-1)
    off = int(np.count_nonzero(got != ref))
    print(f"spread BN statistics: {off} of {c} folded channel scales differ from JAX's")
    assert off < 0.2 * c, (off, c)


def test_bn_fold_on_spread_statistics_matches_jax(tower):
    """The BN fold on a bundle with spread statistics, where the fold's
    rounding shows (``var`` far from 1): the port's int8 weights against
    ``quantize_backbone`` of the JAX package under ``jax.jit`` on the same
    activation scales, and the turbo probabilities against the jitted JAX
    turbo engine. The fold computes ``scale * rsqrt(var + eps)`` as JAX's
    ``fold_bn`` does, with the reciprocal square root rounded to f32 once;
    XLA's CPU ``rsqrt`` is an estimate, so a few weights still land one step
    apart (PERF.md, Open questions). Bounds: those of test_quantize_matches_jax
    and the JAX package's turbo guard, 0.05 (tests/test_resnet_int8.py:297)."""
    from mmdx_tpu.models import resnet_int8 as jri

    variables = _spread_bn(tower["variables"], seed=17)
    scales = jri.calibrate_backbone(variables, tower["x3"])
    q_jax = jax.tree.map(np.asarray, jax.jit(
        lambda v: jri.quantize_backbone(v, scales, img_size=64))(variables))
    folded = ri.folded_backbone(bridge.bundle_from_variables(
        variables, bridge.small_config()).model.image_encoder.backbone)
    q = ri.quantize_backbone(folded, scales, img_size=64)
    off, total = _weights_one_step_apart(q, q_jax)
    print(f"spread BN statistics: {off} of {total} int8 weights one step apart")
    assert off < 1e-3 * total, (off, total)

    jax_engine, port = _turbo_engines(variables, scales)
    rng = np.random.default_rng(8)
    rs = port.bundle.config.image.resize_size
    imgs = [rng.integers(0, 256, (rs, rs), dtype=np.uint8) for _ in TEXTS]
    ref = np.asarray(jax_engine.classify_batch(imgs, TEXTS)[0])
    got, _, _ = port.classify_batch(imgs, TEXTS)
    gap = float(np.abs(got - ref).max())
    print(f"spread BN statistics: max |prob port - JAX| turbo {gap:.4f}")
    assert got.shape == (3, 13) and np.isfinite(got).all()
    assert gap < 0.05, gap


def test_turbo_engine_calibrates_without_scales():
    """No persisted scales: the first batch calibrates (every site), W8A8
    text blocks on; a missing site recalibrates too."""
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    cfg = bridge.small_config()
    variables = bridge.random_state(cfg, 1)
    imgs = [np.random.default_rng(7).integers(0, 256, (70, 70, 3), dtype=np.uint8)]
    for meta in (None, {"int8_scales": {"input": 1.0}}):
        tb = bridge.bundle_from_variables(variables, cfg, metadata=meta)
        engine = InferenceEngine(tb, mode="turbo", device="cpu")
        assert engine.text_int8 and engine.kernels
        probs, _, _ = engine.classify_batch(imgs, TEXTS[:1])
        assert probs.shape == (1, 13) and np.isfinite(probs).all()
        assert set(engine._qparams["scales"]) == set(ri.calibration_sites())


# ---------------------------------------------------------------------------
# the port's copies of the JAX package's framework-free modules
# ---------------------------------------------------------------------------
def test_tokenizer_copies_match():
    from mmdx_tpu.text.t5_tokenizer import T5StyleTokenizer as JaxT5
    from mmdx_tpu.text.wordpiece import WordPieceTokenizer as JaxWP
    from mmdx_tpu_torch.text.t5_tokenizer import T5StyleTokenizer
    from mmdx_tpu_torch.text.wordpiece import WordPieceTokenizer

    bert, t5, scores = bridge.default_vocabs()
    texts = TEXTS + ["Bilateral pleural effusions; cardiomegaly (CTR 0.6).", "",
                     "naïve façade — 2L O2 @ rest, SpO2 91%", "x" * 300]
    ref = JaxWP(vocab=bert).encode_batch(texts, max_len=32)
    got = WordPieceTokenizer(vocab=bert).encode_batch(texts, max_len=32)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    jt, pt = JaxT5(vocab=t5, scores=scores), T5StyleTokenizer(vocab=t5, scores=scores)
    for text in texts:
        assert pt.encode(text) == jt.encode(text)
    ids = [jt.encode(t) for t in texts]
    assert pt.batch_decode(ids) == jt.batch_decode(ids)


def test_resize_copy_matches():
    from mmdx_tpu.ops import resize as jax_resize
    from mmdx_tpu_torch.ops import resize

    for h, w, rs, crop in ((512, 512, 256, 224), (96, 80, 56, 48), (600, 480, 256, 224)):
        for a, b in zip(resize.fused_resize_crop_matrices(h, w, rs, crop),
                        jax_resize.fused_resize_crop_matrices(h, w, rs, crop)):
            np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(2).integers(0, 256, (97, 61, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resize.resize_u8_exact(img, 40, 30),
                                  jax_resize.resize_u8_exact(img, 40, 30))


def test_config_copy_matches():
    import mmdx_tpu.config as jax_config
    import mmdx_tpu_torch.config as config

    for name in ("ImageEncoderConfig", "TextEncoderConfig", "ReportDecoderConfig",
                 "FusionConfig", "GenerationConfig", "DiagnosisConfig"):
        a, b = getattr(config, name)(), getattr(jax_config, name)()
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], name
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    assert config.DISEASES == jax_config.DISEASES
    assert (config.IMAGENET_MEAN, config.IMAGENET_STD) == \
        (jax_config.IMAGENET_MEAN, jax_config.IMAGENET_STD)
    small = bridge.small_config()
    assert dataclasses.asdict(jax_config.DiagnosisConfig.from_json(small.to_json())) == \
        dataclasses.asdict(small)
