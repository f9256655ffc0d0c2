"""The int8 GEMM under K5, K6 and K7 (``csrc/int8_gemm.cu``), on the CPU:
its tile plan, its walk over the plan, the K-major weight layout it reads,
and its dequantizing epilogues against the Pallas bodies' arithmetic (the
kernel itself runs only on the card, in chip_smoke.py).

* ``int8_gemm_plan`` at every product of the int8 ResNet-50 tower at 224
  (B = 1, 4, 32, 512) and of the W8A8 BERT-base blocks (M = 32 to 16384):
  the tiles divide N, the ring fits its shared-memory budget, the grid fits
  grid.x, and the grid leaves fewer than half of the 132 SMs idle wherever
  M x N has that many 64 x 64 tiles;
* ``tile_walk_s32`` (the kernel's boxes, TMA's zero fill past M and K, the
  k32 steps it skips) against ``exact_matmul_s8``, bit for bit, at ragged M
  and K (the gray stem's 49 -> 64, the RGB stem's 147 -> 160, 3x3's 576);
* the K-major layout: ``gemm_weight``, ``qparams_from_jax`` and
  ``TextEncoder.quantize_int8_`` give contiguous [N, K] s8 weights, once,
  and a conv hands the GEMM that tensor itself;
* ``gemm_dequant_plain``'s four epilogues against the same f32 chain in JAX
  (``pallas_ffn._ffn_kernel_int8``, ``pallas_bert_attn._kernel_int8``);
* the kernel's requant without a true division (``requant_fast``: a
  multiply by the reciprocal, the division only within 2^-12 of a tie),
  emulated in numpy f32, against ``rint(y / s)`` on random values and on
  values a few ulps from every tie.

Inputs are made from seeds with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.models import resnet_int8 as ri
from mmdx_tpu_torch.models.resnet import RESNET50_STAGES
from mmdx_tpu_torch.ops import fused_ffn, int8_gemm

SMS = int8_gemm.H100_SMS


def tower_gemms(batch: int, img: int = 224) -> list[tuple[int, int, int]]:
    """(M, K, N) of every K5 launch of the int8 tower (K padded as the
    tower pads it), in execution order."""
    pad = int8_gemm.K_ALIGN
    side = img // 2
    out = [(batch * side * side, -(-49 // pad) * pad, 64),    # gray stem
           (batch * side * side, -(-147 // pad) * pad, 64)]   # RGB stem
    hw, cin = img // 4, 64
    for stage, blocks in enumerate(RESNET50_STAGES):
        width = 64 * 2 ** stage
        for block in range(blocks):
            hw_in = hw
            if stage > 0 and block == 0:
                hw //= 2
            m_in, m = batch * hw_in * hw_in, batch * hw * hw
            out += [(m_in, cin, width), (m, 9 * width, width), (m, width, 4 * width)]
            if block == 0:
                out.append((m, cin, 4 * width))
            cin = 4 * width
    return out


TEXT = {"attn_qkv": (2304, 768), "attn_out": (768, 768), "ffn_in": (3072, 768),
        "ffn_out": (768, 3072)}  # N, K of BERT-base's four projections


def _check_plan(m, n, k, k2=0):
    bm, bn, stages = int8_gemm.int8_gemm_plan(m, n, k, SMS, k2)
    assert bm in (64, 128) and bn in (64, 128) and n % bn == 0
    assert not k2 or bn == 64  # the dual epilogue's two s32 tiles
    steps = -(-k // int8_gemm.BK) + -(-k2 // int8_gemm.BK)
    assert 2 <= stages <= max(2, steps)
    # the ring fits its budget (two blocks to an SM), the block its limit
    assert stages * (bm + bn) * int8_gemm.BK <= int8_gemm.STAGE_BUDGET
    assert int8_gemm.smem_bytes(bm, bn, stages, 2 if k2 else 1) <= int8_gemm.MAX_SMEM
    row_tiles = int8_gemm.cdiv(m, bm)
    assert (row_tiles - 1) * bm < m <= row_tiles * bm and row_tiles < 2 ** 31
    if int8_gemm.cdiv(m, 64) * (n // 64) >= SMS // 2:
        assert row_tiles * (n // bn) >= SMS // 2, (m, n, k, bm, bn)
    return bm, bn, stages


@pytest.mark.parametrize("batch", [1, 4, 32, 512])
def test_int8_gemm_plan_tower(batch):
    shapes = tower_gemms(batch)
    assert len(shapes) == 2 + 52  # both stems, the 52 convs after them
    for m, k, n in shapes:
        _check_plan(m, n, k)
    # the dual epilogue's one site: layer4 conv3 + shortcut
    _check_plan(49 * batch, 2048, 512, 1024)
    if batch >= 32:  # the tall products run 128-row tiles
        m, k, n = shapes[0]
        assert int8_gemm.int8_gemm_plan(m, n, k)[0] == 128


@pytest.mark.parametrize("product", sorted(TEXT))
@pytest.mark.parametrize("m", [32, 144, 384, 3072, 16384])
def test_int8_gemm_plan_text(m, product):
    n, k = TEXT[product]
    bm, bn, _ = _check_plan(m, n, k)
    if m >= 3072:
        assert bm == 128


def test_int8_gemm_plan_rejects_unsupported_shapes():
    for m, n, k in ((3072, 100, 768), (3072, 768, 49), (0, 768, 768)):
        with pytest.raises(ValueError):
            int8_gemm.int8_gemm_plan(m, n, k)
    with pytest.raises(ValueError):
        int8_gemm.int8_gemm_plan(1568, 2048, 512, k2=40)


@pytest.mark.parametrize("m, k, n, plan", [
    (49 * 3, 64, 64, None),          # gray stem's K 49 -> 64, stage 4's ragged M
    (49 * 3, 160, 128, None),        # RGB stem's 147 -> 160: the last k32 half zeros
    (49 * 3, 576, 64, None),         # 3x3 im2col: 4.5 boxes of 128
    (200, 576, 128, (128, 128, 3)),  # a tile with 72 rows past M
    (130, 272, 128, (64, 64, 2)),    # one row in the last tile
])
def test_tile_walk_matches_exact_product(m, k, n, plan):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    plan = plan or int8_gemm.int8_gemm_plan(m, n, k)
    got = int8_gemm.tile_walk_s32(x, w, plan)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.to(torch.float32), int8_gemm.exact_matmul_s8(x, w.T))
    # the emulation reads only the real K: a stray value past it would show
    wide = torch.cat([x, torch.full((m, 16), 99, dtype=torch.int8)], 1)[:, :k]
    assert torch.equal(int8_gemm.tile_walk_s32(wide.contiguous(), w, plan), got)


# ---------------------------------------------------------------------------
# the K-major layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7, 7, 1, 64), (7, 7, 3, 64), (3, 3, 64, 64),
                                   (1, 1, 256, 128)])
def test_gemm_weight_is_k_major(shape):
    rng = np.random.default_rng(sum(shape))
    w = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    kh, kw, ci, co = shape
    k = kh * kw * ci
    wk = ri.gemm_weight(w)
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert wk.shape == (co, -(-k // int8_gemm.K_ALIGN) * int8_gemm.K_ALIGN)
    assert torch.equal(wk[:, :k], w.reshape(k, co).T) and not wk[:, k:].any()
    view = ri.hwio_view(wk, w.shape)
    assert torch.equal(view, w) and view.data_ptr() == wk.data_ptr()


def test_qparams_keep_one_k_major_copy():
    """The quantized tower and the JAX tree's bridge both hold each conv's
    weights once: "wk" [co, K] contiguous, "w" its HWIO view with the
    quantized (or the JAX tree's) values."""
    rng = np.random.default_rng(5)
    conv = {"w": rng.integers(-127, 128, (3, 3, 16, 64)).astype(np.int8),
            "ws": rng.uniform(1e-3, 1e-2, 64).astype(np.float32),
            "b": rng.standard_normal(64).astype(np.float32)}
    q = bridge.qparams_from_jax({"stem": dict(conv), "layer1_block0": {"conv2": conv},
                                 "scales": {"input": np.float32(0.5)}})
    for c in (q["stem"], q["layer1_block0"]["conv2"]):
        assert c["wk"].shape == (64, 144) and c["wk"].is_contiguous()
        assert c["w"].data_ptr() == c["wk"].data_ptr()
        np.testing.assert_array_equal(c["w"].numpy(), conv["w"])
    w_hwio = torch.from_numpy(rng.standard_normal((1, 1, 32, 64)).astype(np.float32))
    qc = ri._qconv(w_hwio, torch.zeros(64))
    assert qc["wk"].shape == (64, 32) and qc["wk"].is_contiguous()
    assert qc["w"].shape == (1, 1, 32, 64) and qc["w"].data_ptr() == qc["wk"].data_ptr()


def test_conv_hands_the_gemm_its_k_major_weight(monkeypatch):
    """``_conv_s8`` passes the qparams' "wk" itself to K5: no per-call
    copy or transpose of a weight."""
    rng = np.random.default_rng(6)
    seen = []

    def spy(cols, w, *args, **kwargs):
        seen.append(w)
        return int8_gemm.int8_gemm_requant(cols, w, *args, **kwargs)

    monkeypatch.setattr(ri, "int8_gemm_requant", spy)
    for shape in ((1, 1, 32, 64), (3, 3, 16, 64)):
        qc = ri._qconv(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                       torch.zeros(64))
        x = torch.from_numpy(rng.integers(-127, 128, (2, 6, 6, shape[2])).astype(np.int8))
        out, _, _ = ri._conv_s8(x, qc, 0.01, 0.05, 1)
        assert seen[-1] is qc["wk"] and out.shape == (72, 64)


def test_text_weights_are_k_major():
    from mmdx_tpu_torch.models.bert import TextEncoder

    cfg = bridge.small_config().text
    enc = TextEncoder(cfg).eval()
    with torch.inference_mode():
        enc.quantize_int8_()
    layer = enc.bert.layers[0]
    for name, (q, s) in layer.int8.items():
        kernel = getattr(layer, name).kernel  # flax [in, out]
        assert q.dtype == torch.int8 and q.is_contiguous()
        assert q.shape == (kernel.shape[1], kernel.shape[0]) and s.shape == (kernel.shape[1],)


def test_quant_weight_cols_matches_jax_transposed():
    from mmdx_tpu.ops import pallas_ffn as pf

    w = np.random.default_rng(7).standard_normal((96, 192)).astype(np.float32) * 0.1
    q, s = fused_ffn.quant_weight_cols(torch.from_numpy(w))
    jq, js = pf.quant_weight_cols(jnp.asarray(w))
    assert q.shape == (192, 96) and q.is_contiguous()
    np.testing.assert_array_equal(q.T.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1))


# ---------------------------------------------------------------------------
# gemm_dequant's epilogues
# ---------------------------------------------------------------------------
EPILOGUES = {"bf16": _build.DQ_BF16, "gelu_tanh": _build.DQ_GELU_TANH_F32,
             "bias_resid": _build.DQ_BIAS_RESID_F32, "resid_bias": _build.DQ_RESID_BIAS_F32}


@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_dequant_epilogues_match_the_pallas_chain(epi):
    """``gemm_dequant_plain`` (the card's yardstick for each epilogue)
    against the f32 chain of the Pallas int8 bodies in JAX, on the same
    s8 operands: ``acc * (sx * ws) + b``, tanh-GELU, ``+ x`` (K6's order)
    or ``x + ... + b`` (K7's), and the bf16 cast of K7's qkv."""
    from mmdx_tpu.ops import pallas_ffn as pf

    rng = np.random.default_rng(8)
    m, n, k = 48, 128, 96
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)  # K-major
    rs = rng.uniform(1e-3, 1e-2, m).astype(np.float32)
    cs = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    resid = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(torch.bfloat16)
    code = EPILOGUES[epi]
    out_dtype = torch.bfloat16 if code == _build.DQ_BF16 else torch.float32
    got = int8_gemm.gemm_dequant_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(rs), torch.from_numpy(cs),
        bias, resid, out_dtype, code)

    acc = jnp.dot(jnp.asarray(x, jnp.int32), jnp.asarray(w.T, jnp.int32)).astype(jnp.float32)
    u = acc * (jnp.asarray(rs)[:, None] * jnp.asarray(cs)[None, :])
    b = jnp.asarray(bias.float().numpy())
    r = jnp.asarray(resid.float().numpy())
    ref = {"bf16": lambda: (u + b).astype(jnp.bfloat16).astype(jnp.float32),
           "gelu_tanh": lambda: pf._gelu_tanh(u + b),
           "bias_resid": lambda: (u + b) + r,
           "resid_bias": lambda: (r + u) + b}[epi]()
    assert got.dtype == out_dtype and got.shape == (m, n)
    if epi == "gelu_tanh":  # tanh is each library's own: an ulp or two
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the requant's division
# ---------------------------------------------------------------------------
def _requant_fast(y, s):
    """``csrc/int8_gemm.cu:requant_fast`` in numpy f32 (IEEE round to
    nearest, as the card's __fmul_rn, __frcp_rn and __fdiv_rn)."""
    f32 = np.float32
    inv = f32(1) / f32(s)
    t = (y * inv).astype(f32)
    q = np.rint(t)
    with np.errstate(invalid="ignore", over="ignore"):  # inf - inf: NaN, never near
        near = np.abs(t - q) > f32(0.5) - f32(2.0 ** -12)
        q = np.where(near, np.rint((y / f32(s)).astype(f32)), q)
    return np.clip(q, -127, 127).astype(np.int8)


@pytest.mark.parametrize("s", [0.37, 0.011, 2.0 ** -7, 3.1e-3, 1e-12 / 127, 5.7])
def test_requant_fast_division_is_exact(s):
    rng = np.random.default_rng(9)
    s = np.float32(s)
    y = (rng.uniform(-300, 300, 1_000_000) * s).astype(np.float32)
    # values a few ulps from every half-integer quotient in and past the range
    ties = ((np.arange(-260, 260) + np.float32(0.5)) * s).astype(np.float32)
    near, up, down = [ties], ties, ties
    for _ in range(4):
        up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
        near += [up, down]
    y = np.concatenate([y, *near, np.float32([0.0, -0.0, 3e38, -3e38, 1e-40])])
    with np.errstate(over="ignore"):
        ref = np.clip(np.rint((y / s).astype(np.float32)), -127, 127).astype(np.int8)
        got = _requant_fast(y, s)
    np.testing.assert_array_equal(got, ref)
