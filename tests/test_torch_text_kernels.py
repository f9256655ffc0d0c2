"""The arithmetic and the tiling of the text tower's redesigned kernels, on the
CPU (the kernels themselves run only on the card, in chip_smoke.py):

* the split-K LayerNorm of ``csrc/gemm.cu`` (``ops/gemm.split_k_residual_ln``:
  f32 partials of the product over whole 64-deep K steps, summed in split
  order, then bias, then residual, then LayerNorm) at 1, 2, 3 and 4 splits,
  inside the FFN block (K2) and the attention block (K1), against the Pallas
  ``fused_ffn_ln`` and ``fused_attention_block`` run in interpret mode: f32
  to 2e-5 (the Pallas tests' own bar, tests/test_pallas_attention.py:102)
  and bf16 to 4e-2 (the bf16 bars of tests/test_pallas_beam_attn.py:45 and
  tests/test_pallas_t5_step.py:47, a few bf16 ulps of LayerNorm outputs);
* ``ops/gemm.gemm_plan`` at every main-path product shape: the tiles cover
  M, N and K exactly, obey wgmma's limits, fit shared memory, and the grid
  fills the SMs wherever the shape allows;
* ``ops/bert_attn.query_tile``: the attention core's grid covers every
  query row once.

The K widths of the split-K cases are 768 (12 steps of 64: 1 to 4 splits
all whole), with the JAX tests' small widths elsewhere (h = 64 for the FFN's
input, 64-wide heads for attention).
"""
import faulthandler
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.ops import bert_attn, gemm

TOL = {"f32": 2e-5, "bf16": 4e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32 = torch.float32


@pytest.fixture
def time_guard():
    """An alarm raises in a test still running Python code at 120 s; a
    watchdog ends the process at 180 s if its main thread is blocked in
    native code, where the alarm cannot run."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ffn_inputs():
    rng = np.random.default_rng(11)
    h, f = 64, 768
    return (_np(rng, 40, h), _np(rng, h, f, scale=0.1), _np(rng, f, scale=0.1),
            _np(rng, f, h, scale=0.05), _np(rng, h, scale=0.1),
            1.0 + _np(rng, h, scale=0.1), _np(rng, h, scale=0.1))


def _attn_inputs():
    rng = np.random.default_rng(12)
    b, seq, heads = 3, 16, 12
    h = heads * 64
    kmask = np.zeros(b * seq, np.float32)
    kmask.reshape(b, seq)[1, seq // 2:] = -1e9  # one padded sequence
    return (_np(rng, b * seq, h), kmask, _np(rng, h, 3 * h, scale=0.05),
            _np(rng, 3 * h, scale=0.02), _np(rng, h, h, scale=0.05), _np(rng, h, scale=0.02),
            1.0 + _np(rng, h, scale=0.1), _np(rng, h, scale=0.1)), seq, heads


def _cast(arrays, dtype, keep_f32=()):
    """numpy f32 inputs -> (jax, torch) lists in ``dtype`` (indices in
    ``keep_f32`` stay f32: the key mask)."""
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(a) if i in keep_f32 else jnp.asarray(a).astype(jdt)
          for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a) if i in keep_f32 else torch.from_numpy(a).to(tdt)
          for i, a in enumerate(arrays)]
    return jx, tx


@pytest.fixture(scope="module")
def pallas_blocks():
    """The Pallas FFN and attention blocks in interpret mode, jitted, once
    per dtype: {("ffn" | "attn", dtype): numpy output}."""
    from mmdx_tpu.ops.pallas_bert_attn import fused_attention_block
    from mmdx_tpu.ops.pallas_ffn import fused_ffn_ln

    out = {}
    attn_args, seq, heads = _attn_inputs()
    for dtype in DTYPES:
        jx, _ = _cast(_ffn_inputs(), dtype)
        ja, _ = _cast(attn_args, dtype, keep_f32=(1,))
        with pltpu.force_tpu_interpret_mode():
            ffn = jax.jit(lambda *a: fused_ffn_ln(*a, block_rows=32))(*jx)
            attn = jax.jit(lambda *a: fused_attention_block(*a, seq_len=seq, num_heads=heads))(*ja)
        out["ffn", dtype] = np.asarray(jax.block_until_ready(ffn), np.float32)
        out["attn", dtype] = np.asarray(jax.block_until_ready(attn), np.float32)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_k_ffn_matches_pallas(pallas_blocks, time_guard, splits, dtype):
    """K2's arithmetic with ffn_out split over K: mid = dtype(gelu_erf(x Wi
    + bi)), then the split-K sum, bias, residual and LayerNorm."""
    _, (x, wi, bi, wo, bo, lns, lnb) = _cast(_ffn_inputs(), dtype)
    mid = F.gelu(x.to(F32) @ wi.to(F32) + bi.to(F32)).to(x.dtype)
    got = gemm.split_k_residual_ln(mid, wo, bo, x, lns, lnb, 1e-12, splits)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(got.float().numpy(), pallas_blocks["ffn", dtype],
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_k_attention_matches_pallas(pallas_blocks, time_guard, splits, dtype):
    """K1's arithmetic with attn_out split over K: qkv and the context
    rounded to dtype as in the Pallas body, then the split-K sum, bias,
    residual and LayerNorm."""
    args, seq, heads = _attn_inputs()
    _, (x, kmask, wqkv, bqkv, wo, bo, lns, lnb) = _cast(args, dtype, keep_f32=(1,))
    qkv = (x.to(F32) @ wqkv.to(F32) + bqkv.to(F32)).to(x.dtype)
    ctx = bert_attn.attention_ctx_f32(qkv, kmask, seq, heads).to(x.dtype)
    got = gemm.split_k_residual_ln(ctx, wo, bo, x, lns, lnb, 1e-12, splits)
    np.testing.assert_allclose(got.float().numpy(), pallas_blocks["attn", dtype],
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_split_k_rejects_a_split_off_the_step():
    a, w = torch.zeros(4, 128), torch.zeros(128, 64)
    v = torch.zeros(64)
    with pytest.raises(ValueError):
        gemm.split_k_residual_ln(a, w, v, torch.zeros(4, 64), v, v, 1e-12, 3)


# the products of the main path: (N, K, split) per BERT-base layer
PRODUCTS = {"attn_qkv": (2304, 768, False), "attn_out": (768, 768, True),
            "ffn_in": (3072, 768, False), "ffn_out": (768, 3072, True)}
# the same at the test widths (h = 64, f = 128)
SMALL_PRODUCTS = {"attn_qkv": (192, 64, False), "attn_out": (64, 64, True),
                  "ffn_in": (128, 64, False), "ffn_out": (64, 128, True)}
SMEM = 232448  # a block's shared memory on sm_90


def _check_plan(m, n, k, split, sms=gemm.H100_SMS):
    bm, bn, stages, splits = gemm.gemm_plan(m, n, k, sms, split=split)
    # wgmma: 64-row warpgroup tiles, N a multiple of 8 up to 256
    assert bm in (64, 128) and bn % 8 == 0 and 8 <= bn <= 256
    # the tiles cover M, N and K exactly
    row_tiles = gemm.cdiv(m, bm)
    assert (row_tiles - 1) * bm < m <= row_tiles * bm
    assert n % bn == 0 and k % (gemm.BK * splits) == 0
    assert splits == 1 or split
    # the ring: at least two stages, no more than the K steps (but two), in
    # shared memory; two blocks to an SM
    steps = k // gemm.BK // splits
    assert 2 <= stages <= max(2, steps)
    # (the epilogue stages the f32 tile, rows padded by 16 bytes, over it)
    ring = max(stages * (bm + bn) * gemm.BK * 2, bm * (bn * 4 + 16)) + 1024
    assert 2 * ring <= SMEM
    # one wave wherever the shape allows: else the smallest tiles and, for
    # a split product, as many splits as the cap and the K steps allow
    blocks = row_tiles * (n // bn) * splits
    if blocks < sms:
        assert (bm, bn) == (64, 64)
        if split:
            assert splits == max(s for s in range(1, gemm.MAX_SPLITS + 1)
                                 if (k // gemm.BK) % s == 0)
    return bm, bn, stages, splits


@pytest.mark.parametrize("product", sorted(PRODUCTS))
@pytest.mark.parametrize("m", [32, 96, 144, 384, 1024, 3072, 16384])
def test_gemm_plan_main_path(m, product):
    n, k, split = PRODUCTS[product]
    bm, bn, _, splits = _check_plan(m, n, k, split)
    if m >= 3072:  # the classify and long-text rows: 128-row tiles, no split
        assert bm == 128 and splits == 1


@pytest.mark.parametrize("product", sorted(SMALL_PRODUCTS))
@pytest.mark.parametrize("m", [16, 40, 48])
def test_gemm_plan_test_widths(m, product):
    _check_plan(m, *SMALL_PRODUCTS[product])


def test_gemm_plan_splits_only_where_the_tiles_leave_sms_idle():
    # B=4 L=96: 36 tiles of attn_out split to fill the SMs; B=32: none
    assert gemm.gemm_plan(384, 768, 768, split=True)[3] > 1
    assert gemm.gemm_plan(3072, 768, 3072, split=True)[3] == 1
    assert gemm.gemm_plan(384, 768, 768, split=False)[3] == 1
    with pytest.raises(ValueError):
        gemm.gemm_plan(384, 100, 768)


@pytest.mark.parametrize("batch", [1, 4, 32])
@pytest.mark.parametrize("seq_len", [8, 32, 48, 96, 128])
def test_query_tiles_cover_every_row_once(seq_len, batch):
    heads = 12
    qt = bert_attn.query_tile(batch, seq_len, heads)
    assert qt % 16 == 0 and 16 <= qt <= 64  # one warp per 16 rows, <= 4 warps
    tiles = gemm.cdiv(seq_len, qt)
    rows = [t * qt + r for t in range(tiles) for r in range(qt) if t * qt + r < seq_len]
    assert sorted(rows) == list(range(seq_len))
    # no block whose rows all lie past L; the taller tile only where the
    # grid still fills the SMs
    assert (tiles - 1) * qt < seq_len
    if qt > 16:
        assert heads * batch * tiles >= gemm.H100_SMS
    # shared memory: Q tile, K and V padded to 16 keys (144-byte rows), mask
    lp = gemm.cdiv(seq_len, 16) * 16
    assert (qt + 2 * lp) * 144 + 4 * lp <= 48 * 1024
