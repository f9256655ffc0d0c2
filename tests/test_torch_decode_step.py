"""The arithmetic of the beam step's two redesigned kernels against the JAX
package, on the CPU at small sizes (the kernels themselves run only on the
card, where chip_smoke.py holds them to their plain versions):

* K4 (``csrc/t5_cross_ffn.cu``): each product as the kernel computes it,
  f32 partials of uneven K-splits (``t5_step.split_bounds``) added in split
  order before the bf16 rounding point, at 1, 3 and 16 splits, against
  ``pallas_t5_step.cross_ffn_block`` in interpret mode at its bars (2e-5 in
  f32, 4e-2 in bf16: tests/test_pallas_t5_step.py:46), and against the
  package's XLA half step (``T5Attention.cross_step`` between its RMSNorms
  and FFN) with a row whose every key is masked. The Pallas kernel packs
  the rows into one block-diagonal score matrix whose off-block entries are
  -1e9, as large as a masked key's, so a fully masked row there attends to
  the other rows' keys; the XLA step and the port attend over the row's own
  keys, so that row is held to the XLA step alone;
* K3 (``csrc/beam_attn.cu`` ``beam_partial_kernel``): the cluster's split
  of the keys over 1, 2, 3 and 8 ranks, the global max, the rank-ordered
  sums and bf16(exp(s - m)) . v, against
  ``pallas_beam_attn.beam_decode_attention_partial`` in interpret mode at
  the bar of tests/test_torch_kernels.py's partial test (1e-5 in f32; 3e-2
  in bf16, tests/test_pallas_beam_attn.py:45), for the sums acc and l
  relative to the output's largest value, and against the port's plain
  partials on the same scores to 1e-5 (the bf16 rounding point of
  exp(s - m) with the global max), the first sample masked;
* the wrappers' choices: ``beam_attn.cluster_ranks`` and
  ``t5_step.split_counts``.

Inputs are made from seeds with numpy and handed to both sides.
"""
import faulthandler
import functools
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.ops import beam_attn, t5_step

F32 = torch.float32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


# ---------------------------------------------------------------------------
# K4: deterministic split-K
# ---------------------------------------------------------------------------
N, DM, DFF, HEADS, KC = 20, 128, 256, 2, 4  # 64-wide heads; 20 rows: a ragged row tile
K4_TOL = {"f32": 2e-5, "bf16": 4e-2}


def _k4_inputs():
    rng = np.random.default_rng(7)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    enc_bias = np.zeros((N, KC), np.float32)
    enc_bias[::3, -1] = -1e9
    enc_bias[1] = -1e9  # a row whose every key is masked
    return (r(N, DM), 1.0 + r(DM, scale=0.1), r(DM, DM, scale=DM ** -0.5),
            r(DM, DM, scale=DM ** -0.5), r(N, KC, DM), r(N, KC, DM), enc_bias,
            1.0 + r(DM, scale=0.1), r(DM, DFF, scale=DM ** -0.5), r(DFF, DM, scale=DFF ** -0.5))


@functools.lru_cache(maxsize=None)
def _k4_pallas(dtype: str) -> np.ndarray:
    from mmdx_tpu.ops.pallas_t5_step import cross_ffn_block

    jdt = DTYPES[dtype][0]
    args = [jnp.asarray(a) for a in _k4_inputs()]
    for i in (0, 2, 3, 4, 5, 8, 9):  # hidden, the weights, ck, cv in the working type
        args[i] = args[i].astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(functools.partial(cross_ffn_block, heads=HEADS))(*args)
    return np.asarray(out.astype(jnp.float32))


def _k4_split(hidden, cross_ln, wq, wo_c, ck, cv, enc_bias, ffn_ln, wi, wo_f,
              splits: int, eps: float = 1e-6):
    """K4's arithmetic: each product's f32 partials over its K-splits
    (at most one split per 16 rows of K, as the kernel takes them) added in
    split order, rounded at the plain version's points; the attention as in
    the plain version (per (row, head) over the row's own keys)."""
    dt = hidden.dtype
    n, dm = hidden.shape
    d = dm // HEADS

    def dot(a, w):
        bounds = t5_step.split_bounds(a.shape[1], min(splits, a.shape[1] // 16))
        acc = torch.zeros(a.shape[0], w.shape[1])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            acc = acc + a[:, lo:hi].to(F32) @ w[lo:hi].to(F32)
        return acc.to(dt)

    y = t5_step.rms_norm(hidden, cross_ln, eps)
    q = dot(y, wq).reshape(n, HEADS, d).to(F32)
    s = torch.einsum("nhd,nkhd->nhk", q, ck.reshape(n, KC, HEADS, d).to(F32))
    e = torch.exp(s + enc_bias[:, None, :] - (s + enc_bias[:, None, :]).amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    ctx = torch.einsum("nhk,nkhd->nhd", p.to(F32), cv.reshape(n, KC, HEADS, d).to(F32)).to(dt)
    x = (hidden.to(F32) + dot(ctx.reshape(n, dm), wo_c).to(F32)).to(dt)
    hmid = dot(t5_step.rms_norm(x, ffn_ln, eps), wi).clamp_min(0)
    return (x.to(F32) + dot(hmid, wo_f).to(F32)).to(dt)


@functools.lru_cache(maxsize=None)
def _k4_xla(dtype: str) -> np.ndarray:
    """The JAX package's unfused half step (models/t5.T5DecoderLayer.step
    without use_fused_cross_ffn): RMSNorm, T5Attention.cross_step, the
    residual, RMSNorm, the ReLU FFN, the residual."""
    import dataclasses

    from mmdx_tpu.config import ReportDecoderConfig
    from mmdx_tpu.models.t5 import RMSNorm, T5Attention

    jdt = DTYPES[dtype][0]
    h, cln, wq, woc, ck, cv, eb, fln, wi, wof = (jnp.asarray(a) for a in _k4_inputs())
    h, wq, woc, ck, cv, wi, wof = (a.astype(jdt) for a in (h, wq, woc, ck, cv, wi, wof))
    cfg = dataclasses.replace(ReportDecoderConfig(), d_model=DM, num_heads=HEADS, d_kv=DM // HEADS,
                              d_ff=DFF)
    rms, att = RMSNorm(dtype=jdt), T5Attention(cfg, dtype=jdt)

    def heads_major(t):  # [N, K, D] -> [N, h, K, d], the model's static_kv layout
        return t.reshape(N, KC, HEADS, DM // HEADS).transpose(0, 2, 1, 3)

    @jax.jit
    def step():
        y = rms.apply({"params": {"scale": cln}}, h)
        a = att.apply({"params": {"q": {"kernel": wq}, "o": {"kernel": woc}}}, y[:, None, :],
                      heads_major(ck), heads_major(cv), eb[:, None, None, :],
                      method=T5Attention.cross_step)
        x = h + a[:, 0, :]
        y = rms.apply({"params": {"scale": fln}}, x)
        f = jax.nn.relu(jnp.dot(y, wi, preferred_element_type=jnp.float32).astype(jdt))
        return x + jnp.dot(f, wof, preferred_element_type=jnp.float32).astype(jdt)

    return np.asarray(step().astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 3, 16])
def test_k4_split_k_arithmetic_matches_jax(splits, dtype, time_guard):
    """3 splits cut K = 128 and 256 unevenly (32/48/48, 80/80/96); 16 gives
    every 16 rows of K a split (K = 128: 8 splits). Row 1's keys are all
    masked: held to the XLA step, the other rows to both."""
    tdt = DTYPES[dtype][1]
    args = [_t(a) for a in _k4_inputs()]
    for i in (0, 2, 3, 4, 5, 8, 9):
        args[i] = args[i].to(tdt)
    got = _k4_split(*args, splits=splits)
    assert got.dtype == tdt and got.shape == (N, DM) and torch.isfinite(got).all()
    got = got.float().numpy()
    live = np.arange(N) != 1
    tol = dict(rtol=K4_TOL[dtype], atol=K4_TOL[dtype])
    np.testing.assert_allclose(got[live], _k4_pallas(dtype)[live], **tol,
                               err_msg=f"{splits} splits, against the Pallas kernel")
    np.testing.assert_allclose(got, _k4_xla(dtype), **tol,
                               err_msg=f"{splits} splits, against the XLA step")


def test_split_counts_and_bounds():
    """On 132 SMs at T5-small widths: 8 x 16 items for wq, wo_c and wo_f,
    32 x 4 for wi (at most one item per block); splits cover K in 16-row
    multiples, uneven by at most 16; a small grid still gives each column
    tile a split."""
    assert t5_step.split_counts(132, 512, 2048) == (16, 16, 4, 16)
    assert t5_step.split_counts(64, 512, 2048) == (8, 8, 2, 8)
    assert t5_step.split_counts(32, 512, 2048) == (4, 4, 1, 4)
    for k, s in ((512, 16), (2048, 16), (128, 3), (256, 3), (512, 1), (2048, 33)):
        b = t5_step.split_bounds(k, s)
        widths = np.diff(b)
        assert b[0] == 0 and b[-1] == k and len(b) == s + 1
        assert (widths % 16 == 0).all() and widths.max() - widths.min() <= 16, (k, s, b)


# ---------------------------------------------------------------------------
# K3: the cluster's partials
# ---------------------------------------------------------------------------
K3_TOL = {"f32": 1e-5, "bf16": 3e-2}


def _cluster_partials(q, kv, mask, bias, ranks: int):
    """K3's arithmetic (csrc/beam_attn.cu, PARTIAL): f32 scores, the keys
    cut into ``ranks`` contiguous chunks of ceil(K / ranks) (some empty when
    K < ranks), each chunk's max (-3e38 when empty) merged into the global
    m, e = exp(s - m) with the global m, the chunks' sums of e added in rank
    order (l), and the chunks' f32 products bf16(e) . v added in rank
    order (acc)."""
    b, nb, hd = q.shape
    kk, h = kv.shape[1], bias.shape[0]
    d = hd // h
    kh = kv[..., :hd].reshape(b, kk, h, d).to(F32)
    vh = kv[..., hd:].reshape(b, kk, h, d).to(F32)
    s = torch.einsum("bihd,bkhd->bhik", q.reshape(b, nb, h, d).to(F32), kh)
    s = s + bias[None, :, None, :] + mask[:, None, :, :]
    chunk = -(-kk // ranks)
    spans = [(min(kk, r * chunk), min(kk, (r + 1) * chunk)) for r in range(ranks)]
    m = torch.full(s.shape[:-1], -3e38)
    for lo, hi in spans:
        if hi > lo:
            m = torch.maximum(m, s[..., lo:hi].amax(-1))
    e = torch.exp(s - m[..., None])
    w = e.to(q.dtype).to(F32)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(b, h, nb, d)
    for lo, hi in spans:
        l = l + e[..., lo:hi].sum(-1)
        acc = acc + torch.einsum("bhik,bkhd->bhid", w[..., lo:hi], vh[:, lo:hi])
    return (acc.permute(0, 2, 1, 3).reshape(b, nb, hd), m.permute(0, 2, 1),
            l.permute(0, 2, 1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("kk", [5, 181, 724])
def test_k3_cluster_partials_match_pallas(kk, nb, dtype, time_guard):
    """Clusters of 1, 2, 3 and 8 ranks (K = 5 < 8 leaves ranks empty; 181
    and 724 are not multiples of 3 or 8) against the Pallas partials. The
    first sample's mask kills every column (the first decode step): m stays
    finite, about -1e9."""
    from mmdx_tpu.ops.pallas_beam_attn import beam_decode_attention_partial

    b, h, d = 2, 2, 64
    hd = h * d
    rng = np.random.default_rng(kk + nb)
    q = rng.standard_normal((b, nb, hd)).astype(np.float32)
    kv = rng.standard_normal((b, kk, 2 * hd)).astype(np.float32)
    mask = np.where(rng.random((b, nb, kk)) < 0.7, 0.0, -1e9).astype(np.float32)
    mask[0] = -1e9
    bias = rng.standard_normal((h, kk)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(beam_decode_attention_partial)(
            jnp.asarray(q).astype(jdt), jnp.asarray(kv).astype(jdt), jnp.asarray(mask),
            jnp.asarray(bias))
    ref = [np.asarray(r, np.float32) for r in ref]
    assert np.all(ref[1][0] < -1e8) and np.isfinite(ref[1]).all()
    args = (_t(q).to(tdt), _t(kv).to(tdt), _t(mask), _t(bias))
    plain = beam_attn.beam_decode_attention_partial_plain(*args)
    for ranks in (1, 2, 3, 8):
        got = _cluster_partials(*args, ranks)
        # against the plain version on the same CPU scores: bf16(exp(s - m))
        # rounds alike, so only the order of the f32 sums differs (a rank's
        # own max in the exponent moves acc by ~2^-9 of it in bf16)
        for name, g, r in zip(("acc", "m", "l"), got, plain):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-5 * max(1.0, float(r.abs().max())),
                                       err_msg=f"{name}, {ranks} ranks, against the plain version")
        for name, g, r in zip(("acc", "m", "l"), got, ref):
            assert torch.isfinite(g).all()
            # acc and l are f32 sums of K terms (acc's up to ~40 at K = 724),
            # whose order the split changes: the bar is relative to the
            # largest value of the output (at K = 28, as in the existing
            # partial test, that is about the bar itself)
            atol = K3_TOL[dtype] * max(1.0, float(np.abs(r).max())) if name != "m" \
                else K3_TOL[dtype]
            np.testing.assert_allclose(g.numpy(), r, rtol=K3_TOL[dtype], atol=atol,
                                       err_msg=f"{name}, {ranks} ranks")


# ---------------------------------------------------------------------------
# the rank count of the cluster reads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pairs, keys, fill, ranks", [
    (32, 181, beam_attn.FILL_BLOCKS, 8),     # greedy B=4: a small grid splits the keys
    (512, 181, beam_attn.FILL_BLOCKS, 1),    # greedy B=64: 512 pairs fill the card alone
    (64, 724, beam_attn.FILL_BLOCKS, 4),     # row 5 at beam B=8
    (64, 724, beam_attn.PARTIAL_FILL, 8),    # K3 at beam B=8
    (256, 724, beam_attn.PARTIAL_FILL, 4),   # K3 at B=32: chunks of at most 256 keys
    (32, 4, beam_attn.PARTIAL_FILL, 8),      # fewer keys than ranks
    (4096, 2048, beam_attn.FILL_BLOCKS, 8),  # chunks at most MAX_CHUNK while ranks last
])
def test_cluster_ranks(pairs, keys, fill, ranks):
    assert beam_attn.cluster_ranks(pairs, keys, fill) == ranks


def test_cluster_ranks_follow_the_grid():
    """Never more ranks for a larger grid at the same keys; a grid of at
    least ``fill`` blocks and chunks of at most MAX_CHUNK keys whenever 8
    ranks are not reached."""
    for fill in (beam_attn.FILL_BLOCKS, beam_attn.PARTIAL_FILL):
        for keys in (4, 181, 724, 1500):
            counts = [beam_attn.cluster_ranks(p, keys, fill) for p in (1, 8, 32, 64, 256, 1024)]
            assert all(c in (1, 2, 4, 8) for c in counts)
            assert counts == sorted(counts, reverse=True), (fill, keys, counts)
            for p, r in zip((1, 8, 32, 64, 256, 1024), counts):
                if r < 8:
                    assert p * r >= fill and -(-keys // r) <= beam_attn.MAX_CHUNK
