"""The T5 decoder's cross-attention + FFN half-step.

Port of ``mmdx_tpu/ops/pallas_t5_step.py:cross_ffn_block``: RMSNorm ->
cross-attention over each row's own K conditioning tokens -> residual ->
RMSNorm -> ReLU FFN (512 -> 2048 -> 512) -> residual. T5 attention has no
1/sqrt(d) scale, and the T5 RMSNorm quirk is kept: f32 variance, the
normalised value rounded to the working dtype BEFORE the f32 scale multiply.

Kernel (CUDA C++, ``csrc/t5_cross_ffn.cu``), one launch a layer: a
persistent cooperative kernel, one block per SM, whose nine phases (the
first RMSNorm, the four products and the four steps that reduce them: q
with the attention, x with the second RMSNorm, hmid's ReLU, out) are
separated by grid barriers.
Each product is cut into (64-column tile x K-split) items, at most one per
block (:func:`split_counts`), so every SM streams a share of the layer's
weights; each block prefetches all of its weight tiles at entry. Split-K
is deterministic: the f32 partials go to a workspace and are added in
split order before each rounding point.

What bounds it on the H100: latency. At N = B*nb = 4-128 rows a layer
reads 5.2 MB of bf16 weights (1.6 us at 3.35 TB/s) for at most 2.6 GFLOP,
so the time is the chain's serial steps (eight grid barriers of about 1 us
each) plus that read spread over the card. The TPU kernel ran the chain as one program
with every intermediate in VMEM and all rows packed into a block-diagonal
score matrix; here the intermediates ([N, 512] and [N, 2048] bf16, the f32
partials) stay in L2 between phases and each row attends only to its own
keys.
"""
from __future__ import annotations

import torch

from mmdx_tpu_torch import _build

F32 = torch.float32


def rms_norm(x, scale, eps: float):
    """models/t5.RMSNorm: f32 variance, y rounded to x.dtype before the f32
    scale multiply, the product rounded again."""
    x32 = x.to(F32)
    var = x32.square().mean(-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return (scale.to(F32) * y.to(F32)).to(x.dtype)


def cross_ffn_block_plain(hidden, cross_ln_scale, wq, wo_c, ck, cv, enc_bias,
                          ffn_ln_scale, wi, wo_f, heads: int, eps: float = 1e-6):
    """Plain PyTorch version with the Pallas body's rounding points."""
    dt = hidden.dtype
    n, dm = hidden.shape
    kk = ck.shape[1]
    d = dm // heads

    def dot(a, w):
        return (a.to(F32) @ w.to(F32)).to(dt)

    y = rms_norm(hidden, cross_ln_scale, eps)
    q = dot(y, wq).reshape(n, heads, d).to(F32)
    s = torch.einsum("nhd,nkhd->nhk", q, ck.reshape(n, kk, heads, d).to(F32))
    s = s + enc_bias.to(F32)[:, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    ctx = torch.einsum("nhk,nkhd->nhd", p.to(F32),
                       cv.reshape(n, kk, heads, d).to(F32)).to(dt)
    x = (hidden.to(F32) + dot(ctx.reshape(n, dm), wo_c).to(F32)).to(dt)
    y = rms_norm(x, ffn_ln_scale, eps)
    hmid = dot(y, wi).clamp_min(0)
    return (x.to(F32) + dot(hmid, wo_f).to(F32)).to(dt)


SPLIT_CAP = 16  # K-splits per product: more would only add partials to sum
TILE_N = 64     # output columns of one work item (csrc/t5_cross_ffn.cu)


def split_counts(blocks: int, dm: int, dff: int) -> tuple[int, int, int, int]:
    """K-splits of the four products (wq, wo_c, wi, wo_f) on a grid of
    ``blocks``: as many as keep every block at most one (column tile,
    K-split) item, at most ``SPLIT_CAP``, each split at least 16 deep
    (132 SMs, T5-small: 16, 16, 4, 16)."""
    def splits(k, cols):
        return max(1, min(blocks // (cols // TILE_N), k // 16, SPLIT_CAP))

    return splits(dm, dm), splits(dm, dm), splits(dm, dff), splits(dff, dm)


def split_bounds(k: int, splits: int) -> list[int]:
    """Split s of a K-deep product covers rows [b[s], b[s + 1]): multiples
    of 16, uneven by at most 16 (``split_lo`` in csrc/t5_cross_ffn.cu)."""
    units = k // 16
    return [16 * (s * units // splits) for s in range(splits + 1)]


_SCRATCH: dict = {}


def _scratch(device, stream: int, floats: int):
    """The f32 workspace of one (device, stream), grown as needed and
    reused, so the hot path allocates only the output."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < floats:
        buf = torch.empty(floats, dtype=F32, device=device)
        _SCRATCH[key] = buf
    return buf


def cross_ffn_block(hidden, cross_ln_scale, wq, wo_c, ck, cv, enc_bias,
                    ffn_ln_scale, wi, wo_f, heads: int, eps: float = 1e-6):
    """hidden [N, D]; cross_ln_scale, ffn_ln_scale f32 [D]; wq, wo_c [D, D];
    ck, cv [N, K, D] (head-major minor dim); enc_bias f32 [N, K] additive;
    wi [D, F]; wo_f [F, D] -> [N, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, 64-wide heads, K <= 16) or raise."""
    if hidden.device.type == "cpu":
        return cross_ffn_block_plain(hidden, cross_ln_scale, wq, wo_c, ck, cv,
                                     enc_bias, ffn_ln_scale, wi, wo_f, heads, eps)
    n, dm = hidden.shape
    kk = ck.shape[1]
    dff = wi.shape[1]
    bf = torch.bfloat16
    for t, name, shape in ((hidden, "hidden", (n, dm)), (wq, "wq", (dm, dm)),
                           (wo_c, "wo_c", (dm, dm)), (ck, "ck", (n, kk, dm)),
                           (cv, "cv", (n, kk, dm)), (wi, "wi", (dm, dff)),
                           (wo_f, "wo_f", (dff, dm))):
        _build.require(t, name, bf, shape)
    for t, name, shape in ((cross_ln_scale, "cross_ln_scale", (dm,)),
                           (ffn_ln_scale, "ffn_ln_scale", (dm,)),
                           (enc_bias, "enc_bias", (n, kk))):
        _build.require(t, name, F32, shape)
    if dm % TILE_N or dff % TILE_N or dm != heads * 64 or not 0 < kk <= 16:
        raise ValueError(f"cross_ffn_block: unsupported widths {dm}, {dff}, {heads} heads, "
                         f"K={kk} (needs 64-wide heads, widths in 64s, K <= 16)")
    dev = hidden.device
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count  # one block per SM
    if dff // TILE_N > blocks:
        raise ValueError(f"cross_ffn_block: {dff // TILE_N} column tiles need as many "
                         f"co-resident blocks, the card has {blocks} SMs")
    sq, so, si, sf = split_counts(blocks, dm, dff)
    partials = n * max(sq * dm, so * dm, si * dff, sf * dm)
    # bf16 scratch after the partials: y, ctx, x [N, D] and hmid [N, F]
    s = _build.stream(hidden)
    ws = _scratch(dev, s, partials + n * (3 * dm + dff) // 2)
    base = ws.data_ptr()
    y, ctx, x, hmid = (base + 4 * partials + 2 * n * dm * i for i in range(4))
    out = torch.empty((n, dm), dtype=bf, device=dev)
    _build.check(_build.lib().mmdx_t5_cross_ffn(
        hidden.data_ptr(), cross_ln_scale.data_ptr(), wq.data_ptr(), wo_c.data_ptr(),
        ck.data_ptr(), cv.data_ptr(), enc_bias.data_ptr(), ffn_ln_scale.data_ptr(),
        wi.data_ptr(), wo_f.data_ptr(), y, ctx, x, hmid, out.data_ptr(), base,
        n, dm, dff, kk, heads, eps, blocks, sq, so, si, sf, s), "t5_cross_ffn")
    cross_ffn_block.launches += 1
    return out


cross_ffn_block.launches = 0
