"""Beam self-attention over the flat physical KV cache.

Three reads, ports of ``mmdx_tpu/ops/pallas_beam_attn.py``: the softmax
partials over the old cache for deferred writes (``beam_decode_attention_partial``,
below), and the normalised read over the written cache, bf16
(``beam_decode_attention``) or int8 with per-(row, head) scales
(``beam_decode_attention_int8``), with the int8 cache's quantize-on-write
(``quantize_kv_rows``), at the end of the module.

``beam_decode_attention_partial`` returns unnormalised softmax partials over
the OLD cache,

    acc [B, nb, h*d] f32 = sum_k exp(s_k - m) . v_k
    m   [B, nb, h]   f32 = max_k s_k
    l   [B, nb, h]   f32 = sum_k exp(s_k - m)

with s = q_h . k_h + bias[h] + mask[b, i]. The caller (models/t5.py) then
composes the step's own token, whose cache column the mask kills. The cache
is [B, nb*Lmax, 2*h*d] bf16, position-major (row t*nb + j = slot j's token
t), k|v packed in the minor dim. The JAX wrapper splits m and l out of an
interleaved [B, nb, 2h] output; this one returns them directly.

Kernels (CUDA C++, ``csrc/beam_attn.cu``), one launch each. What bounds
them on the H100: bytes. Every decode step reads the whole cache once per
layer (at B=8, K=724: 8 x 724 x 2 KB = 11.9 MB) for only nb = 4 query
rows, so the products run in f32 on the CUDA cores, each k and v row
read once. All three run one cluster body: a thread-block cluster per
(sample, head) whose blocks (ranks) each take a contiguous share of the
keys, copied to shared memory 16 bytes at a time, and merge the softmax
statistics and partial products through distributed shared memory. The
rank count follows the grid (:func:`cluster_ranks`).

Masks are additive -1e9, never -inf (models/t5.NEG_INF): at pos = 0 every
cache column is masked, m is about -1e9, and the composition's
``exp(m - m_own)`` underflows to exactly 0.
"""
from __future__ import annotations

import torch

from mmdx_tpu_torch import _build

F32 = torch.float32
HEAD_DIM = 64
MAX_BEAMS = 8
# cluster_ranks: a read's grid grows to at least ``fill`` blocks before it
# stops splitting the keys (FILL_BLOCKS for the normalised reads,
# PARTIAL_FILL for the partials, whose scoring takes a key a thread), and no
# block takes more than MAX_CHUNK keys: the fastest rank counts of
# scripts/bench_decode_kernels.py --ranks on an H100 at beam B=4, 8, 32 and
# greedy B=4, 64
FILL_BLOCKS = 256
PARTIAL_FILL = 512
MAX_CHUNK = 256


def cluster_ranks(pairs: int, keys: int, fill: int = FILL_BLOCKS) -> int:
    """Blocks per cluster (1, 2, 4 or 8) for a read of ``pairs`` (sample,
    head) pairs over ``keys`` keys: the fewest that give the grid ``fill``
    blocks and each block at most ``MAX_CHUNK`` keys, so a small grid
    splits the keys over the card and a large one (greedy at B=64: 512
    pairs) keeps whole (sample, head)s in one block."""
    ranks = 1
    while ranks < 8 and (pairs * ranks < fill or -(-keys // ranks) > MAX_CHUNK):
        ranks *= 2
    return ranks


def beam_decode_attention_partial_plain(q, kv, mask, bias):
    """Plain PyTorch version: f32 scores and exponentials, the exponentials
    rounded to q.dtype before the product with v (as in the Pallas body)."""
    b, nb, hd = q.shape
    kk = kv.shape[1]
    h = bias.shape[0]
    d = hd // h
    qh = q.reshape(b, nb, h, d).to(F32)
    kh = kv[..., :hd].reshape(b, kk, h, d).to(F32)
    vh = kv[..., hd:].reshape(b, kk, h, d).to(F32)
    s = torch.einsum("bihd,bkhd->bhik", qh, kh)
    s = s + bias.to(F32)[None, :, None, :] + mask.to(F32)[:, None, :, :]
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1)
    acc = torch.einsum("bhik,bkhd->bihd", e.to(q.dtype).to(F32), vh)
    return acc.reshape(b, nb, hd), m[..., 0].permute(0, 2, 1), l.permute(0, 2, 1)


def beam_decode_attention_partial(q, kv, mask, bias):
    """q [B, nb, h*d]; kv [B, K, 2*h*d]; mask [B, nb, K] f32; bias [h, K] f32
    -> (acc [B, nb, h*d] f32, m [B, nb, h] f32, l [B, nb, h] f32).

    Kernel (CUDA C++, ``csrc/beam_attn.cu`` ``beam_partial_kernel``), one
    launch: the normalised read's cluster body without the division by the
    sum, e = exp(s - m) with the cluster's global max rounded to bf16 before
    the product with v (the Pallas body's rounding point), acc in f32 and m,
    l per (row, head), on clusters of :func:`cluster_ranks` blocks.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, d = 64, nb <= 8) or raise."""
    if q.device.type == "cpu":
        return beam_decode_attention_partial_plain(q, kv, mask, bias)
    b, nb, kk, h = _check_read(q, kv, mask, bias, torch.bfloat16)
    acc = torch.empty((b, nb, h * HEAD_DIM), dtype=F32, device=q.device)
    m = torch.empty((b, nb, h), dtype=F32, device=q.device)
    l = torch.empty((b, nb, h), dtype=F32, device=q.device)
    _build.check(_build.lib().mmdx_beam_attn_partial(
        q.data_ptr(), kv.data_ptr(), mask.data_ptr(), bias.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, nb, kk, h, HEAD_DIM,
        cluster_ranks(b * h, kk, PARTIAL_FILL), _build.stream(q)),
        "beam_attn_partial")
    beam_decode_attention_partial.launches += 1
    return acc, m, l


beam_decode_attention_partial.launches = 0


# ---------------------------------------------------------------------------
# The normalised read over the WRITTEN cache (own column live): bf16 and int8
# ---------------------------------------------------------------------------
def _softmax_ctx(s, vh, out_dtype, sv=None):
    """f32 scores [B, h, nb, K] -> ctx [B, nb, h*d] in ``out_dtype``:
    p = (exp(s - max) / sum) (times the V scales ``sv [B, h, K]``) rounded to
    ``out_dtype``, then the f32 product with ``vh [B, K, h, d]``."""
    b, h, nb, _ = s.shape
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    if sv is not None:
        p = p * sv[:, :, None, :]
    ctx = torch.einsum("bhik,bkhd->bihd", p.to(out_dtype).to(F32), vh.to(F32))
    return ctx.reshape(b, nb, -1).to(out_dtype)


def beam_decode_attention_plain(q, kv, mask, bias):
    """Plain PyTorch version with the Pallas body's rounding points
    (``pallas_beam_attn.py:81-92``): f32 scores and softmax, p rounded to
    q.dtype, f32 p.v, ctx in q.dtype."""
    b, nb, hd = q.shape
    kk, h = kv.shape[1], bias.shape[0]
    d = hd // h
    kh = kv[..., :hd].reshape(b, kk, h, d).to(F32)
    s = torch.einsum("bihd,bkhd->bhik", q.reshape(b, nb, h, d).to(F32), kh)
    s = s + bias.to(F32)[None, :, None, :] + mask.to(F32)[:, None, :, :]
    return _softmax_ctx(s, kv[..., hd:].reshape(b, kk, h, d), q.dtype)


def beam_decode_attention_int8_plain(q, kv, kvs, mask, bias):
    """Plain PyTorch version of the int8 read (``pallas_beam_attn.py:287-334``):
    s = (q . k_i8) * sk, p = (softmax * sv) rounded to q.dtype, ctx = p . v_i8."""
    b, nb, hd = q.shape
    kk, h = kv.shape[1], bias.shape[0]
    d = hd // h
    kh = kv[..., :hd].reshape(b, kk, h, d).to(F32)
    s = torch.einsum("bihd,bkhd->bhik", q.reshape(b, nb, h, d).to(F32), kh)
    s = s * kvs[:, :h, None, :]
    s = s + bias.to(F32)[None, :, None, :] + mask.to(F32)[:, None, :, :]
    return _softmax_ctx(s, kv[..., hd:].reshape(b, kk, h, d), q.dtype, kvs[:, h:])


def quantize_kv_rows(k_new, v_new, heads: int):
    """Quantize-on-write of the int8 cache (``models/t5.py:244-259``): per
    (row, head) scale s = max(amax, 1e-12) / 127, q = clip(round(x / s)).
    k_new, v_new [B, nb, h*d] -> (rows int8 [B, nb, 2*h*d], scales f32
    [B, 2h, nb], K scales then V scales). Divides by a tensor on the same
    device, as the JAX divide does (``int8_gemm.div_exact``)."""
    from mmdx_tpu_torch.ops.int8_gemm import div_exact

    b, nb, hd = k_new.shape
    out, scales = [], []
    for x in (k_new, v_new):
        xr = x.reshape(b, nb, heads, hd // heads).to(F32)
        s = div_exact(torch.clamp_min(xr.abs().amax(-1), 1e-12), 127.0)
        out.append(torch.clamp(torch.round(xr / s[..., None]), -127, 127).reshape(b, nb, hd))
        scales.append(s.transpose(1, 2))
    return torch.cat(out, dim=-1).to(torch.int8), torch.cat(scales, dim=1)


def _check_read(q, kv, mask, bias, kv_dtype):
    b, nb, hd = q.shape
    kk, h = kv.shape[1], bias.shape[0]
    if hd != h * HEAD_DIM or not 0 < nb <= MAX_BEAMS:
        raise ValueError(f"beam_decode_attention: needs head_dim {HEAD_DIM} and "
                         f"nb <= {MAX_BEAMS}, got hd={hd}, h={h}, nb={nb}")
    _build.require(q, "q", torch.bfloat16, (b, nb, hd))
    _build.require(kv, "kv", kv_dtype, (b, kk, 2 * hd))
    _build.require(mask, "mask", F32, (b, nb, kk))
    _build.require(bias, "bias", F32, (h, kk))
    return b, nb, kk, h


def beam_decode_attention(q, kv, mask, bias):
    """q [B, nb, h*d]; kv [B, K, 2*h*d]; mask [B, nb, K] f32; bias [h, K] f32
    -> ctx [B, nb, h*d] in q.dtype: the normalised read over the written
    cache (port of ``pallas_beam_attn.beam_decode_attention``; at nb = 1 the
    flat greedy read).

    Kernel (CUDA C++, ``csrc/beam_attn.cu`` ``mmdx_beam_attn``), one launch:
    a thread-block cluster of 1-8 blocks per (sample, head)
    (:func:`cluster_ranks`), each block a contiguous share of
    the keys, the softmax max and sum and the partial products merged
    through distributed shared memory (``sm_90``'s clusters), ctx rounded
    to bf16. Bounded by bytes: the whole cache once per layer per step
    (B=8, nb=4, K=724: 11.9 MB; greedy B=4, K=181: 1.5 MB), each k and v
    row copied once, 16 bytes at a time.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, d = 64, nb <= 8) or raise."""
    if q.device.type == "cpu":
        return beam_decode_attention_plain(q, kv, mask, bias)
    b, nb, kk, h = _check_read(q, kv, mask, bias, torch.bfloat16)
    ctx = torch.empty_like(q)
    _build.check(_build.lib().mmdx_beam_attn(
        q.data_ptr(), kv.data_ptr(), mask.data_ptr(), bias.data_ptr(), ctx.data_ptr(),
        b, nb, kk, h, HEAD_DIM, cluster_ranks(b * h, kk), _build.stream(q)),
        "beam_attn")
    beam_decode_attention.launches += 1
    return ctx


beam_decode_attention.launches = 0


def beam_decode_attention_int8(q, kv, kvs, mask, bias):
    """``beam_decode_attention`` over the int8 cache: kv [B, K, 2*h*d] int8,
    kvs [B, 2h, K] f32 per-(row, head) scales (port of
    ``pallas_beam_attn.beam_decode_attention_int8``).

    Kernel (CUDA C++, ``csrc/beam_attn.cu`` ``mmdx_beam_attn_int8``): the
    bf16 read's cluster kernel instantiated for int8 rows (64-byte key and
    value slices), the K scale applied to each score and the V scale folded
    into the probabilities, as in the Pallas body. Bounded by bytes: half
    the bf16 cache plus 8 bytes of scales per row and head.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return beam_decode_attention_int8_plain(q, kv, kvs, mask, bias)
    b, nb, kk, h = _check_read(q, kv, mask, bias, torch.int8)
    _build.require(kvs, "kvs", F32, (b, 2 * h, kk))
    ctx = torch.empty_like(q)
    _build.check(_build.lib().mmdx_beam_attn_int8(
        q.data_ptr(), kv.data_ptr(), kvs.data_ptr(), mask.data_ptr(), bias.data_ptr(),
        ctx.data_ptr(), b, nb, kk, h, HEAD_DIM, cluster_ranks(b * h, kk),
        _build.stream(q)), "beam_attn_int8")
    beam_decode_attention_int8.launches += 1
    return ctx


beam_decode_attention_int8.launches = 0
