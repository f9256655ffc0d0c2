"""Beam self-attention partials over the flat physical KV cache.

Port of ``mmdx_tpu/ops/pallas_beam_attn.py:beam_decode_attention_partial``:
unnormalised softmax partials over the OLD cache,

    acc [B, nb, h*d] f32 = sum_k exp(s_k - m) . v_k
    m   [B, nb, h]   f32 = max_k s_k
    l   [B, nb, h]   f32 = sum_k exp(s_k - m)

with s = q_h . k_h + bias[h] + mask[b, i]. The caller (models/t5.py) then
composes the step's own token, whose cache column the mask kills. The cache
is [B, nb*Lmax, 2*h*d] bf16, position-major (row t*nb + j = slot j's token
t), k|v packed in the minor dim. The JAX wrapper splits m and l out of an
interleaved [B, nb, 2h] output; this one returns them directly.

Kernel (CUDA C++, ``csrc/beam_attn.cu``), one launch, one block per
(sample, head). What bounds it on the H100: bytes. Every decode step reads
the whole cache once per layer (at B=8, K=724: 8 x 724 x 2 KB = 11.9 MB)
for only nb = 4 query rows, so the products run in f32 on the CUDA cores;
the design streams each k and v row once with 16-byte loads and keeps the
nb x K scores in shared memory.

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

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, d = 64, nb <= 8) or raise."""
    if q.device.type == "cpu":
        return beam_decode_attention_partial_plain(q, kv, mask, bias)
    b, nb, hd = q.shape
    kk = kv.shape[1]
    h = bias.shape[0]
    if hd != h * HEAD_DIM or not 0 < nb <= MAX_BEAMS:
        raise ValueError(f"beam_decode_attention_partial: needs head_dim "
                         f"{HEAD_DIM} and nb <= {MAX_BEAMS}, got hd={hd}, h={h}, nb={nb}")
    _build.require(q, "q", torch.bfloat16, (b, nb, hd))
    _build.require(kv, "kv", torch.bfloat16, (b, kk, 2 * hd))
    _build.require(mask, "mask", F32, (b, nb, kk))
    _build.require(bias, "bias", F32, (h, kk))
    acc = torch.empty((b, nb, hd), dtype=F32, device=q.device)
    m = torch.empty((b, nb, h), dtype=F32, device=q.device)
    l = torch.empty((b, nb, h), dtype=F32, device=q.device)
    _build.check(_build.lib().mmdx_beam_attn_partial(
        q.data_ptr(), kv.data_ptr(), mask.data_ptr(), bias.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, nb, kk, h, HEAD_DIM,
        _build.stream(q)), "beam_attn_partial")
    beam_decode_attention_partial.launches += 1
    return acc, m, l


beam_decode_attention_partial.launches = 0
