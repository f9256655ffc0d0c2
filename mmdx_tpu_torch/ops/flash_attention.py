"""Blockwise online-softmax attention with an additive bias (Queue 2 row 9).

Port of ``mmdx_tpu/ops/pallas_attention.py:flash_attention``:
``out = softmax(q * scale @ k^T + bias) @ v`` over ``[B, H, L, D]`` with a
bias that broadcasts to ``[B, H, Lq, Lk]`` (padding and causal masks are
encoded in it, -1e9 where a key is masked). As in the Pallas wrapper
(``:68-86``), a ragged key length is padded to its key block (128, or Lk
itself when shorter) with zero keys whose bias is -1e9; the padding changes
nothing unless every real key of a row is masked.

Rounding points of the Pallas body (``_flash_kernel`` ``:27-55``): q in f32
times ``scale``; f32 scores plus the bias; the running max (from -1e9) and
denominator in f32; the probabilities in f32, multiplied by v in f32;
``acc / denom`` cast to q's dtype.

Kernels (CUDA C++, ``csrc/flash_attn.cu``), one launch, a block per (64
or 128 query rows, sequence x head), in one of two bodies picked by
:func:`tensor_core_body`: bf16 operands with a power-of-two ``scale``
(BERT's 1/8) run the tensor-core body (``mma.sync`` bf16 products, exact in
f32, with p split into two bf16 halves for p.v, and K/V tiles streamed by
``cp.async``); f32 operands or any other scale run the CUDA-core body
(every product an f32 FMA). Both read q, k, v and the bias through their
strides and write ``out`` as a ``[B, H, Lq, D]`` view of a ``[B, Lq, H, D]``
buffer, so BERT's head split and merge cost no copies. They take D = 64
(BERT-base's head width) and L up to any length. The source notes what
bounds them.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import math

import torch

from mmdx_tpu_torch import _build

F32 = torch.float32
NEG_INF = -1e9
BLOCK_K = 128  # the Pallas wrapper's key block (flash_attention block_k)
HEAD_DIM = 64  # the kernel's head width


def padded_key_len(lk: int, block_k: int = BLOCK_K) -> int:
    """The key length after the Pallas wrapper's padding to its key block."""
    blk = min(block_k, lk)
    return -(-lk // blk) * blk


def flash_attention_plain(q, k, v, bias, scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: the whole score row at once in f32 (the
    online recurrence of the kernel gives the same value up to f32
    summation order), with the wrapper's padded keys at -1e9."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    s = (q.to(F32) * scale) @ k.to(F32).transpose(-1, -2)
    s = s + torch.broadcast_to(bias.to(F32), (b, h, lq, lk))
    vf = v.to(F32)
    pad = padded_key_len(lk) - lk
    if pad:
        s = torch.cat([s, s.new_full((b, h, lq, pad), NEG_INF)], dim=-1)
        vf = torch.cat([vf, vf.new_zeros((b, h, pad, d))], dim=2)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    return ((p @ vf) / p.sum(-1, keepdim=True)).to(q.dtype)


def _check_operand(t, name: str, dtype, b: int, h: int, d: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"flash_attention.{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention.{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 4 or t.shape[0] != b or t.shape[1] != h or t.shape[3] != d:
        raise ValueError(f"flash_attention.{name}: expected [{b}, {h}, L, {d}], "
                         f"got {tuple(t.shape)}")
    vec = 16 // t.element_size()  # elements in one 16-byte load
    if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention.{name}: rows must be contiguous and "
                         f"16-byte aligned, got strides {t.stride()}")


def tensor_core_body(dtype, scale: float) -> bool:
    """The rule that picks the kernel's body: the tensor-core body for bf16
    operands and a positive power-of-two ``scale``, where bf16 q times the
    scale is exact and the tensor cores' f32 sums of exact bf16 products are
    the Pallas body's f32 scores up to summation order; the CUDA-core body
    for every other case (f32 operands, as the parity engine passes, or a
    scale whose product with q would round)."""
    return (dtype == torch.bfloat16 and math.isfinite(scale) and scale > 0
            and math.frexp(scale)[0] == 0.5)


def flash_attention(q, k, v, bias, scale: float = 1.0) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, H, Lk, D] (bf16 or f32); bias additive,
    broadcastable to [B, H, Lq, Lk] -> [B, H, Lq, D] in q.dtype.

    ``scale`` multiplies q (1/sqrt(D) for BERT). On the card the launch
    goes to the body :func:`tensor_core_body` names, counted in
    ``flash_attention.tc_launches`` or ``.fma_launches`` and, both together,
    in ``.launches``; a body that fails to build or launch raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention: head width {d} (the kernel takes {HEAD_DIM})")
    if q.dtype not in (torch.bfloat16, F32):
        raise ValueError(f"flash_attention: expected bf16 or f32, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, q.dtype, b, h, d)
    if v.shape[2] != lk:
        raise ValueError(f"flash_attention: {lk} keys but {v.shape[2]} values")
    if not bias.is_cuda or bias.dtype != F32:
        raise ValueError(f"flash_attention.bias: expected f32 on the card, got "
                         f"{bias.dtype} on {bias.device}")
    bias = torch.broadcast_to(bias, (b, h, lq, lk))  # a view: broadcast strides 0
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *bias.stride(),
            *out.stride()[:3], b, h, lq, lk, padded_key_len(lk), float(scale)]
    lib = _build.lib()
    if tensor_core_body(q.dtype, scale):
        _build.check(lib.mmdx_flash_attn_tc(*args, _build.stream(q)), "flash_attention (tc)")
        flash_attention.tc_launches += 1
    else:
        _build.check(lib.mmdx_flash_attn(*args, int(q.dtype == torch.bfloat16),
                                         _build.stream(q)), "flash_attention")
        flash_attention.fma_launches += 1
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.fma_launches = 0
