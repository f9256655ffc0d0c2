"""The bf16 GEMM under the fused BERT blocks (``csrc/gemm.cu``): its tile
plan, its launches, and the split-K LayerNorm that ends each block.

``C[M, N] = epi(A[M, K] @ B[K, N])`` runs as ``wgmma`` on TMA-fed
shared-memory stages (see the note at the top of ``csrc/gemm.cu``). The
plan is computed here, in Python, so the CPU tests see what the card runs:

* 128 x 128 output tiles (two consumer warpgroups) where those tiles alone
  fill the SMs (the classify rows at B=32, long text), two blocks to an SM;
* otherwise 64-row tiles, and 64 columns wide if that is what it takes to
  fill them (one request, B=4);
* the products that end in the LayerNorm (N = H, ``split=True``) split
  over K when their tiles still leave SMs idle: each split writes f32
  partials ``[splits, M, N]``, and the LayerNorm kernel sums them in split
  order, then adds bias and residual. No atomics, and the block keeps its
  launch count.

The plain emulation of that arithmetic, ``split_k_residual_ln``, is what
the CPU tests hold against the Pallas blocks.
"""
from __future__ import annotations

import functools

import torch

from mmdx_tpu_torch import _build

F32 = torch.float32
BK = 64           # K step: one 128-byte swizzle row of bf16
MAX_STAGES = 4
STAGE_BUDGET = 96 * 1024  # shared memory for a block's ring: two blocks to an SM
MAX_SPLITS = 8
H100_SMS = 132


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS,
              split: bool = False) -> tuple[int, int, int, int]:
    """(bm, bn, stages, splits) for ``[m, k] @ [k, n]`` on ``sms`` SMs.

    bm is 64 or 128 (one or two 64-row consumer warpgroups), bn 128 or 64
    (a multiple of wgmma's 8 that divides n); splits divides the k / 64
    steps and is > 1 only with ``split`` (a product whose LayerNorm sums
    the partials). Raises unless n and k are multiples of 64."""
    if m <= 0 or n <= 0 or n % 64 or k <= 0 or k % BK:
        raise ValueError(f"gemm_plan: unsupported shape m={m} n={n} k={k} "
                         "(n and k must be multiples of 64)")
    bn = 128 if n % 128 == 0 else 64
    bm = 128 if cdiv(m, 128) * (n // bn) >= sms else 64
    if cdiv(m, bm) * (n // bn) < sms:
        bn = 64
    tiles = cdiv(m, bm) * (n // bn)
    steps = k // BK
    splits = 1
    if split:
        divisors = [s for s in range(1, min(MAX_SPLITS, steps) + 1) if steps % s == 0]
        splits = next((s for s in divisors if tiles * s >= sms), divisors[-1])
    ring = STAGE_BUDGET // ((bm + bn) * BK * 2)
    stages = max(2, min(MAX_STAGES, ring, steps // splits))
    return bm, bn, stages, splits


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sms_of(t: torch.Tensor) -> int:
    return sm_count(t.device.index if t.device.index is not None
                    else torch.cuda.current_device())


def gemm(a, b, bias, resid, out, epi: int, plan, name: str) -> None:
    """Launch ``csrc/gemm.cu`` on ``plan``: ``out = epi(a @ b)`` (CUDA
    tensors, checked by the caller)."""
    bm, bn, stages, splits = plan
    m, k = a.shape
    n = b.shape[1]
    _build.check(_build.lib().mmdx_gemm_bf16(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(), m, n, k, epi,
        bm, bn, stages, splits, _build.stream(a)), name)


def layer_norm(y, ln_scale, ln_bias, out, eps: float, name: str, splits: int = 1,
               bias=None, resid=None) -> None:
    """Launch the LayerNorm kernel: ``out = bf16(LN(y))`` over rows of f32
    ``y [M, H]``, or with ``bias`` and ``resid`` over
    ``((y[0] + ... + y[splits - 1]) + bias) + resid`` of the partials
    ``y [splits, M, H]``."""
    m, h = out.shape
    if h % 128 or h > 1024:
        raise ValueError(f"layer_norm: rows of {h} (the kernel takes 128 to 1024 "
                         "columns in steps of 128)")
    _build.check(_build.lib().mmdx_layernorm_f32_bf16(
        y.data_ptr(), splits, None if bias is None else bias.data_ptr(),
        None if resid is None else resid.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), out.data_ptr(), m, h, eps, _build.stream(y)), name)


def residual_gemm_ln(a, w, bias, resid, ln_scale, ln_bias, eps: float, name: str):
    """``bf16(LN((a @ w + bias) + resid))`` in two launches (CUDA bf16
    tensors, checked by the caller): the GEMM, split over K by the plan,
    writing f32 rows or partials, then the LayerNorm kernel."""
    m, k = a.shape
    h = w.shape[1]
    plan = gemm_plan(m, h, k, sms_of(a), split=True)
    splits = plan[3]
    y = torch.empty((splits, m, h), dtype=F32, device=a.device)
    out = torch.empty_like(resid)
    if splits == 1:
        gemm(a, w, bias, resid, y, _build.EPI_BIAS_RESID_F32, plan, name)
        layer_norm(y, ln_scale, ln_bias, out, eps, name + "_ln")
    else:
        gemm(a, w, None, None, y, _build.EPI_PARTIAL_F32, plan, name)
        layer_norm(y, ln_scale, ln_bias, out, eps, name + "_ln", splits, bias, resid)
    return out


def layer_norm_f32(y: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in f32 (two-pass statistics)."""
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + eps) * scale.to(F32) + bias.to(F32)


def split_k_residual_ln(a, w, bias, resid, ln_scale, ln_bias, eps: float, splits: int):
    """Plain emulation of the split-K product and its LayerNorm: f32
    partials of ``a @ w`` over ``splits`` equal K ranges of whole 64-deep
    steps, summed in split order, then plus bias, then plus the residual,
    then LayerNorm in f32 -> ``resid.dtype``."""
    k = a.shape[1]
    if k % (BK * splits):
        raise ValueError(f"split_k_residual_ln: K={k} is not {splits} splits of {BK}")
    step = k // splits
    af, wf = a.to(F32), w.to(F32)
    y = af[:, :step] @ wf[:step]
    for s in range(1, splits):
        y = y + af[:, s * step:(s + 1) * step] @ wf[s * step:(s + 1) * step]
    y = (y + bias.to(F32)) + resid.to(F32)
    return layer_norm_f32(y, ln_scale, ln_bias, eps).to(resid.dtype)
