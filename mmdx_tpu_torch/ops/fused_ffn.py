"""Fused BERT feed-forward block: ``LayerNorm(x + gelu_erf(x Wi + bi) Wo + bo)``.

Port of ``mmdx_tpu/ops/pallas_ffn.py:fused_ffn_ln`` (the bf16 kernel; the
int8 variant belongs to the turbo tier and is not ported yet).

Kernel (CUDA C++, ``csrc/gemm.cu``), three launches:

1. ``mid = bf16(gelu_erf(x @ Wi + bi))`` — tiled bf16 GEMM on the tensor
   cores with the bias + exact-erf GELU epilogue (``erff``; the Pallas body
   used an Abramowitz-Stegun erf only because Mosaic has no erf);
2. ``y = f32((mid @ Wo + bo) + x)`` — the same GEMM with the bias + residual
   epilogue;
3. ``out = bf16(LayerNorm(y))`` — one warp per 768-wide row, f32 statistics.

What bounds it on the H100: FLOPs. At B*L = 3072 rows the two products are
2 x 3072 x 768 x 3072 MACs (29 GFLOP) against ~75 MB moved as built (~30 MB
if fused), above the card's ~295 FLOP/byte break-even either way, so the
design keeps every product on the tensor cores. The [rows, 3072] GELU
intermediate, which the TPU kernel kept in VMEM, goes through device memory
here (bf16 scratch from ``torch.empty``, 18 MB at 3072 rows); so does the
f32 pre-LayerNorm row.
Fusing them back into one launch (a block owning 32 full rows) is later work.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mmdx_tpu_torch import _build

F32 = torch.float32


def layer_norm_f32(y: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in f32 (two-pass statistics)."""
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + eps) * scale.to(F32) + bias.to(F32)


def fused_ffn_ln_plain(x, wi, bi, wo, bo, ln_scale, ln_bias, eps: float = 1e-12):
    """Plain PyTorch version with the Pallas body's rounding points: f32
    products of the working-dtype operands, GELU output rounded to x.dtype."""
    dt = x.dtype
    mid = x.to(F32) @ wi.to(F32) + bi.to(F32)
    mid = F.gelu(mid).to(dt)
    y = mid.to(F32) @ wo.to(F32) + bo.to(F32) + x.to(F32)
    return layer_norm_f32(y, ln_scale, ln_bias, eps).to(dt)


def fused_ffn_ln(x, wi, bi, wo, bo, ln_scale, ln_bias, eps: float = 1e-12):
    """x [M, H]; wi [H, F]; bi [F]; wo [F, H]; bo, ln_scale, ln_bias [H].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 only) or raise."""
    if x.device.type == "cpu":
        return fused_ffn_ln_plain(x, wi, bi, wo, bo, ln_scale, ln_bias, eps)
    m, h = x.shape
    f = wi.shape[1]
    bf = torch.bfloat16
    for t, name, shape in ((x, "x", (m, h)), (wi, "wi", (h, f)), (bi, "bi", (f,)),
                           (wo, "wo", (f, h)), (bo, "bo", (h,)),
                           (ln_scale, "ln_scale", (h,)), (ln_bias, "ln_bias", (h,))):
        _build.require(t, name, bf, shape)
    if h % 64 or f % 64:
        raise ValueError(f"fused_ffn_ln: widths must be multiples of 64, got {h}, {f}")
    lib, s = _build.lib(), _build.stream(x)
    mid = torch.empty((m, f), dtype=bf, device=x.device)
    y = torch.empty((m, h), dtype=F32, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.mmdx_gemm_bf16(x.data_ptr(), wi.data_ptr(), bi.data_ptr(), None,
                                    mid.data_ptr(), m, f, h,
                                    _build.EPI_BIAS_GELU_BF16, s), "ffn_in")
    _build.check(lib.mmdx_gemm_bf16(mid.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                                    x.data_ptr(), y.data_ptr(), m, h, f,
                                    _build.EPI_BIAS_RESID_F32, s), "ffn_out")
    _build.check(lib.mmdx_layernorm_f32_bf16(y.data_ptr(), ln_scale.data_ptr(),
                                             ln_bias.data_ptr(), out.data_ptr(),
                                             m, h, eps, s), "ffn_ln")
    fused_ffn_ln.launches += 1
    return out


fused_ffn_ln.launches = 0
