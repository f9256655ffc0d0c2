"""Fused BERT feed-forward block: ``LayerNorm(x + gelu_erf(x Wi + bi) Wo + bo)``,
and its W8A8 form with tanh-GELU.

Port of ``mmdx_tpu/ops/pallas_ffn.py``: ``fused_ffn_ln`` (K2, below) and
``fused_ffn_ln_int8`` with its quantizers ``quant_rows`` and
``quant_weight_cols`` (K6, at the end of the module).

K2 kernel (CUDA C++, ``csrc/gemm.cu`` through ``ops/gemm.py``), three
launches:

1. ``mid = bf16(gelu_erf(x @ Wi + bi))`` — the wgmma GEMM with the bias +
   exact-erf GELU epilogue (``erff``; the Pallas body used an
   Abramowitz-Stegun erf only because Mosaic has no erf);
2. ``mid @ Wo`` — the same GEMM, into f32 ``(acc + bo) + x`` rows, or, where
   ``gemm_plan`` splits K to fill the SMs (M below ~700: one request, B=4),
   into f32 partials [splits, M, H] without bias;
3. ``out = bf16(LayerNorm(y))`` — one warp per 768-wide row, f32
   statistics; with partials it first sums them in split order, then adds
   ``bo``, then ``x``.

What bounds it on the H100: FLOPs at the classify rows. At B*L = 3072 the
two products are 2 x 3072 x 768 x 3072 MACs (29 GFLOP, 29 us at 989
TFLOP/s) against ~75 MB moved as built (~30 MB if fused), above the card's
~295 FLOP/byte break-even either way; at one request's rows the 9.4 MB of
weights (2.8 us at 3.35 TB/s). The GEMM is ``wgmma`` on TMA-fed stages
(``csrc/gemm.cu``), tiled by ``ops/gemm.py:gemm_plan`` for each M. The
[rows, 3072] GELU intermediate, which the TPU kernel kept in VMEM, goes
through device memory here (bf16 scratch from ``torch.empty``, 18 MB at
3072 rows); so does the f32 pre-LayerNorm row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.ops import gemm
from mmdx_tpu_torch.ops.gemm import layer_norm_f32

F32 = torch.float32


def fused_ffn_ln_plain(x, wi, bi, wo, bo, ln_scale, ln_bias, eps: float = 1e-12,
                       group=None):
    """Plain PyTorch version with the Pallas body's rounding points: f32
    products of the working-dtype operands, GELU output rounded to x.dtype;
    with ``group``, the second product's f32 partials summed over it."""
    dt = x.dtype
    mid = x.to(F32) @ wi.to(F32) + bi.to(F32)
    mid = F.gelu(mid).to(dt)
    y = gemm.row_parallel_f32(mid, wo, group) + bo.to(F32) + x.to(F32)
    return layer_norm_f32(y, ln_scale, ln_bias, eps).to(dt)


def fused_ffn_ln(x, wi, bi, wo, bo, ln_scale, ln_bias, eps: float = 1e-12, group=None):
    """x [M, H]; wi [H, F]; bi [F]; wo [F, H]; bo, ln_scale, ln_bias [H],
    where under tensor parallelism (``group``, the "model" group) F is this
    rank's share of the intermediate: its columns of ``wi`` and rows of
    ``wo``, whose f32 partials are summed over the group before the
    LayerNorm (``gemm.residual_gemm_ln``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 only) or raise."""
    if x.device.type == "cpu":
        return fused_ffn_ln_plain(x, wi, bi, wo, bo, ln_scale, ln_bias, eps, group)
    m, h = x.shape
    f = wi.shape[1]
    bf = torch.bfloat16
    for t, name, shape in ((x, "x", (m, h)), (wi, "wi", (h, f)), (bi, "bi", (f,)),
                           (wo, "wo", (f, h)), (bo, "bo", (h,)),
                           (ln_scale, "ln_scale", (h,)), (ln_bias, "ln_bias", (h,))):
        _build.require(t, name, bf, shape)
    if h % 64 or f % 64:
        raise ValueError(f"fused_ffn_ln: widths must be multiples of 64, got {h}, {f}")
    mid = torch.empty((m, f), dtype=bf, device=x.device)
    gemm.gemm(x, wi, bi, None, mid, _build.EPI_BIAS_GELU_BF16,
              gemm.gemm_plan(m, f, h, gemm.sms_of(x)), "ffn_in")
    out = gemm.residual_gemm_ln(mid, wo, bo, x, ln_scale, ln_bias, eps, "ffn_out", group)
    fused_ffn_ln.launches += 1
    if group is not None:
        fused_ffn_ln.tp_launches += 1
    return out


fused_ffn_ln.launches = 0
fused_ffn_ln.tp_launches = 0  # of them, in the tensor-parallel form


# ---------------------------------------------------------------------------
# K6: the W8A8 FFN block (turbo tier)
# ---------------------------------------------------------------------------
def quant_rows(x):
    """Per-row symmetric int8 quantization (``pallas_ffn._quant_rows``):
    s = max(amax_row, 1e-12) / 127, q = clip(round(x / s), -127, 127).
    -> (s8 [M, H], f32 [M] scales). Plain PyTorch on any device: the plain
    versions use it, the kernels launch ``int8_gemm.quant_rows_launch``."""
    from mmdx_tpu_torch.ops.int8_gemm import div_exact

    xf = x.to(F32)
    s = div_exact(torch.clamp_min(xf.abs().amax(-1), 1e-12), 127.0)
    q = torch.clamp(torch.round(xf / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def quant_weight_cols(w):
    """Per-output-column symmetric int8 weights (``pallas_ffn.quant_weight_cols``):
    w [in, out] -> (s8 [out, in] K-major and contiguous, f32 [out] scales),
    from ``w`` as given (the JAX blocks quantize the weights cast to the
    model dtype). The JAX function's s8 [in, out] is this tensor's ``.T``:
    the int8 GEMM's ``wgmma`` reads 8-bit weights K-major only, so they are
    laid out so once, here."""
    from mmdx_tpu_torch.ops.int8_gemm import div_exact

    wf = w.to(F32)
    ws = div_exact(torch.clamp_min(wf.abs().amax(0), 1e-12), 127.0)
    q = torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8)
    return q.T.contiguous(), ws


def gelu_tanh(x):
    """torch/HF "gelu_new" in the evaluation order of ``pallas_ffn._gelu_tanh``."""
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def fused_ffn_ln_int8_plain(x, wi_i8, wis, bi, wo_i8, wos, bo, ln_scale, ln_bias,
                            eps: float = 1e-12):
    """Plain PyTorch version of ``_ffn_kernel_int8`` (``pallas_ffn.py:79-112``):
    exact s32 products, f32 dequant/GELU/residual/LayerNorm."""
    from mmdx_tpu_torch.ops.int8_gemm import gemm_dequant_plain

    xi, sx = quant_rows(x.to(F32))
    mid = gemm_dequant_plain(xi, wi_i8, sx, wis, bi, None, F32, _build.DQ_GELU_TANH_F32)
    mi, sm = quant_rows(mid)
    y = gemm_dequant_plain(mi, wo_i8, sm, wos, bo, x, F32, _build.DQ_BIAS_RESID_F32)
    return layer_norm_f32(y, ln_scale, ln_bias, eps).to(x.dtype)


def fused_ffn_ln_int8(x, wi_i8, wis, bi, wo_i8, wos, bo, ln_scale, ln_bias,
                      eps: float = 1e-12):
    """W8A8 FFN block, ``fused_ffn_ln_int8`` with the weights quantized once
    by ``quant_weight_cols``: x [M, H]; wi_i8 s8 [F, H] (K-major), wis f32
    [F]; bi [F]; wo_i8 s8 [H, F], wos f32 [H]; bo, ln_scale, ln_bias [H].

    Kernel (CUDA C++, ``csrc/int8_gemm.cu`` + ``csrc/gemm.cu``), five
    launches: row-quantize x; the int8 core with the dequant + bias +
    tanh-GELU epilogue into f32 [M, F]; row-quantize that; the int8 core with
    the dequant + bias + residual epilogue into f32 [M, H]; the LayerNorm
    kernel. What bounds it on the H100: int8 operations at the serving rows
    (2 x M x 768 x 3072 MACs at 1,979 TOP/s); the f32 [M, 3072] GELU output,
    which the TPU kernel kept in VMEM, goes through device memory here and
    is read twice (amax, then quantize), so bytes bound it as built.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    (bf16 x) or raise."""
    if x.device.type == "cpu":
        return fused_ffn_ln_int8_plain(x, wi_i8, wis, bi, wo_i8, wos, bo, ln_scale,
                                       ln_bias, eps)
    from mmdx_tpu_torch.ops.int8_gemm import gemm_dequant, quant_rows_launch

    m, h = x.shape
    bf = torch.bfloat16
    for t, name, shape in ((x, "x", (m, h)), (bo, "bo", (h,)),
                           (ln_scale, "ln_scale", (h,)), (ln_bias, "ln_bias", (h,))):
        _build.require(t, name, bf, shape)
    xi, sx = quant_rows_launch(x)
    mid = gemm_dequant(xi, wi_i8, sx, wis, bi, None, F32, _build.DQ_GELU_TANH_F32)
    mi, sm = quant_rows_launch(mid)
    y = gemm_dequant(mi, wo_i8, sm, wos, bo, x, F32, _build.DQ_BIAS_RESID_F32)
    out = torch.empty_like(x)
    gemm.layer_norm(y, ln_scale, ln_bias, out, eps, "ffn_int8_ln")
    fused_ffn_ln_int8.launches += 1
    return out


fused_ffn_ln_int8.launches = 0
