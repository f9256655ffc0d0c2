"""Int8 GEMM with an f32 requant epilogue (K5): the int8 image tower's convs.

Port of ``mmdx_tpu/ops/pallas_int8_gemm.py`` (``int8_gemm_requant`` ``:113``,
``int8_gemm_res_requant`` ``:135``, ``int8_gemm_dual_requant`` ``:160``),
with the semantics of its kernel bodies (``:52-90``)::

    out = s8(clip(rint(relu?(acc*alpha + bias [+ res*rs]
                             [+ (acc2*alpha2 + bias2)]) / s_out), -127, 127))

``acc = x @ w`` is the exact s32 product of s8 operands. The f32 chain runs
in that order, with a divide by the output scale (not a multiply by its
reciprocal) and round-half-to-even, so the int8 outputs are bit-exact
against the Pallas functions and between the kernel and its plain version.

``int8_gemm_requant`` also takes a positional bias ``[P, N]`` (row ``r``
reads bias row ``r % P``): the gray stem's folded normalize is a map over the
output positions (``mmdx_tpu/models/resnet_int8.py:_gray_stem``).

Kernel (CUDA C++, ``csrc/int8_gemm.cu``): s8 tensor-core GEMM through
``wmma`` with s32 accumulators and the epilogue fused, one launch; the dual
form runs both products in one block and joins them in the epilogue. The
source notes what bounds it. It takes K in multiples of ``K_ALIGN`` = 16: the
int8 tower pads its stem weights with zero rows once, at quantization, and
its im2col emits the matching zero columns (the 7x7 RGB stem has K = 147).

CPU tensors take the plain version: a float64 matmul of the int8 operands
(exact, since every |sum| < 2^53; PyTorch has no CUDA int32 matmul) and the
same f32 epilogue. CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from mmdx_tpu_torch import _build

F32 = torch.float32
I8 = torch.int8
K_ALIGN = 16  # the kernel's k-step: one 16-byte s8 slab


def exact_matmul_s8(x, w) -> torch.Tensor:
    """The exact s32 product of s8 ``x [M, K]`` and ``w [K, N]``, as f32
    (what ``preferred_element_type=int32`` then ``astype(f32)`` gives)."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(F32)


def div_exact(a, s) -> torch.Tensor:
    """``a / s`` as a true f32 division. The divisor goes to ``a``'s device
    first: PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal, which moves a rounding."""
    return a / torch.as_tensor(s, dtype=F32, device=a.device)


def _requant(y, s_out) -> torch.Tensor:
    return torch.clamp(torch.round(div_exact(y, s_out)), -127, 127).to(I8)


def _add_bias(y, bias):
    """bias [N], or [P, N] positional (row r reads row r % P)."""
    if bias.dim() == 1:
        return y + bias
    p = bias.shape[0]
    return (y.reshape(-1, p, y.shape[-1]) + bias).reshape(y.shape)


def int8_gemm_requant_plain(x, w, alpha, bias, s_out, relu: bool = True):
    y = _add_bias(exact_matmul_s8(x, w) * alpha, bias)
    if relu:
        y = torch.relu(y)
    return _requant(y, s_out)


def int8_gemm_res_requant_plain(x, w, alpha, bias, res, res_scale, s_out,
                                relu: bool = True):
    y = exact_matmul_s8(x, w) * alpha + bias
    y = y + res.to(F32) * res_scale
    if relu:
        y = torch.relu(y)
    return _requant(y, s_out)


def int8_gemm_dual_requant_plain(x1, w1, alpha1, bias1, x2, w2, alpha2, bias2,
                                 s_out, relu: bool = True):
    p1 = exact_matmul_s8(x1, w1) * alpha1 + bias1
    p2 = exact_matmul_s8(x2, w2) * alpha2 + bias2
    y = p1 + p2
    if relu:
        y = torch.relu(y)
    return _requant(y, s_out)


def _check_gemm(x, w, name):
    m, k = x.shape
    n = w.shape[1]
    _build.require(x, f"{name}.x", I8, (m, k))
    _build.require(w, f"{name}.w", I8, (k, n))
    if n % 64:
        raise ValueError(f"{name}: N must be a multiple of 64, got {n}")
    if k % K_ALIGN:
        raise ValueError(f"{name}: K must be a multiple of {K_ALIGN} (zero-pad the "
                         f"columns of x and the rows of w), got {k}")
    return m, n, k


def _launch_requant(name, x, w, alpha, bias, s_out, relu, res=None, rs=0.0,
                    x2=None, w2=None, alpha2=None, bias2=None):
    m, n, k = _check_gemm(x, w, name)
    _build.require(alpha, f"{name}.alpha", F32, (n,))
    bias_rows = 0 if bias.dim() == 1 else bias.shape[0]
    _build.require(bias, f"{name}.bias", F32, (n,) if bias_rows == 0 else (bias_rows, n))
    if bias_rows and m % bias_rows:
        raise ValueError(f"{name}: {m} rows are not whole maps of {bias_rows} positions")
    k2 = 0
    if res is not None:
        _build.require(res, f"{name}.res", I8, (m, n))
    if x2 is not None:
        _, n2, k2 = _check_gemm(x2, w2, name)
        if x2.shape[0] != m or n2 != n:
            raise ValueError(f"{name}: second product {tuple(x2.shape)} x "
                             f"{tuple(w2.shape)} does not match [{m}, {n}]")
        _build.require(alpha2, f"{name}.alpha2", F32, (n,))
        _build.require(bias2, f"{name}.bias2", F32, (n,))
    out = torch.empty((m, n), dtype=I8, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(_build.lib().mmdx_int8_gemm_requant(
        x.data_ptr(), w.data_ptr(), alpha.data_ptr(), bias.data_ptr(), bias_rows,
        ptr(res), float(rs), ptr(x2), ptr(w2), ptr(alpha2), ptr(bias2), k2,
        float(s_out), int(relu), out.data_ptr(), m, n, k, _build.stream(x)), name)
    return out


def int8_gemm_requant(x, w, alpha, bias, s_out, relu: bool = True):
    """x s8 [M, K]; w s8 [K, N]; alpha f32 [N] (= in_scale * w_scale); bias
    f32 [N] or positional [P, N]; s_out the output scale. -> s8 [M, N]."""
    if x.device.type == "cpu":
        return int8_gemm_requant_plain(x, w, alpha, bias, s_out, relu)
    out = _launch_requant("int8_gemm_requant", x, w, alpha, bias, s_out, relu)
    int8_gemm_requant.launches += 1
    return out


def int8_gemm_res_requant(x, w, alpha, bias, res, res_scale, s_out,
                          relu: bool = True):
    """As ``int8_gemm_requant`` plus the s8 residual ``res [M, N]`` at
    ``res_scale``: requant(relu((x@w*alpha + bias) + res*res_scale))."""
    if x.device.type == "cpu":
        return int8_gemm_res_requant_plain(x, w, alpha, bias, res, res_scale,
                                           s_out, relu)
    out = _launch_requant("int8_gemm_res_requant", x, w, alpha, bias, s_out, relu,
                          res=res, rs=res_scale)
    int8_gemm_res_requant.launches += 1
    return out


def int8_gemm_dual_requant(x1, w1, alpha1, bias1, x2, w2, alpha2, bias2, s_out,
                           relu: bool = True):
    """Two GEMMs meeting in one epilogue: requant(relu((x1@w1*a1 + b1) +
    (x2@w2*a2 + b2)))."""
    if x1.device.type == "cpu":
        return int8_gemm_dual_requant_plain(x1, w1, alpha1, bias1, x2, w2, alpha2,
                                            bias2, s_out, relu)
    out = _launch_requant("int8_gemm_dual_requant", x1, w1, alpha1, bias1, s_out,
                          relu, x2=x2, w2=w2, alpha2=alpha2, bias2=bias2)
    int8_gemm_dual_requant.launches += 1
    return out


int8_gemm_requant.launches = 0
int8_gemm_res_requant.launches = 0
int8_gemm_dual_requant.launches = 0
WRAPPERS = (int8_gemm_requant, int8_gemm_res_requant, int8_gemm_dual_requant)


def launches() -> int:
    """K5 launches: the three wrappers together."""
    return sum(fn.launches for fn in WRAPPERS)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# the shared core with dequantizing epilogues (K6, K7 call it directly)
# ---------------------------------------------------------------------------
def gemm_dequant(x_i8, w_i8, row_scale, col_scale, bias, resid, out_dtype, epi: int):
    """One launch of the int8 core: ``epi`` of ``acc * (row_scale[r] *
    col_scale[c])`` with bias (bf16 [N]) and resid (bf16 [M, N] or None)
    into a new [M, N] tensor of ``out_dtype``. CUDA tensors only."""
    m, n, k = _check_gemm(x_i8, w_i8, "int8_gemm_dequant")
    _build.require(row_scale, "row_scale", F32, (m,))
    _build.require(col_scale, "col_scale", F32, (n,))
    _build.require(bias, "bias", torch.bfloat16, (n,))
    if resid is not None:
        _build.require(resid, "resid", torch.bfloat16, (m, n))
    out = torch.empty((m, n), dtype=out_dtype, device=x_i8.device)
    _build.check(_build.lib().mmdx_int8_gemm_dequant(
        x_i8.data_ptr(), w_i8.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr(),
        bias.data_ptr(), None if resid is None else resid.data_ptr(), out.data_ptr(),
        m, n, k, epi, _build.stream(x_i8)), "int8_gemm_dequant")
    return out


def quant_rows_launch(x):
    """The row-quantize kernel: x [M, H] bf16/f32 (CUDA) -> (s8 [M, H], f32 [M])."""
    m, h = x.shape
    fn = {torch.bfloat16: "mmdx_quant_rows_bf16", F32: "mmdx_quant_rows_f32"}.get(x.dtype)
    if fn is None:
        raise ValueError(f"quant_rows: expected bf16 or f32, got {x.dtype}")
    _build.require(x, "quant_rows.x", x.dtype, (m, h))
    q = torch.empty((m, h), dtype=I8, device=x.device)
    s = torch.empty((m,), dtype=F32, device=x.device)
    _build.check(getattr(_build.lib(), fn)(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                           m, h, _build.stream(x)), "quant_rows")
    return q, s
