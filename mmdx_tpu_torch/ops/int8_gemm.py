"""Int8 GEMM with an f32 requant epilogue (K5): the int8 image tower's convs.

Port of ``mmdx_tpu/ops/pallas_int8_gemm.py`` (``int8_gemm_requant`` ``:113``,
``int8_gemm_res_requant`` ``:135``, ``int8_gemm_dual_requant`` ``:160``),
with the semantics of its kernel bodies (``:52-90``)::

    out = s8(clip(rint(relu?(acc*alpha + bias [+ res*rs]
                             [+ (acc2*alpha2 + bias2)]) / s_out), -127, 127))

``acc = x @ w.T`` is the exact s32 product of s8 operands (``w [N, K]``).
The f32 chain runs in that order, with a divide by the output scale (not a
multiply by its reciprocal; the kernel takes the division's bits from a
multiply and divides only near a tie) and round-half-to-even, so the int8
outputs are bit-exact against the Pallas functions and between the kernel
and its plain version.

``int8_gemm_requant`` also takes a positional bias ``[P, N]`` (row ``r``
reads bias row ``r % P``): the gray stem's folded normalize is a map over the
output positions (``mmdx_tpu/models/resnet_int8.py:_gray_stem``).

Kernel (CUDA C++, ``csrc/int8_gemm.cu``): s8 ``wgmma`` (warpgroup MMAs,
s32 accumulators) fed by TMA, with the epilogue fused, one launch; the dual
form streams both products through one ring and joins them in the
epilogue. The source notes what bounds it. ``wgmma`` has no transpose for
8-bit operands, so every weight is K-major, ``w [N, K]`` with K contiguous,
laid out once where it is quantized or imported (``models/resnet_int8.py:
gemm_weight``, ``fused_ffn.quant_weight_cols``, ``checkpoints/bridge.py:
qparams_from_jax``); the plain versions read the same tensor transposed.
The weight's TMA descriptor is encoded once per (weight, tile width) and
cached (``weight_map``); only the activations' is encoded per call. The
tile plan is ``int8_gemm_plan``, computed here so the CPU tests see what the
card runs, and ``tile_walk_s32`` emulates the kernel's walk over it. K is
taken in multiples of ``K_ALIGN`` = 16, TMA's 16-byte row-stride rule: the
int8 tower pads its stem weights with zero columns once, at quantization,
and its im2col emits the matching zero columns (the 7x7 RGB stem has K =
147); the last 128-deep box of a product reads zeros past the real K.

CPU tensors take the plain version: a float64 matmul of the int8 operands
(exact, since every |sum| < 2^53; PyTorch has no CUDA int32 matmul) and the
same f32 epilogue. CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.ops.gemm import sms_of

F32 = torch.float32
I8 = torch.int8
K_ALIGN = 16      # TMA's row-stride rule: rows of 16-byte multiples
BK = 128          # K step: one 128-byte swizzle row of s8, four k32 MMAs
MAX_STAGES = 4
STAGE_BUDGET = 96 * 1024  # shared memory for a block's ring: two blocks to an SM
MAX_SMEM = 232448         # a block's dynamic shared memory on sm_90
H100_SMS = 132
MAP_BYTES = 128           # sizeof(CUtensorMap)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def exact_matmul_s8(x, w) -> torch.Tensor:
    """The exact s32 product of s8 ``x [M, K]`` and ``w [K, N]``, as f32
    (what ``preferred_element_type=int32`` then ``astype(f32)`` gives). The
    K-major weights ``w_t [N, K]`` of this module go in as ``w_t.T``."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(F32)


# ---------------------------------------------------------------------------
# the tile plan, and the kernel's walk over it
# ---------------------------------------------------------------------------
def smem_bytes(bm: int, bn: int, stages: int, products: int = 1) -> int:
    """A block's dynamic shared memory (``csrc/int8_gemm.cu:smem_bytes``):
    the ring of stages or the s32 staging tiles (one per product), whichever
    is larger, 1 KB of alignment slack, two mbarriers a stage."""
    ring = stages * (bm + bn) * BK
    staging = products * bm * (bn * 4 + 16)
    return max(ring, staging) + 1024 + 2 * stages * 8


def int8_gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS,
                   k2: int = 0) -> tuple[int, int, int]:
    """(bm, bn, stages) for ``[m, k] x [n, k]^T`` (and, with ``k2``, the
    dual epilogue's second product) on ``sms`` SMs.

    bm is 64 or 128 (one or two 64-row consumer warpgroups), bn 128 or 64
    dividing n (64 for the dual epilogue, whose two s32 tiles share the
    registers): 128 x 128 tiles where they alone fill the SMs, else 64-row
    tiles, 64 columns wide if that is what fills them; stages fill the ring's
    budget (two blocks to an SM), at most the K steps. Raises unless n is a
    multiple of 64 and k (and k2) of ``K_ALIGN``."""
    if m <= 0 or n <= 0 or n % 64 or k <= 0 or k % K_ALIGN or k2 < 0 or k2 % K_ALIGN:
        raise ValueError(f"int8_gemm_plan: unsupported shape m={m} n={n} k={k} k2={k2} "
                         f"(n must be a multiple of 64, k of {K_ALIGN})")
    bn = 128 if n % 128 == 0 and not k2 else 64
    bm = 128 if cdiv(m, 128) * (n // bn) >= sms else 64
    if cdiv(m, bm) * (n // bn) < sms:
        bn = 64
    steps = cdiv(k, BK) + cdiv(k2, BK)
    ring = STAGE_BUDGET // ((bm + bn) * BK)
    stages = max(2, min(MAX_STAGES, ring, steps))
    return bm, bn, stages


def tile_walk_s32(x, w_t, plan) -> torch.Tensor:
    """The kernel's s32 product on the CPU, walked as the card walks it:
    ``x [M, K]`` and ``w_t [N, K]`` s8 cut into the plan's [bm, 128] and
    [bn, 128] boxes, each box zero past M, N's tile and K (TMA's fill), and
    each box's k32 steps that hold real K summed in order into the tile's
    s32 accumulators. -> int32 [M, N]."""
    bm, bn, _ = plan
    m, k = x.shape
    n = w_t.shape[0]
    if n % bn:
        raise ValueError(f"tile_walk_s32: N={n} is not whole tiles of {bn}")
    out = torch.empty((m, n), dtype=torch.int32)
    for m0 in range(0, m, bm):
        for n0 in range(0, n, bn):
            acc = torch.zeros((bm, bn), dtype=torch.int64)
            for kc in range(0, k, BK):
                a = torch.zeros((bm, BK), dtype=torch.int64)
                b = torch.zeros((bn, BK), dtype=torch.int64)
                rows, depth = min(bm, m - m0), min(BK, k - kc)
                a[:rows, :depth] = x[m0:m0 + rows, kc:kc + depth]
                b[:, :depth] = w_t[n0:n0 + bn, kc:kc + depth]
                for kk in range(0, cdiv(depth, 32) * 32, 32):
                    acc += a[:, kk:kk + 32] @ b[:, kk:kk + 32].T
            out[m0:m0 + bm, n0:n0 + bn] = acc[:min(bm, m - m0)].to(torch.int32)
    return out


@functools.lru_cache(maxsize=4096)
def _weight_map(ptr: int, n: int, k: int, bn: int):
    buf = (ctypes.c_ubyte * MAP_BYTES)()
    _build.check(_build.lib().mmdx_int8_weight_map(ptr, n, k, bn, ctypes.addressof(buf)),
                 "int8_weight_map")
    return buf


def weight_map(w_t, bn: int) -> int:
    """The host address of the TMA descriptor of the K-major weight ``w_t
    [N, K]`` in boxes of [bn, 128], encoded at its first use and kept: a
    descriptor holds only the address, the shape and the box, so one key of
    those four always names the same descriptor."""
    n, k = w_t.shape
    return ctypes.addressof(_weight_map(w_t.data_ptr(), n, k, bn))


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
    y = _add_bias(exact_matmul_s8(x, w.T) * alpha, bias)
    if relu:
        y = torch.relu(y)
    return _requant(y, s_out)


def int8_gemm_res_requant_plain(x, w, alpha, bias, res, res_scale, s_out,
                                relu: bool = True):
    y = exact_matmul_s8(x, w.T) * alpha + bias
    y = y + res.to(F32) * res_scale
    if relu:
        y = torch.relu(y)
    return _requant(y, s_out)


def int8_gemm_dual_requant_plain(x1, w1, alpha1, bias1, x2, w2, alpha2, bias2,
                                 s_out, relu: bool = True):
    p1 = exact_matmul_s8(x1, w1.T) * alpha1 + bias1
    p2 = exact_matmul_s8(x2, w2.T) * alpha2 + bias2
    y = p1 + p2
    if relu:
        y = torch.relu(y)
    return _requant(y, s_out)


def _check_gemm(x, w, name):
    m, k = x.shape
    n = w.shape[0]
    _build.require(x, f"{name}.x", I8, (m, k))
    _build.require(w, f"{name}.w (K-major [N, K])", I8, (n, k))
    if n % 64:
        raise ValueError(f"{name}: N must be a multiple of 64, got {n}")
    if k % K_ALIGN:
        raise ValueError(f"{name}: K must be a multiple of {K_ALIGN} (zero-pad the "
                         f"columns of x and of w), got {k}")
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
                             f"{tuple(w2.shape)}^T does not match [{m}, {n}]")
        _build.require(alpha2, f"{name}.alpha2", F32, (n,))
        _build.require(bias2, f"{name}.bias2", F32, (n,))
    bm, bn, stages = int8_gemm_plan(m, n, k, sms_of(x), k2)
    out = torch.empty((m, n), dtype=I8, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(_build.lib().mmdx_int8_gemm_requant(
        x.data_ptr(), weight_map(w, bn), alpha.data_ptr(), bias.data_ptr(), bias_rows,
        ptr(res), float(rs), ptr(x2), None if w2 is None else weight_map(w2, bn),
        ptr(alpha2), ptr(bias2), k2, float(s_out), int(relu), out.data_ptr(), m, n, k,
        bm, bn, stages, _build.stream(x)), name)
    return out


def int8_gemm_requant(x, w, alpha, bias, s_out, relu: bool = True):
    """x s8 [M, K]; w s8 [N, K] (K-major); alpha f32 [N] (= in_scale *
    w_scale); bias f32 [N] or positional [P, N]; s_out the output scale.
    -> s8 [M, N]."""
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
def gemm_dequant_plain(x_i8, w_i8, row_scale, col_scale, bias, resid, out_dtype,
                       epi: int):
    """Plain version of one ``gemm_dequant`` launch, the f32 chain of the
    kernel's epilogue in its order over ``exact_matmul_s8``: ``acc *
    (row_scale[r] * col_scale[c])``, then bias (and resid) as ``epi`` says,
    then ``out_dtype`` (``DQ_BF16`` names the cast of K7's qkv, which the
    plain blocks also take at f32)."""
    y = exact_matmul_s8(x_i8, w_i8.T) * (row_scale[:, None] * col_scale)
    b = bias.to(F32)
    if epi == _build.DQ_BF16:
        out = y + b
    elif epi == _build.DQ_GELU_TANH_F32:
        from mmdx_tpu_torch.ops.fused_ffn import gelu_tanh

        out = gelu_tanh(y + b)
    elif epi == _build.DQ_BIAS_RESID_F32:
        out = (y + b) + resid.to(F32)
    elif epi == _build.DQ_RESID_BIAS_F32:
        out = (resid.to(F32) + y) + b
    else:
        raise ValueError(f"gemm_dequant: unknown epilogue {epi}")
    return out.to(out_dtype)


def gemm_dequant(x_i8, w_i8, row_scale, col_scale, bias, resid, out_dtype, epi: int):
    """One launch of the int8 core: ``epi`` of ``acc * (row_scale[r] *
    col_scale[c])``, ``acc = x_i8 [M, K] @ w_i8.T`` for the K-major weight
    ``w_i8 [N, K]``, with bias (bf16 [N]) and resid (bf16 [M, N] or None)
    into a new [M, N] tensor of ``out_dtype``. CUDA tensors only."""
    m, n, k = _check_gemm(x_i8, w_i8, "int8_gemm_dequant")
    _build.require(row_scale, "row_scale", F32, (m,))
    _build.require(col_scale, "col_scale", F32, (n,))
    _build.require(bias, "bias", torch.bfloat16, (n,))
    if resid is not None:
        _build.require(resid, "resid", torch.bfloat16, (m, n))
    bm, bn, stages = int8_gemm_plan(m, n, k, sms_of(x_i8))
    out = torch.empty((m, n), dtype=out_dtype, device=x_i8.device)
    _build.check(_build.lib().mmdx_int8_gemm_dequant(
        x_i8.data_ptr(), weight_map(w_i8, bn), row_scale.data_ptr(), col_scale.data_ptr(),
        bias.data_ptr(), None if resid is None else resid.data_ptr(), out.data_ptr(),
        m, n, k, epi, bm, bn, stages, _build.stream(x_i8)), "int8_gemm_dequant")
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
