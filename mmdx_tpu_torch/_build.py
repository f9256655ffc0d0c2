"""Build and bind the port's hand-written CUDA kernels.

Every ``mmdx_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, which is loaded
with ``ctypes``. The library is built at first use into
``mmdx_tpu_torch/_build/`` (git-ignored) under a name keyed on a hash of the
sources, so an edited source rebuilds and a fresh checkout builds by itself.
The link needs no ``libcuda``: the one driver-API call, the TMA kernels'
``cuTensorMapEncodeTiled`` (TMA descriptors), is resolved at run time
through ``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``).

Each entry point enqueues one kernel on the stream it is given and returns
the launch's ``cudaError_t``; :func:`check` turns a nonzero code into an
exception. There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    # A, B, bias, resid, C, M, N, K, epilogue, bm, bn, stages, splits, stream
    "mmdx_gemm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # y, splits, bias, resid, gamma, beta, out, M, H, eps, stream
    "mmdx_layernorm_f32_bf16": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # qkv, kmask, ctx, B, L, H, heads, query tile, scale, stream
    "mmdx_bert_attn": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, kv, mask, bias, acc, m, l, B, nb, K, heads, head_dim, ranks, stream
    "mmdx_beam_attn_partial": [_P] * 7 + [_I] * 6 + [_P],
    # q, kv, mask, bias, ctx, B, nb, K, heads, head_dim, ranks, stream
    "mmdx_beam_attn": [_P] * 5 + [_I] * 6 + [_P],
    # q, kv, kvs, mask, bias, ctx, B, nb, K, heads, head_dim, ranks, stream
    "mmdx_beam_attn_int8": [_P] * 6 + [_I] * 6 + [_P],
    # emb [V, D] bf16, V, D, map (128 bytes out)
    "mmdx_lm_head_emb_map": [_P, _I, _I, _P],
    # hidden, emb's map, mask, cmax, carg, N, V, D, warpgroups, stages, stream
    "mmdx_lm_head_greedy": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # hidden, emb's map, mask, logits, cmax, m, L, workspace, N, V, D,
    # warpgroups, stages, stream
    "mmdx_lm_head_stats": [_P] * 8 + [_I] * 5 + [_P],
    # hidden, cross_ln, wq, wo_c, ck, cv, enc_bias, ffn_ln, wi, wo_f, y, ctx,
    # x, hmid, out, ws, N, D, F, KK, heads, eps, blocks, sq, so, si, sf, stream
    "mmdx_t5_cross_ffn": [_P] * 16 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # qkv, kmask, ctx (f32), B, L, H, heads, query tile, scale, stream
    "mmdx_bert_attn_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # B (K-major s8 [N, K]), N, K, bn, map (128 bytes out)
    "mmdx_int8_weight_map": [_P, _I, _I, _I, _P],
    # A, B's map, alpha, bias, bias_rows, res, rs, A2, B2's map, alpha2,
    # bias2, K2, s_out, relu, C, M, N, K, bm, bn, stages, stream
    "mmdx_int8_gemm_requant": [_P, _P, _P, _P, _I, _P, _F, _P, _P, _P, _P, _I,
                               _F, _I, _P, _I, _I, _I, _I, _I, _I, _P],
    # A, B's map, row_scale, col_scale, bias, resid, C, M, N, K, epilogue,
    # bm, bn, stages, stream
    "mmdx_int8_gemm_dequant": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P],
    # x, q, scale, M, H, stream
    "mmdx_quant_rows_bf16": [_P, _P, _P, _I, _I, _P],
    "mmdx_quant_rows_f32": [_P, _P, _P, _I, _I, _P],
    # q, k, v, bias, out, strides (q, k, v: b h l; bias: b h q k; out: b h l),
    # B, H, Lq, Lk, Lk_pad, scale, is_bf16, stream
    "mmdx_flash_attn": [_P] * 5 + [_L] * 16 + [_I] * 5 + [_F, _I, _P],
    # the same without is_bf16 (bf16 only, tensor cores)
    "mmdx_flash_attn_tc": [_P] * 5 + [_L] * 16 + [_I] * 5 + [_F, _P],
    # x, w1, ld1, k1, b1, w2, ld2, k2, b2, w3, ld3, k3, b3, kx, out, B, H, W,
    # C, M, TR, stream (weights K-major, row pitches in elements)
    "mmdx_int8_bottleneck": [_P, _P, _L, _P, _P, _P, _L, _P, _P, _P, _L, _P, _P, _F, _P]
                            + [_I] * 6 + [_P],
    # x, w1, b1, w2, b2, w3, b3, wp, bp, out, B, H, W, Cin, M, Cout, TR,
    # stream (f32)
    "mmdx_bottleneck": [_P] * 10 + [_I] * 7 + [_P],
    # x, w1, ld1, b1, w2, ld2, b2, w3, ld3, b3, wp, ldp, bp, out, B, H, W,
    # Cin, M, Cout, TR, stream (bf16, weights K-major)
    "mmdx_bottleneck_tc": [_P, _P, _L, _P, _P, _L, _P, _P, _L, _P, _P, _L, _P, _P]
                          + [_I] * 7 + [_P],
    # img, hstart, hcoef, wstart, wcoef, out, B, H, W, C, crop, Th, Tw, w0,
    # span, TRo, blocks, grid, io_off, io_bytes, smem, out_bf16, scale[3],
    # shift[3], stream
    "mmdx_preprocess": [_P] * 6 + [_I] * 16 + [_F] * 6 + [_P],
    # smem, out_bf16, blocks, held (int out)
    "mmdx_preprocess_blocks_per_sm": [_I, _I, _I, _P],
}

# GEMM epilogues (csrc/gemm.cu enum Epilogue)
EPI_BIAS_BF16 = 1
EPI_BIAS_GELU_BF16 = 2
EPI_BIAS_RESID_F32 = 3
EPI_PARTIAL_F32 = 4     # f32 split-K partials [splits, M, N], summed by the LayerNorm

# int8 GEMM dequantizing epilogues (csrc/int8_gemm.cu mmdx_int8_gemm_dequant)
DQ_BF16 = 0             # bf16(acc*sc + bias)
DQ_GELU_TANH_F32 = 1    # f32(gelu_tanh(acc*sc + bias))
DQ_BIAS_RESID_F32 = 2   # f32((acc*sc + bias) + resid)
DQ_RESID_BIAS_F32 = 3   # f32((resid + acc*sc) + bias)

_LIB = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from mmdx_tpu_torch/csrc")
    return found


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed shared library; return its path.

    One nvcc per source, all started together, then one link."""
    so = BUILD_DIR / f"libmmdx_kernels_{source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f".{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc(), *flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    tmp = BUILD_DIR / f".{tag}.so"
    proc = subprocess.run([nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as a raw pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``, 16-byte aligned for the kernels' vector loads."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")
