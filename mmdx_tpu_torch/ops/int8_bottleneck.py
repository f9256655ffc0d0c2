"""Fused int8 stride-1 identity bottleneck (Queue 2 row 13).

Port of ``mmdx_tpu/ops/pallas_int8_bottleneck.py``: ``fused_bottleneck_int8``
(``:127``, body ``_kernel`` ``:50-124``) and ``fold_block_epilogues``
(``:203-221``). For s8 NHWC ``x`` at the block's input scale::

    a1  = q(relu(x @ w1 * k1 + b1))
    a2  = q(relu(im2col_3x3_same(a1) @ w2flat * k2 + b2))   # K = 9M
    out = q(relu(a2 @ w3 * k3 + b3 + x * kx))

with ``q(y) = s8(clip(round_half_even(y), -127, 127))``, every product an
exact s32 sum and each f32 step in the Pallas body's order: the kernel, the
plain version and the Pallas function agree bit for bit. ``k*``/``b*``/``kx``
are the folded requant multipliers of ``fold_block_epilogues`` (no divide in
the kernel). The TPU kernel's width-padded flat layout (``pad_wp``/
``unpad_wp``) and its g images per program are sublane fixes; here the
layout is plain NHWC, and the tests convert between the two.

Kernel (CUDA C++, ``csrc/int8_bottleneck.cu``), one launch: the implicit
GEMM of ``csrc/implicit_gemm.cuh`` (shared with row 12) on the tensor cores,
s8 MMAs with s32 accumulators. A block per (image, band of output rows) runs
conv1 over the band and its halo rows into a shared-memory tile, the 3x3
conv as nine shifted views of that tile (no im2col), and conv3 with the
shortcut and the final requant; a1 and a2 stay in shared memory. The
weights are read K-major in place: ``w1 [C, M]``, ``w2flat [9M, M]`` and
``w3 [M, C]`` are the transposed views of the qparams' GEMM operands
(``"wk"`` [co, K]), which ``fold_block_epilogues`` hands out without a
copy. ``ops/bottleneck.tc_plan`` picks the band height;
``band_walk_int8`` walks the kernel's order on the CPU for the tests.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.ops.bottleneck import band_walk, kmajor_ld, tc_plan
from mmdx_tpu_torch.ops.int8_gemm import div_exact, exact_matmul_s8

F32 = torch.float32
I8 = torch.int8


def _q(y) -> torch.Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(I8)


def taps3x3(a) -> torch.Tensor:
    """NHWC [B, H, W, M] -> [B*H*W, 9M]: the SAME-padded 3x3 neighbourhood of
    each pixel in (ky, kx, channel) order, the rows of ``w2flat``."""
    b, h, w, m = a.shape
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    taps = [ap[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=3).reshape(b * h * w, 9 * m)


def fused_bottleneck_int8_plain(x, w1, k1, b1, w2flat, k2, b2, w3, k3, b3, kx):
    """Plain PyTorch version (exact s32 products as f64 matmuls)."""
    b, h, w, c = x.shape
    m = w1.shape[1]
    xf = x.reshape(-1, c)
    a1 = _q(torch.relu(exact_matmul_s8(xf, w1) * k1 + b1)).reshape(b, h, w, m)
    a2 = _q(torch.relu(exact_matmul_s8(taps3x3(a1), w2flat) * k2 + b2))
    y = exact_matmul_s8(a2, w3) * k3 + b3 + xf.to(F32) * torch.tensor(kx, dtype=F32)
    return _q(torch.relu(y)).reshape(b, h, w, c)


def fused_bottleneck_int8(x, w1, k1, b1, w2flat, k2, b2, w3, k3, b3, kx):
    """x s8 [B, H, W, C] at the block's input scale; w1 s8 [C, M], w2flat
    s8 [9M, M] ((ky, kx, ci) tap-major), w3 s8 [M, C] (on the card: views of
    K-major storage, ``[M, C]``, ``[M, 9M]``, ``[C, M]`` rows with K
    contiguous, as ``fold_block_epilogues`` gives them); k1, b1, k2, b2 f32
    [M]; k3, b3 f32 [C]; kx the f32 shortcut fold -> s8 [B, H, W, C] at the
    block's output scale."""
    if x.device.type == "cpu":
        return fused_bottleneck_int8_plain(x, w1, k1, b1, w2flat, k2, b2, w3, k3, b3, kx)
    b, h, w, c = x.shape
    m = w1.shape[1]
    for t, name, dtype, shape in (
            (x, "x", I8, (b, h, w, c)), (k1, "k1", F32, (m,)), (b1, "b1", F32, (m,)),
            (k2, "k2", F32, (m,)), (b2, "b2", F32, (m,)), (k3, "k3", F32, (c,)),
            (b3, "b3", F32, (c,))):
        _build.require(t, f"fused_bottleneck_int8.{name}", dtype, shape)
    plan = tc_plan(b, h, w, c, m, c, 1, False)
    ld1 = kmajor_ld(w1, "fused_bottleneck_int8.w1", I8, c, m)
    ld2 = kmajor_ld(w2flat, "fused_bottleneck_int8.w2flat", I8, 9 * m, m)
    ld3 = kmajor_ld(w3, "fused_bottleneck_int8.w3", I8, m, c)
    out = torch.empty_like(x)
    _build.check(_build.lib().mmdx_int8_bottleneck(
        x.data_ptr(), w1.data_ptr(), ld1, k1.data_ptr(), b1.data_ptr(), w2flat.data_ptr(),
        ld2, k2.data_ptr(), b2.data_ptr(), w3.data_ptr(), ld3, k3.data_ptr(),
        b3.data_ptr(), float(kx), out.data_ptr(), b, h, w, c, m, plan.tr,
        _build.stream(x)), "fused_bottleneck_int8")
    fused_bottleneck_int8.launches += 1
    return out


fused_bottleneck_int8.launches = 0


def _f32_ratio(a: float, b: float) -> float:
    """``a / b`` of two f32 scales, divided in f32 (as the JAX fold does)."""
    return float(np.float32(a) / np.float32(b))


def fold_block_epilogues(d: dict, s_in: float, s1: float, s2: float, s_out: float) -> dict:
    """A stride-1 block's requant chain folded into the kernel's arguments,
    from the port's qparams (``{conv1, conv2, conv3}`` each with s8 HWIO
    "w", f32 "ws" [co] and "b" [co]) and the block's activation scales
    (input, after conv1's ReLU, after conv2's ReLU, output):
    ``relu(acc*(s*ws) + b)/s_next == relu(acc*K + B)`` with ``K = ws *
    (s/s_next)``, ``B = b/s_next``."""
    c1, c2, c3 = d["conv1"], d["conv2"], d["conv3"]
    m = c1["w"].shape[-1]
    # the weights are the HWIO views of the K-major GEMM operands ("w" of
    # "wk"): [C, M], [9M, M] and [M, C] views, no copy
    return dict(
        w1=c1["w"][0, 0], k1=c1["ws"] * _f32_ratio(s_in, s1),
        b1=div_exact(c1["b"], s1), w2flat=c2["w"].reshape(9 * m, m),
        k2=c2["ws"] * _f32_ratio(s1, s2), b2=div_exact(c2["b"], s2),
        w3=c3["w"][0, 0], k3=c3["ws"] * _f32_ratio(s2, s_out),
        b3=div_exact(c3["b"], s_out), kx=_f32_ratio(s_in, s_out))


class S8Walk:
    """``band_walk``'s s8 arithmetic: exact integer sums, in any order; the
    requant epilogues of the plain version."""
    tap_acc = False
    out_dtype = I8

    def __init__(self, k1, b1, k2, b2, k3, b3, kx):
        self.k1, self.b1, self.k2, self.b2 = k1, b1, k2, b2
        self.k3, self.b3, self.kx = k3, b3, torch.tensor(kx, dtype=F32)

    def dot(self, a, wk):
        return a.to(torch.int64) @ wk.to(torch.int64).t()

    def init2(self, n, rows):
        return torch.zeros((rows, n.stop - n.start), dtype=torch.int64)

    def store1(self, acc, n):
        return _q(torch.relu(acc.to(F32) * self.k1[n] + self.b1[n]))

    def store2(self, acc, n):
        return _q(torch.relu(acc.to(F32) * self.k2[n] + self.b2[n]))

    def store3(self, acc, accp, xs, n):
        return _q(torch.relu(acc.to(F32) * self.k3[n] + self.b3[n] + xs.to(F32) * self.kx))


def band_walk_int8(x, w1, k1, b1, w2flat, k2, b2, w3, k3, b3, kx, plan=None):
    """``ops/bottleneck.band_walk`` with ``fused_bottleneck_int8``'s
    arguments, on the CPU, on the plan of the card's launch unless one is
    given: the kernel's order of bands, halo rows, taps and K slices."""
    b, h, w, c = x.shape
    m = w1.shape[1]
    plan = plan or tc_plan(b, h, w, c, m, c, 1, False)
    return band_walk(x, w1.t(), w2flat.t(), w3.t(), None, plan,
                     S8Walk(k1, b1, k2, b2, k3, b3, kx))
