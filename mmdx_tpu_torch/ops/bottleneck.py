"""Fused stride-1 ResNet bottleneck with folded BatchNorm (Queue 2 row 12).

Port of ``mmdx_tpu/ops/pallas_bottleneck.py``: ``fused_bottleneck`` (``:42``,
``pallas_call`` ``:128``) and ``fold_bn`` (``:144``). For NHWC ``x`` in bf16
or f32::

    x1  = dt(relu(x @ w1 + b1))
    acc = b2 + sum over the nine taps of (tap(x1) @ w2[ky, kx])   # f32
    x2  = dt(relu(acc))
    out = dt(relu(x2 @ w3 + b3 + shortcut))

with the Pallas body's rounding points (``:68-118``): f32 products, the
biases f32, each tap's product summed on its own and added to ``acc``
(which starts from ``b2``), x1 and x2 rounded to x's dtype, zero padding at
the image edges; ``shortcut`` is x (identity) or ``x @ wp + bp``.

Kernel (CUDA C++, ``csrc/bottleneck.cu``), one launch: a block per (image,
band of output rows) runs conv1 over the band and its halo rows into a
shared-memory tile, the 3x3 conv from that tile, and conv3 with the
shortcut; x1 and x2 never leave the SM. The source notes what bounds it.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mmdx_tpu_torch import _build

F32 = torch.float32
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wp=None, bp=None):
    """Plain PyTorch version (f32 products) with the Pallas rounding points."""
    dt = x.dtype
    b, h, w, cin = x.shape
    m, cout = w1.shape[1], w3.shape[1]
    xf = x.reshape(-1, cin).to(F32)
    x1 = torch.relu(xf @ w1.to(F32) + b1.to(F32)).to(dt)
    xp = F.pad(x1.reshape(b, h, w, m).to(F32), (0, 0, 1, 1, 1, 1))
    acc = b2.to(F32).expand(b * h * w, m)
    for ky in range(3):
        for kx in range(3):
            tap = xp[:, ky:ky + h, kx:kx + w].reshape(-1, m)
            acc = acc + tap @ w2[ky, kx].to(F32)
    x2 = torch.relu(acc).to(dt)
    y = x2.to(F32) @ w3.to(F32) + b3.to(F32)
    sc = xf if wp is None else xf @ wp.to(F32) + bp.to(F32)
    return torch.relu(y + sc).to(dt).reshape(b, h, w, cout)


def band_rows(h: int, w: int, m: int, itemsize: int) -> int:
    """Output rows per block: 4, fewer when the shared tiles would not fit."""
    for tr in (4, 2, 1):
        if ((tr + 2) * (w + 2) * m + tr * w * m) * itemsize <= SMEM_LIMIT:
            return min(tr, h)
    raise ValueError(f"fused_bottleneck: a {w}-wide row of {m} channels does not fit "
                     "in shared memory")


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wp=None, bp=None):
    """x [B, H, W, Cin] (bf16 or f32); w1 [Cin, M]; w2 [3, 3, M, M] (HWIO);
    w3 [M, Cout]; wp [Cin, Cout] or None (identity, Cin == Cout), weights in
    x's dtype; b1, b2 [M], b3, bp [Cout] f32 -> [B, H, W, Cout] in x.dtype."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wp, bp)
    dt = x.dtype
    if dt not in (torch.bfloat16, F32):
        raise ValueError(f"fused_bottleneck: expected bf16 or f32, got {dt}")
    b, h, w, cin = x.shape
    m, cout = w1.shape[1], w3.shape[1]
    if cin % 8 or m % 8 or cout % 8:
        raise ValueError(f"fused_bottleneck: channels {cin}, {m}, {cout} must be "
                         "multiples of 8")
    if wp is None and cin != cout:
        raise ValueError(f"fused_bottleneck: identity shortcut needs Cin == Cout, "
                         f"got {cin}, {cout}")
    checks = [(x, "x", dt, (b, h, w, cin)), (w1, "w1", dt, (cin, m)), (b1, "b1", F32, (m,)),
              (w2, "w2", dt, (3, 3, m, m)), (b2, "b2", F32, (m,)),
              (w3, "w3", dt, (m, cout)), (b3, "b3", F32, (cout,))]
    if wp is not None:
        checks += [(wp, "wp", dt, (cin, cout)), (bp, "bp", F32, (cout,))]
    for t, name, dtype, shape in checks:
        _build.require(t, f"fused_bottleneck.{name}", dtype, shape)
    out = torch.empty((b, h, w, cout), dtype=dt, device=x.device)
    _build.check(_build.lib().mmdx_bottleneck(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), None if wp is None else wp.data_ptr(),
        None if bp is None else bp.data_ptr(), out.data_ptr(), b, h, w, cin, m, cout,
        band_rows(h, w, m, x.element_size()), int(dt == torch.bfloat16),
        _build.stream(x)), "fused_bottleneck")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


def fold_bn(kernel, scale, bias, mean, var, eps: float):
    """Fold an inference-mode BatchNorm into the preceding conv (``kernel``
    [..., Cout], BN vectors [Cout]): ``(kernel * s, bias - mean * s)`` with
    ``s = scale / sqrt(var + eps)`` in f32, the kernel cast back to its dtype."""
    s = scale.to(F32) * torch.rsqrt(var.to(F32) + eps)
    return (kernel.to(F32) * s).to(kernel.dtype), bias.to(F32) - mean.to(F32) * s
