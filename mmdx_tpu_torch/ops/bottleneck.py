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

Kernels, one launch each, a block per (image, band of output rows):

* bf16: the implicit GEMM on the tensor cores (``csrc/implicit_gemm.cuh``,
  shared with row 13): conv1 over the band and its halo rows into a
  shared-memory tile, conv2 as nine shifted views of that tile, conv3 with
  the shortcut; x1 and x2 never leave the SM. It reads its weights K-major
  (each row one output channel, K contiguous): ``w1 [Cin, M]`` is the view
  ``w1k.t()`` of a ``[M, Cin]`` tensor, ``w2 [3, 3, M, M]`` the HWIO view of
  ``[M, 9M]`` (``kmajor_hwio``), as ``models/resnet.py`` lays them out once.
  ``tc_plan`` picks the band height; ``band_walk`` walks the kernel's order
  on the CPU for the tests.
* f32: the CUDA-core body of the first port (``csrc/bottleneck.cu``), f32
  FMAs (TF32 would change the numbers), row-major weights.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mmdx_tpu_torch import _build

F32 = torch.float32
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
H100_SMS = 132
# csrc/implicit_gemm.cuh
STAGES = {1: 4, 2: 3}  # the cp.async ring's depth by element bytes (s8, bf16)
KS = 64              # bytes of K a ring stage holds (two MMA k-steps)
SLOT_PITCH = KS + 16
WARP_ROWS, WARP_COLS = 32, 64
MAX_TR = 8
# The plan's cost model: a weight byte streamed from L2 into a block costs
# about as long as this many MMA multiply-adds of the SM (~1,300 mma.sync
# multiply-adds against ~23 L2 bytes a clock and SM on an H100).
WEIGHT_BYTE_MACS = 56


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
class BottleneckPlan(NamedTuple):
    tr: int                # output rows per band (block)
    stages: int            # the ring's depth (0: the f32 body has no ring)
    cluster: int           # blocks per cluster: 1, each block streams its own weights
    grid: tuple[int, int]  # (bands, images)
    smem: int              # dynamic shared memory of a block, bytes


def wn_of(n: int) -> int:
    """Warps across the columns of a pass: 2 (128 columns) where N is a
    multiple of 128, else 1 (64)."""
    return 2 if n % 128 == 0 else 1


def group_rows(wn: int) -> int:
    """Pixels (GEMM rows) one pass of the 8 warps covers."""
    return 8 // wn * WARP_ROWS


def tc_smem_bytes(w: int, m: int, cout: int, tr: int, es: int, proj: bool) -> int:
    """The tensor-core kernel's dynamic shared memory
    (``csrc/implicit_gemm.cuh:smem_bytes``): the a1 tile with its border and
    halo (at least conv3's output staging, 8 warps x 32 rows of 64
    columns, which reuses it), the a2 tile, and the ring's stages of x rows
    (in s8 also conv3's shortcut tile) and weight rows, each row padded by
    16 bytes."""
    pitch = m * es + 16
    a1 = max((tr + 2) * (w + 2) * pitch, 8 * WARP_ROWS * (WARP_COLS * es + 16))
    wn3 = wn_of(cout)
    slot_a = max(group_rows(wn_of(m)) * SLOT_PITCH,
                 group_rows(wn3) * SLOT_PITCH if proj else 0,
                 # s8 stages conv3's identity shortcut through the A slot
                 group_rows(wn3) * (wn3 * WARP_COLS * es + 16) if es == 1 and not proj else 0)
    slot_b = max(wn_of(m), wn_of(cout)) * WARP_COLS * SLOT_PITCH
    return a1 + tr * w * pitch + STAGES[es] * (slot_a + slot_b)


def check_tc_widths(cin: int, m: int, cout: int, proj: bool, name: str) -> None:
    if cin % 64 or m % 64 or cout % 64:
        raise ValueError(f"{name}: channels {cin}, {m}, {cout} must be multiples of 64 "
                         "(the tensor-core kernel's 64-byte K slices and 64-column chunks)")
    if not proj and cin != cout:
        raise ValueError(f"{name}: identity shortcut needs Cin == Cout, got {cin}, {cout}")


def tc_cost(b: int, h: int, w: int, cin: int, m: int, cout: int, es: int, proj: bool,
            tr: int, sms: int = H100_SMS) -> int:
    """The plan's estimate of a launch, in multiply-adds of one SM: waves of
    blocks times a block's MMA work plus its weight bytes at
    WEIGHT_BYTE_MACS. Rows count in whole passes (a pass costs the same
    however few of its warps hold pixels), conv1 over TR+2 rows, and each
    pass of rows streams its weights again."""
    g1, g3 = group_rows(wn_of(m)), group_rows(wn_of(cout))
    n1, n2, n3 = cdiv((tr + 2) * w, g1), cdiv(tr * w, g1), cdiv(tr * w, g3)
    pw = cin * cout if proj else 0
    macs = n1 * g1 * cin * m + n2 * g1 * 9 * m * m + n3 * g3 * (m * cout + pw)
    wbytes = es * (n1 * cin * m + n2 * 9 * m * m + n3 * (m * cout + pw))
    return cdiv(cdiv(h, tr) * b, sms) * (macs + WEIGHT_BYTE_MACS * wbytes)


def tc_plan(b: int, h: int, w: int, cin: int, m: int, cout: int, es: int, proj: bool,
            sms: int = H100_SMS) -> BottleneckPlan:
    """The tensor-core kernel's plan (bf16 es=2, s8 es=1): the band height
    TR in 1..8 whose shared memory fits and whose ``tc_cost`` is least (the
    larger TR on a tie). Raises on widths the kernel does not take or a
    row too wide for shared memory."""
    check_tc_widths(cin, m, cout, proj, "fused bottleneck")
    best = None
    for tr in range(min(h, MAX_TR), 0, -1):
        smem = tc_smem_bytes(w, m, cout, tr, es, proj)
        if smem > SMEM_LIMIT:
            continue
        cost = tc_cost(b, h, w, cin, m, cout, es, proj, tr, sms)
        if best is None or cost < best[0]:
            best = (cost, BottleneckPlan(tr, STAGES[es], 1, (cdiv(h, tr), b), smem))
    if best is None:
        raise ValueError(f"fused bottleneck: a {w}-wide band of {m} channels does not fit "
                         f"in shared memory ({tc_smem_bytes(w, m, cout, 1, es, proj)} > "
                         f"{SMEM_LIMIT} bytes at one row)")
    return best[1]


def band_rows(h: int, w: int, m: int, itemsize: int) -> int:
    """The f32 body's output rows per block: 4, fewer when the shared tiles
    would not fit."""
    for tr in (4, 2, 1):
        if ((tr + 2) * (w + 2) * m + tr * w * m) * itemsize <= SMEM_LIMIT:
            return min(tr, h)
    raise ValueError(f"fused_bottleneck: a {w}-wide row of {m} channels does not fit "
                     "in shared memory")


def bottleneck_plan(b: int, h: int, w: int, cin: int, m: int, cout: int, dtype,
                    proj: bool, sms: int = H100_SMS) -> BottleneckPlan:
    """The plan of the kernel ``fused_bottleneck`` launches for ``dtype``:
    ``tc_plan`` in bf16, the f32 body's band (no ring) in f32."""
    if dtype == torch.bfloat16:
        return tc_plan(b, h, w, cin, m, cout, 2, proj, sms)
    if dtype != F32:
        raise ValueError(f"fused_bottleneck: expected bf16 or f32, got {dtype}")
    tr = band_rows(h, w, m, 4)
    return BottleneckPlan(tr, 0, 1, (cdiv(h, tr), b),
                          ((tr + 2) * (w + 2) * m + tr * w * m) * 4)


# ---------------------------------------------------------------------------
# K-major weights
# ---------------------------------------------------------------------------
def kmajor_hwio(w2k, m: int) -> torch.Tensor:
    """The HWIO ``[3, 3, M, M]`` view of a K-major ``[M, >= 9M]`` conv2
    weight (K in (ky, kx, ci) order): no copy."""
    return w2k[:, :9 * m].t().reshape(3, 3, m, m)


def kmajor_ld(t, name: str, dtype, k: int, n: int) -> int:
    """The row pitch (elements) of the K-major storage behind ``t``, a
    ``[K, N]`` view (or the HWIO ``[3, 3, M, M]`` view of ``[M, 9M]``) whose
    K is contiguous and whose N rows are 16-byte aligned; raises
    otherwise."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    flat = t.reshape(k, n) if t.dim() == 4 and t.stride()[:3] == (3 * n, n, 1) else t
    if tuple(flat.shape) != (k, n) or flat.stride(0) != 1 or \
            (flat.stride(1) * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected the [{k}, {n}] view of K-major storage "
                         f"([{n}, K] rows, K contiguous, 16-byte aligned), got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return flat.stride(1)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wp=None, bp=None):
    """x [B, H, W, Cin] (bf16 or f32); w1 [Cin, M]; w2 [3, 3, M, M] (HWIO);
    w3 [M, Cout]; wp [Cin, Cout] or None (identity, Cin == Cout), weights in
    x's dtype (bf16: views of K-major storage, see the module note); b1, b2
    [M], b3, bp [Cout] f32 -> [B, H, W, Cout] in x.dtype."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wp, bp)
    dt = x.dtype
    if dt not in (torch.bfloat16, F32):
        raise ValueError(f"fused_bottleneck: expected bf16 or f32, got {dt}")
    b, h, w, cin = x.shape
    m, cout = w1.shape[1], w3.shape[1]
    proj = wp is not None
    if not proj and cin != cout:
        raise ValueError(f"fused_bottleneck: identity shortcut needs Cin == Cout, "
                         f"got {cin}, {cout}")
    vecs = [(b1, "b1", (m,)), (b2, "b2", (m,)), (b3, "b3", (cout,))]
    if proj:
        vecs.append((bp, "bp", (cout,)))
    _build.require(x, "fused_bottleneck.x", dt, (b, h, w, cin))
    for t, name, shape in vecs:
        _build.require(t, f"fused_bottleneck.{name}", F32, shape)
    out = torch.empty((b, h, w, cout), dtype=dt, device=x.device)
    plan = bottleneck_plan(b, h, w, cin, m, cout, dt, proj)
    if dt == F32:
        if cin % 8 or m % 8 or cout % 8:
            raise ValueError(f"fused_bottleneck: channels {cin}, {m}, {cout} must be "
                             "multiples of 8")
        w1, w2, w3 = w1.contiguous(), w2.contiguous(), w3.contiguous()
        mats = [(w1, "w1", (cin, m)), (w2, "w2", (3, 3, m, m)), (w3, "w3", (m, cout))]
        if proj:
            wp = wp.contiguous()
            mats.append((wp, "wp", (cin, cout)))
        for t, name, shape in mats:
            _build.require(t, f"fused_bottleneck.{name}", dt, shape)
        err = _build.lib().mmdx_bottleneck(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), wp.data_ptr() if proj else None,
            bp.data_ptr() if proj else None, out.data_ptr(), b, h, w, cin, m, cout,
            plan.tr, _build.stream(x))
    else:
        ld1 = kmajor_ld(w1, "fused_bottleneck.w1", dt, cin, m)
        ld2 = kmajor_ld(w2, "fused_bottleneck.w2", dt, 9 * m, m)
        ld3 = kmajor_ld(w3, "fused_bottleneck.w3", dt, m, cout)
        ldp = kmajor_ld(wp, "fused_bottleneck.wp", dt, cin, cout) if proj else 0
        err = _build.lib().mmdx_bottleneck_tc(
            x.data_ptr(), w1.data_ptr(), ld1, b1.data_ptr(), w2.data_ptr(), ld2,
            b2.data_ptr(), w3.data_ptr(), ld3, b3.data_ptr(),
            wp.data_ptr() if proj else None, ldp, bp.data_ptr() if proj else None,
            out.data_ptr(), b, h, w, cin, m, cout, plan.tr, _build.stream(x))
    _build.check(err, "fused_bottleneck")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


# ---------------------------------------------------------------------------
# the kernels' order, walked on the CPU
# ---------------------------------------------------------------------------
def band_walk(x, w1k, w2k, w3k, wpk, plan: BottleneckPlan, epi) -> torch.Tensor:
    """The tensor-core kernel on the CPU, walked as the card walks it: per
    (image, band of ``plan.tr`` rows), conv1 over the band and its halo rows
    in passes of ``group_rows`` pixels, 64- or 128-column chunks and 64-byte
    K slices (rows past the band or outside the image read as zeros), into
    the zero-bordered a1 tile (flat, ``(TR+2)(W+2)`` pixel rows) with the
    halo rows outside the image written as zeros; conv2's nine taps as row
    offsets ``(t/3)(W+2) + t%3`` into that tile, its sum starting from
    ``epi.init2`` and, where ``epi.tap_acc``, each tap's slices summed on
    their own and then added; conv3 from the a2 tile, the projection's
    slices (``wpk``) into a second sum. ``w*k`` are the K-major [N, K]
    weights; ``epi`` holds the element type's products (``dot``) and
    epilogues (``store1``, ``store2``, ``store3``) in the plain version's
    arithmetic. -> [B, H, W, Cout] in ``epi.out_dtype``."""
    b, h, w, cin = x.shape
    m, cout = w1k.shape[0], w3k.shape[0]
    sl = KS // x.element_size()  # K elements in one slice
    spt = m // sl                # slices of one conv2 tap
    out = torch.empty((b, h, w, cout), dtype=epi.out_dtype)

    def passes(p_rows, n_cols, kn, rows_of, slice_of, seg_of=lambda ks: 0, init=None):
        """Yield (pixels, column slice, sums) for each (pass of rows, chunk
        of columns), the sums taken slice by slice in the kernel's order."""
        g, cw = group_rows(wn_of(n_cols)), WARP_COLS * wn_of(n_cols)
        for p0 in range(0, p_rows, g):
            pix = torch.arange(p0, min(p0 + g, p_rows))
            for n0 in range(0, n_cols, cw):
                n = slice(n0, n0 + cw)
                zeros = epi.dot(rows_of(pix, 0)[:, :0], slice_of(0)[n, :0])
                sums = [zeros if init is None else init(n, len(pix)), zeros]
                tap = zeros
                for ks in range(kn):
                    part = epi.dot(rows_of(pix, ks), slice_of(ks)[n])
                    seg = seg_of(ks)
                    if seg == "tap":
                        tap = tap + part
                        if (ks + 1) % spt == 0:
                            sums[0], tap = sums[0] + tap, zeros
                    else:
                        sums[seg] = sums[seg] + part
                yield pix, n, sums

    for bi in range(b):
        xb = x[bi].reshape(h * w, cin)
        ob = out[bi].reshape(h * w, cout)
        for r0 in range(0, h, plan.tr):
            rows = min(plan.tr, h - r0)

            def x_rows(pix, first_row):
                row = first_row + pix // w
                ok = (row >= 0) & (row < h)
                a = xb[row.clamp(0, h - 1) * w + pix % w]
                return torch.where(ok[:, None], a, torch.zeros((), dtype=a.dtype)), ok

            a1 = torch.zeros(((plan.tr + 2) * (w + 2), m), dtype=x.dtype)
            for pix, n, sums in passes(
                    (rows + 2) * w, m, cin // sl,
                    lambda pix, ks: x_rows(pix, r0 - 1)[0][:, ks * sl:(ks + 1) * sl],
                    lambda ks: w1k[:, ks * sl:(ks + 1) * sl]):
                v = epi.store1(sums[0], n)
                live = x_rows(pix, r0 - 1)[1]
                a1[(pix // w) * (w + 2) + pix % w + 1, n] = torch.where(
                    live[:, None], v, torch.zeros((), dtype=v.dtype))

            def tap_rows(pix, ks):
                t, kin = ks // spt, ks % spt
                return a1[(pix // w + t // 3) * (w + 2) + pix % w + t % 3,
                          kin * sl:(kin + 1) * sl]

            a2 = torch.empty((plan.tr * w, m), dtype=x.dtype)
            for pix, n, sums in passes(
                    rows * w, m, 9 * spt, tap_rows, lambda ks: w2k[:, ks * sl:(ks + 1) * sl],
                    (lambda ks: "tap") if epi.tap_acc else (lambda ks: 0), epi.init2):
                a2[pix, n] = epi.store2(sums[0], n)

            k3 = m // sl
            kn = k3 + (cin // sl if wpk is not None else 0)

            def rows3(pix, ks):
                if ks < k3:
                    return a2[pix, ks * sl:(ks + 1) * sl]
                return x_rows(pix, r0)[0][:, (ks - k3) * sl:(ks - k3 + 1) * sl]

            def slice3(ks):
                if ks < k3:
                    return w3k[:, ks * sl:(ks + 1) * sl]
                return wpk[:, (ks - k3) * sl:(ks - k3 + 1) * sl]

            for pix, n, sums in passes(rows * w, cout, kn, rows3, slice3,
                                       lambda ks: 0 if ks < k3 else 1):
                q = r0 * w + pix
                ob[q, n] = epi.store3(sums[0], sums[1] if wpk is not None else None,
                                      xb[q][:, n], n)
    return out


class Bf16Walk:
    """``band_walk``'s bf16 arithmetic: each 64-byte slice's product in f32
    (as the MMA sums it), added to its sum in f32; conv2's sum starts from
    b2; the epilogues of the plain version."""
    tap_acc = True
    out_dtype = torch.bfloat16

    def __init__(self, b1, b2, b3, bp=None):
        self.b1, self.b2, self.b3, self.bp = b1, b2, b3, bp

    def dot(self, a, wk):
        return a.to(F32) @ wk.to(F32).t()

    def init2(self, n, rows):
        return self.b2[n].to(F32).expand(rows, -1)

    def store1(self, acc, n):
        return torch.relu(acc + self.b1[n]).to(torch.bfloat16)

    def store2(self, acc, n):
        return torch.relu(acc).to(torch.bfloat16)

    def store3(self, acc, accp, xs, n):
        sc = xs.to(F32) if accp is None else accp + self.bp[n]
        return torch.relu((acc + self.b3[n]) + sc).to(torch.bfloat16)


def tc_walk(x, w1, b1, w2, b2, w3, b3, wp=None, bp=None, plan=None) -> torch.Tensor:
    """``band_walk`` with ``fused_bottleneck``'s bf16 arguments, on the CPU,
    on the plan of the card's launch unless one is given."""
    b, h, w, cin = x.shape
    m, cout = w1.shape[1], w3.shape[1]
    plan = plan or tc_plan(b, h, w, cin, m, cout, 2, wp is not None)
    return band_walk(x, w1.t(), w2.reshape(9 * m, m).t(), w3.t(),
                     None if wp is None else wp.t(), plan, Bf16Walk(b1, b2, b3, bp))


def fold_bn(kernel, scale, bias, mean, var, eps: float):
    """Fold an inference-mode BatchNorm into the preceding conv (``kernel``
    [..., Cout], BN vectors [Cout]): ``(kernel * s, bias - mean * s)`` with
    ``s = scale / sqrt(var + eps)`` in f32, the kernel cast back to its dtype."""
    s = scale.to(F32) * torch.rsqrt(var.to(F32) + eps)
    return (kernel.to(F32) * s).to(kernel.dtype), bias.to(F32) - mean.to(F32) * s
