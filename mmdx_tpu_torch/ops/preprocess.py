"""Image preprocessing: resize(256, antialias) -> center-crop(224) -> scale ->
3-channel -> ImageNet normalize.

Port of ``mmdx_tpu/ops/preprocess.py`` (``preprocess_exact`` ``:29-65``,
``preprocess_batch_device`` ``:71-101, :145`` and
``preprocess_batch_device_gray`` ``:102-142``) without its jax import:

* ``preprocess_exact`` — host numpy, bit-exact vs PIL + torchvision, built on
  the port's copy of ``ops/resize.py`` (parity mode);
* ``preprocess_batch_device`` — on-device: the fused resize + crop is two
  matmuls per image over ``resize.fused_resize_crop_matrices`` and the
  normalize folds into one multiply-add (fast and turbo mode). Plain matmuls
  outside any kernel, so plain torch ops;
* ``preprocess_batch_device_gray`` — the same resize + crop for 1-channel
  batches, emitting the centered raw gray v = u - 0.5 that the int8 tower's
  folded gray stem takes (turbo mode);
* ``preprocess_batch_fused`` — ``preprocess_batch_device``'s function as one
  hand-written kernel, the port of ``pallas_preprocess.py`` (Queue 2 row 17);
  like the Pallas function, no engine mode calls it.

Outputs are NHWC, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mmdx_tpu_torch import _build
from mmdx_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from mmdx_tpu_torch.ops import resize as R


def preprocess_exact(img_u8: np.ndarray, img_size: int = 224, resize_size: int = 256,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> float32 [img_size, img_size, 3] (HWC)."""
    assert img_u8.dtype == np.uint8
    h, w = img_u8.shape[:2]
    new_h, new_w = R.shorter_side_target(h, w, resize_size)
    if (new_h, new_w) != (h, w):
        img_u8 = R.resize_u8_exact(img_u8, new_h, new_w)
    top, left = R.center_crop_bounds(new_h, new_w, img_size)
    if top < 0 or left < 0 or new_h < img_size or new_w < img_size:
        # torchvision pads with zeros when the crop exceeds the image
        pad_h = max(img_size - new_h, 0)
        pad_w = max(img_size - new_w, 0)
        pads = [(pad_h // 2 + pad_h % 2, pad_h // 2), (pad_w // 2 + pad_w % 2, pad_w // 2)]
        if img_u8.ndim == 3:
            pads.append((0, 0))
        img_u8 = np.pad(img_u8, pads)
        new_h, new_w = img_u8.shape[:2]
        top, left = R.center_crop_bounds(new_h, new_w, img_size)
    img_u8 = img_u8[top:top + img_size, left:left + img_size]
    x = img_u8.astype(np.float32) / np.float32(255.0)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@functools.lru_cache(maxsize=32)
def dense_matrices(device: torch.device, h: int, w: int, resize_size: int,
                   img_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``resize.fused_resize_crop_matrices`` (kh [S, H], kw [S, W], f32) on
    ``device``, copied from the host once per shape."""
    return tuple(torch.from_numpy(k).to(device)
                 for k in R.fused_resize_crop_matrices(h, w, resize_size, img_size))


@functools.lru_cache(maxsize=8)
def norm_scale_shift(mean: tuple, std: tuple) -> tuple[np.ndarray, np.ndarray]:
    """f32 [3] ``1 / (255 std)`` and ``mean / std``, as the Pallas kernel's
    host constants (``pallas_preprocess.py:87-88``)."""
    scale = (1.0 / (255.0 * np.asarray(std, np.float32))).astype(np.float32)
    shift = (np.asarray(mean, np.float32) / np.asarray(std, np.float32)).astype(np.float32)
    return scale, shift


@functools.lru_cache(maxsize=32)
def _norm_consts(device: torch.device, mean: tuple, std: tuple):
    """``norm_scale_shift`` on ``device``, copied once per (device, mean,
    std)."""
    return tuple(torch.from_numpy(a).to(device) for a in norm_scale_shift(mean, std))


def _resize_crop(batch_u8: torch.Tensor, img_size: int, resize_size: int) -> torch.Tensor:
    _, h, w, _ = batch_u8.shape
    kh, kw = dense_matrices(batch_u8.device, h, w, resize_size, img_size)
    x = batch_u8.to(torch.float32)
    x = torch.einsum("bhwc,oh->bowc", x, kh)
    return torch.einsum("bhwc,ow->bhoc", x, kw)


def preprocess_batch_device_gray(batch_u8: torch.Tensor, img_size: int = 224,
                                 resize_size: int = 256,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 1] on the device -> centered raw gray v = u - 0.5
    [B, S, S, 1] NHWC (u the resized, cropped gray in [0, 1]): no channel
    broadcast and no normalize; those fold into the int8 gray stem."""
    if batch_u8.shape[-1] != 1:
        raise ValueError(f"gray preproc needs 1-channel input, got {batch_u8.shape[-1]}")
    x = _resize_crop(batch_u8, img_size, resize_size)
    return (x * (1.0 / 255.0) - 0.5).to(out_dtype).contiguous()


def preprocess_batch_device(batch_u8: torch.Tensor, img_size: int = 224,
                            resize_size: int = 256, mean=IMAGENET_MEAN,
                            std=IMAGENET_STD, out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, C] on the device -> normalized [B, S, S, 3] NHWC."""
    x = _resize_crop(batch_u8, img_size, resize_size)
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    scale, shift = _norm_consts(x.device, tuple(mean), tuple(std))
    return (x * scale - shift).to(out_dtype).contiguous()


# ---------------------------------------------------------------------------
# Queue 2 row 17: the fused preprocessing kernel
# ---------------------------------------------------------------------------
MAX_TAPS = 16            # widest row of kh or kw the kernel takes
BLOCK_CHOICES = (3, 4)   # blocks an SM csrc/preprocess.cu is built for
MAX_TRO = 8


def smem_per_block(blocks: int) -> int:
    """Shared memory a block may use for ``blocks`` blocks an SM (228 KB an
    SM, 1 KB of it reserved per block)."""
    return 228 * 1024 // blocks - 1024


class TapTable(NamedTuple):
    """One resize + crop matrix k [S, N] as ``k[r, start[r] + t] = coef[r, t]``
    for t < T, zero elsewhere: T the widest band of nonzero coefficients,
    ``start`` moved left where a band ends within T of the edge (its leading
    coefficients are then zeros)."""

    start: np.ndarray  # int32 [S]
    coef: np.ndarray   # f32 [S, T]


def _band(k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per row of a coefficient matrix, the [lo, hi) of its nonzero entries
    (0, 0 for an all-zero row)."""
    nz = k != 0
    any_ = nz.any(axis=1)
    lo = np.where(any_, nz.argmax(axis=1), 0)
    hi = np.where(any_, k.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return lo, hi


def tap_table(k: np.ndarray) -> TapTable:
    lo, hi = _band(k)
    t = max(1, int((hi - lo).max()))
    start = np.minimum(lo, k.shape[1] - t).astype(np.int32)
    coef = np.take_along_axis(k, start[:, None] + np.arange(t)[None, :], axis=1)
    return TapTable(start, np.ascontiguousarray(coef, dtype=np.float32))


@functools.lru_cache(maxsize=32)
def tap_tables(h: int, w: int, resize_size: int, img_size: int) -> tuple[TapTable, TapTable]:
    """The compact form of ``resize.fused_resize_crop_matrices``: (rows of
    kh, rows of kw) as tap tables, built once per shape on the host."""
    kh, kw = R.fused_resize_crop_matrices(h, w, resize_size, img_size)
    return tap_table(kh), tap_table(kw)


@functools.lru_cache(maxsize=32)
def device_tables(device: torch.device, h: int, w: int, resize_size: int,
                  img_size: int) -> tuple[torch.Tensor, ...]:
    """(hstart, hcoef, wstart, wcoef) of ``tap_tables`` on ``device``, copied
    once per shape: after a shape's first call the kernel's launch copies
    nothing from the host (scale and shift go by value), so the call can be
    captured in a CUDA graph."""
    th, tw = tap_tables(h, w, resize_size, img_size)
    return tuple(torch.from_numpy(a).to(device) for a in (th.start, th.coef, tw.start, tw.coef))


def slice_columns(tw: TapTable) -> tuple[int, int]:
    """(w0, span): the input columns [w0, w0 + span) of the row pass's
    slice, every column a kw row reads, w0 rounded down to a multiple of 4
    so that a slice row starts on a 4-byte boundary of an NHWC row."""
    w0 = int(tw.start.min()) & ~3
    return w0, int(tw.start.max()) + tw.coef.shape[1] - w0


class PreprocPlan(NamedTuple):
    tro: int       # output rows a band
    rows_in: int   # most input rows a band stages
    blocks: int    # blocks an SM the launch is sized for (3 or 4)
    grid: int      # persistent blocks, each over bands blockIdx.x, + grid, ...
    io_off: int    # bytes of shared memory before the two staging buffers
    io_bytes: int  # bytes of one staging buffer (a band's rows, then its output)
    smem: int      # dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=64)
def preprocess_plan(b: int, h: int, w: int, c: int, resize_size: int, img_size: int,
                    out_bytes: int, sms: int = 132) -> PreprocPlan:
    """The launch of ``csrc/preprocess.cu``: bands of TRo output rows and
    the blocks an SM. A block's shared memory holds the row pass's [TRo,
    span x C] f32 slice (rows padded to quads of four values), the tap
    tables, and two buffers that each stage a band's input rows and then
    hold its output. Of ``BLOCK_CHOICES`` (three or four blocks an SM; four
    leave at most 64 registers a thread), the one whose blocks fit the
    tallest bands (at most 8 rows), four on a tie; TRo is then halved down
    to 2 while there are fewer bands than blocks the card holds, and a
    persistent grid of at most that many blocks walks the (band, image)
    items. (On an H100, B=32: 512x512 RGB four blocks of 4 rows 28 us a
    call, three blocks of 4 rows 32; 512x512 gray and 256x256 RGB three
    blocks of 8 rows 18 and 14 us, four blocks of 4 rows 18 and 16;
    ``scripts/ablate_gemm.py --preprocess``.)"""
    th, tw = tap_tables(h, w, resize_size, img_size)
    t_h, t_w = th.coef.shape[1], tw.coef.shape[1]
    pitch = -(-slice_columns(tw)[1] * c // 4) * 4  # f32 a slice row, in quads

    def plan(tro, blocks):
        rows_in = max(int(th.start[r:r + tro].max()) + t_h - int(th.start[r:r + tro].min())
                      for r in range(0, img_size, tro))
        io_off = -(-4 * (tro * pitch + img_size * t_w + img_size + 2 * tro * t_h + 2 * tro)
                   // 16) * 16
        io = max(-(-(rows_in * w * c + 32) // 16) * 16, tro * img_size * 3 * out_bytes)
        items = b * -(-img_size // tro)
        return PreprocPlan(tro, rows_in, blocks, min(items, blocks * sms), io_off, io,
                           io_off + 2 * io)

    def fit(blocks):  # the most rows a band whose block fits `blocks` an SM
        tro = MAX_TRO
        while tro > 1 and plan(tro, blocks).smem > smem_per_block(blocks):
            tro //= 2
        return tro, blocks

    tro, blocks = max(fit(blocks) for blocks in BLOCK_CHOICES)
    while tro > 2 and b * -(-img_size // tro) < blocks * sms:
        tro //= 2
    return plan(tro, blocks)


def blocks_per_sm(plan: PreprocPlan, out_dtype=torch.float32) -> int:
    """How many blocks of the kernel built for ``plan.blocks`` an SM of the
    current card holds at once with the plan's shared memory (the occupancy
    calculator)."""
    import ctypes

    n = ctypes.c_int(0)
    _build.check(_build.lib().mmdx_preprocess_blocks_per_sm(
        plan.smem, int(out_dtype == torch.bfloat16), plan.blocks, ctypes.addressof(n)),
        "blocks_per_sm")
    return n.value


def _fma32(a, b, c):
    """f32 ``fmaf(a, b, c)`` in numpy: the product is exact in f64, the sum
    rounded once to f64 and then to f32."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def tap_sums(batch_u8: np.ndarray, img_size: int = 224,
             resize_size: int = 256) -> np.ndarray:
    """``csrc/preprocess.cu``'s two passes in numpy: the row pass over each
    kh row's taps into [S, span, C], the column pass over each kw row's
    taps, both f32 FMA chains in increasing tap order from 0 -> the raw
    resized, cropped sums [B, S, S, C] (C as the input's, before the
    normalize)."""
    b, h, w, c = batch_u8.shape
    th, tw = tap_tables(h, w, resize_size, img_size)
    x = batch_u8.astype(np.float32)
    w0, span = slice_columns(tw)
    tmp = np.zeros((b, img_size, span, c), np.float32)
    for t in range(th.coef.shape[1]):
        tmp = _fma32(th.coef[:, t][None, :, None, None],
                     x[:, th.start + t, w0:w0 + span, :], tmp)
    res = np.zeros((b, img_size, img_size, c), np.float32)
    for t in range(tw.coef.shape[1]):
        res = _fma32(tmp[:, :, tw.start - w0 + t, :], tw.coef[:, t][None, None, :, None], res)
    return res


def tap_walk(batch_u8: np.ndarray, img_size: int = 224, resize_size: int = 256,
             mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """``csrc/preprocess.cu``'s arithmetic in numpy (f32 out): ``tap_sums``,
    then ``* scale - shift`` rounded after each operation; a 1-channel image
    is summed once and normalized per output channel."""
    res = tap_sums(batch_u8, img_size, resize_size)
    if res.shape[-1] == 1:
        res = np.repeat(res, 3, axis=-1)
    scale, shift = norm_scale_shift(tuple(mean), tuple(std))
    return (res * scale).astype(np.float32) - shift


def preprocess_batch_fused_plain(batch_u8, img_size: int = 224, resize_size: int = 256,
                                 mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: per image and channel ``(kh @ img @ kw^T) *
    scale - shift`` as two f32 matmuls (TF32 must be off on the card), then
    rounded to ``out_dtype``."""
    b, h, w, c = batch_u8.shape
    kh, kw = dense_matrices(batch_u8.device, h, w, resize_size, img_size)
    scale, shift = (a[:, None, None] for a in _norm_consts(batch_u8.device, tuple(mean),
                                                           tuple(std)))
    img = batch_u8.permute(0, 3, 1, 2).to(torch.float32)  # [B, C, H, W]
    if c == 1:
        img = img.expand(b, 3, h, w)
    out = (kh @ img @ kw.T) * scale - shift
    return out.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def preprocess_batch_fused(batch_u8: torch.Tensor, img_size: int = 224,
                           resize_size: int = 256, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                           out_dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 1|3] -> normalized [B, S, S, 3] NHWC in
    ``out_dtype`` (f32 or bf16): port of
    ``mmdx_tpu/ops/pallas_preprocess.py:preprocess_batch_pallas``, the same
    function as ``preprocess_batch_device`` in one kernel
    (``csrc/preprocess.cu``: bands of TRo output rows of an image, all
    channels at once, over the compact tap tables of ``tap_tables``;
    persistent blocks, three or four an SM, stage the next band's rows
    while they sum one).
    No engine mode calls it, as in the JAX package.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if batch_u8.device.type == "cpu":
        return preprocess_batch_fused_plain(batch_u8, img_size, resize_size, mean, std,
                                            out_dtype)
    b, h, w, c = batch_u8.shape
    name = "preprocess_batch_fused"
    if c not in (1, 3):
        raise ValueError(f"{name}: expected 1 or 3 channels, got {c}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if img_size % 8:
        raise ValueError(f"{name}: the kernel stores rows of img_size x 3 values in 16-byte "
                         f"vectors and takes img_size % 8 == 0, got {img_size}")
    th, tw = tap_tables(h, w, resize_size, img_size)
    if max(th.coef.shape[1], tw.coef.shape[1]) > MAX_TAPS:
        raise ValueError(f"{name}: {h}x{w} -> {resize_size} needs {th.coef.shape[1]} x "
                         f"{tw.coef.shape[1]} taps a row; the kernel takes at most {MAX_TAPS} "
                         f"(a downscale of up to 8x)")
    _build.require(batch_u8, f"{name}.batch_u8", torch.uint8, (b, h, w, c))
    out_bytes = 2 if out_dtype == torch.bfloat16 else 4
    dev = batch_u8.device
    plan = preprocess_plan(b, h, w, c, resize_size, img_size, out_bytes,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.smem > smem_per_block(plan.blocks):
        raise ValueError(f"{name}: {h}x{w}x{c} needs {plan.smem} bytes of shared memory a "
                         f"block at TRo = {plan.tro}; the kernel takes "
                         f"{smem_per_block(plan.blocks)}")
    hstart, hcoef, wstart, wcoef = device_tables(dev, h, w, resize_size, img_size)
    scale, shift = norm_scale_shift(tuple(mean), tuple(std))
    w0, span = slice_columns(tw)
    out = torch.empty((b, img_size, img_size, 3), dtype=out_dtype, device=dev)
    _build.check(_build.lib().mmdx_preprocess(
        batch_u8.data_ptr(), hstart.data_ptr(), hcoef.data_ptr(), wstart.data_ptr(),
        wcoef.data_ptr(), out.data_ptr(), b, h, w, c, img_size, th.coef.shape[1],
        tw.coef.shape[1], w0, span, plan.tro, plan.blocks, plan.grid, plan.io_off,
        plan.io_bytes,
        plan.smem, int(out_bytes == 2),
        *map(float, scale), *map(float, shift), _build.stream(batch_u8)), name)
    preprocess_batch_fused.launches += 1
    return out


preprocess_batch_fused.launches = 0
