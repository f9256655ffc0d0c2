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


def _resize_crop(batch_u8: torch.Tensor, img_size: int, resize_size: int) -> torch.Tensor:
    _, h, w, _ = batch_u8.shape
    kh, kw = (torch.from_numpy(k).to(batch_u8.device)
              for k in R.fused_resize_crop_matrices(h, w, resize_size, img_size))
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
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    scale = 1.0 / (255.0 * std_t)
    shift = mean_t / std_t
    return (x * scale - shift).to(out_dtype).contiguous()


# ---------------------------------------------------------------------------
# Queue 2 row 17: the fused preprocessing kernel
# ---------------------------------------------------------------------------
def _band(k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per row of a coefficient matrix, the [lo, hi) of its nonzero entries
    (0, 0 for an all-zero row)."""
    nz = k != 0
    any_ = nz.any(axis=1)
    lo = np.where(any_, nz.argmax(axis=1), 0)
    hi = np.where(any_, k.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


_PREPROC_SMEM = 96 * 1024  # bytes of the row pass's slice per block


@functools.lru_cache(maxsize=32)
def _fused_consts(h: int, w: int, resize_size: int, img_size: int, mean, std):
    """Host constants of ``pallas_preprocess.preprocess_batch_pallas``: the
    resize + crop matrices, their row bands, and the f32 scale and shift."""
    kh, kw = R.fused_resize_crop_matrices(h, w, resize_size, img_size)
    scale = (1.0 / (255.0 * np.asarray(std, np.float32))).astype(np.float32)
    shift = (np.asarray(mean, np.float32) / np.asarray(std, np.float32)).astype(np.float32)
    return kh, kw, _band(kh), _band(kw), scale, shift


def preprocess_batch_fused_plain(batch_u8, img_size: int = 224, resize_size: int = 256,
                                 mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: per image and channel ``(kh @ img @ kw^T) *
    scale - shift`` as two f32 matmuls (TF32 must be off on the card)."""
    b, h, w, c = batch_u8.shape
    kh, kw, _, _, scale, shift = _fused_consts(h, w, resize_size, img_size,
                                               tuple(mean), tuple(std))
    dev = batch_u8.device
    img = batch_u8.permute(0, 3, 1, 2).to(torch.float32)  # [B, C, H, W]
    if c == 1:
        img = img.expand(b, 3, h, w)
    res = torch.from_numpy(kh).to(dev) @ img @ torch.from_numpy(kw).to(dev).T
    out = res * torch.from_numpy(scale).to(dev)[:, None, None] \
        - torch.from_numpy(shift).to(dev)[:, None, None]
    return out.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def preprocess_batch_fused(batch_u8: torch.Tensor, img_size: int = 224,
                           resize_size: int = 256, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                           out_dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 1|3] -> normalized [B, S, S, 3] NHWC: port of
    ``mmdx_tpu/ops/pallas_preprocess.py:preprocess_batch_pallas``, the same
    function as ``preprocess_batch_device`` in one kernel
    (``csrc/preprocess.cu``: one block per band of output rows, channel and
    image, which keeps the row pass's slice in shared memory and sums each
    row's nonzero band of coefficients). No engine mode calls it, as in the
    JAX package.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if batch_u8.device.type == "cpu":
        return preprocess_batch_fused_plain(batch_u8, img_size, resize_size, mean, std,
                                            out_dtype)
    b, h, w, c = batch_u8.shape
    if c not in (1, 3):
        raise ValueError(f"preprocess_batch_fused: expected 1 or 3 channels, got {c}")
    _build.require(batch_u8, "preprocess_batch_fused.batch_u8", torch.uint8, (b, h, w, c))
    kh, kw, (hlo, hhi), (wlo, whi), scale, shift = _fused_consts(
        h, w, resize_size, img_size, tuple(mean), tuple(std))
    dev = batch_u8.device
    consts = [torch.from_numpy(a).to(dev) for a in (kh, kw, hlo, hhi, wlo, whi, scale, shift)]
    w0, w1 = int(wlo.min()), int(whi.max())
    rows = max(1, min(16, _PREPROC_SMEM // max(1, 4 * (w1 - w0))))
    out = torch.empty((b, img_size, img_size, 3), dtype=torch.float32, device=dev)
    _build.check(_build.lib().mmdx_preprocess(
        batch_u8.data_ptr(), *(t.data_ptr() for t in consts), out.data_ptr(), b, h, w, c,
        img_size, rows, w0, w1, _build.stream(batch_u8)), "preprocess_batch_fused")
    preprocess_batch_fused.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


preprocess_batch_fused.launches = 0
