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
  folded gray stem takes (turbo mode).

Outputs are NHWC, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

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
