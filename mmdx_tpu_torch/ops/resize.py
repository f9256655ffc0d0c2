"""Bilinear antialias resize with PIL-exact semantics, as MXU-friendly matmuls.

The reference preprocesses with ``T.Resize(256, antialias=True)`` on PIL images
(reference ``backend/ml/pipelines/training_pipeline.py:112-119``), which executes
PIL's separable resampling: a triangle (bilinear) filter whose support scales
with the downscale ratio, computed in int32 fixed point with an intermediate
uint8 rounding between the horizontal and vertical passes.

We re-express both passes as dense coefficient matrices so the whole resize is
two matrix multiplies — the idiomatic TPU formulation (feeds the MXU instead of
gather loops):

    out[c] = K_h @ img[c] @ K_w^T

Two modes:
  * ``exact``  — int64 numpy fixed-point replication of PIL, bit-for-bit equal
                 to ``PIL.Image.resize(..., BILINEAR)`` on uint8 inputs.  Used
                 as the parity oracle and for strict-parity serving.
  * ``fast``   — float32 (or bfloat16) matmuls on device, used by the fused
                 serving path.  Differs from PIL by <1 uint8 ULP.

Coefficient construction mirrors Pillow's ``precompute_coeffs`` /
``normalize_coeffs_8bpc`` (Pillow src/libImaging/Resample.c).
"""
from __future__ import annotations

import functools

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point precision for 8-bit images


def _triangle_filter(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


@functools.lru_cache(maxsize=256)
def bilinear_coeff_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense float64 row-stochastic resize matrix [out_size, in_size].

    Row i holds PIL's normalized filter weights for output pixel i.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # bilinear filter support == 1.0
    ss = 1.0 / filterscale

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(center - support + 0.5)
        xmin = max(xmin, 0)
        xmax = int(center + support + 0.5)
        xmax = min(xmax, in_size)
        n = xmax - xmin
        x = np.arange(n, dtype=np.float64)
        w = _triangle_filter((x + xmin - center + 0.5) * ss)
        tot = w.sum()
        if tot != 0.0:
            w = w / tot
        mat[xx, xmin:xmax] = w
    return mat


@functools.lru_cache(maxsize=256)
def bilinear_coeff_matrix_fixed(in_size: int, out_size: int) -> np.ndarray:
    """Int32 fixed-point resize matrix replicating Pillow's normalize_coeffs_8bpc."""
    k = bilinear_coeff_matrix(in_size, out_size)
    scaled = k * (1 << PRECISION_BITS)
    # Pillow: (int)(x + 0.5) for x >= 0 else (int)(x - 0.5)  (round half away, trunc)
    fixed = np.where(scaled < 0, np.ceil(scaled - 0.5), np.floor(scaled + 0.5))
    return fixed.astype(np.int64)


def _clip8(acc: np.ndarray) -> np.ndarray:
    """Pillow clip8: >>22 with saturation, negatives -> 0."""
    hi = 1 << (PRECISION_BITS + 8)
    out = np.where(acc <= 0, 0, np.where(acc >= hi, 255 << PRECISION_BITS, acc))
    return (out >> PRECISION_BITS).astype(np.uint8)


def resize_u8_exact(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact PIL BILINEAR (antialias) resize of a uint8 image.

    img: [H, W] or [H, W, C] uint8. Returns same rank with spatial dims resized.
    Matches ``PIL.Image.resize((out_w, out_h), Image.BILINEAR)``: horizontal
    pass first with uint8 intermediate, then vertical pass.
    """
    assert img.dtype == np.uint8
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    half = 1 << (PRECISION_BITS - 1)

    # Horizontal pass: [h, w, c] -> [h, out_w, c]
    if w != out_w:
        kw = bilinear_coeff_matrix_fixed(w, out_w)  # [out_w, w] int64
        acc = np.einsum("hwc,ow->hoc", img.astype(np.int64), kw) + half
        img = _clip8(acc)
    # Vertical pass: [h, out_w, c] -> [out_h, out_w, c]
    if h != out_h:
        kh = bilinear_coeff_matrix_fixed(h, out_h)  # [out_h, h] int64
        acc = np.einsum("hwc,oh->owc", img.astype(np.int64), kh) + half
        img = _clip8(acc)
    return img[:, :, 0] if squeeze else img


def shorter_side_target(h: int, w: int, size: int) -> tuple[int, int]:
    """torchvision Resize(int) rule: scale so the shorter side == size."""
    if w <= h:
        if w == size:
            return h, w
        new_w = size
        new_h = int(size * h / w)
    else:
        if h == size:
            return h, w
        new_h = size
        new_w = int(size * w / h)
    return new_h, new_w


def center_crop_bounds(h: int, w: int, crop: int) -> tuple[int, int]:
    """torchvision CenterCrop offsets (round-half-even via python round)."""
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    return top, left


@functools.lru_cache(maxsize=256)
def fused_resize_crop_matrices(
    in_h: int, in_w: int, resize_size: int, crop: int
) -> tuple[np.ndarray, np.ndarray]:
    """Float32 matrices [crop, in_h], [crop, in_w] computing resize(shorter->
    resize_size) + center-crop(crop) in one pair of matmuls.

    Only the cropped window's rows of the resize matrices are materialized, so
    the device never computes discarded pixels.
    """
    new_h, new_w = shorter_side_target(in_h, in_w, resize_size)
    top, left = center_crop_bounds(new_h, new_w, crop)
    kh = bilinear_coeff_matrix(in_h, new_h)[top : top + crop]
    kw = bilinear_coeff_matrix(in_w, new_w)[left : left + crop]
    return kh.astype(np.float32), kw.astype(np.float32)
