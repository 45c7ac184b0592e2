"""Bilinear resizes.

Bilinear with aligned corners (the backbone's upsampling): counterpart of
geoformer_tpu/ops/resize.py, which applies 1-D interpolation matrices
because jax.image.resize has no align_corners mode; here
F.interpolate(align_corners=True) computes the same function.

resize_linear_u8: cv2.resize's INTER_LINEAR on uint8 images, which the JAX
package calls to size images read from files (eval/matcher.py,
data/synthetic.py); the port has no cv2. resize_linear: the same on
uint8 or float images, with or without a channel axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear_align_corners_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """[B, C, h, w] -> [B, C, oh, ow]."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """[B, h, w, C] -> [B, oh, ow, C], the JAX package's layout."""
    y = resize_bilinear_align_corners_nchw(x.permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1)


# cv2's fixed-point bilinear weights: 11 fraction bits a pass.
_COEF_SCALE = 1 << 11


def _linear_frac(dst: int, src: int, clamp_weights: bool):
    """Source indices (i0, i1) and f32 fractions f of cv2's INTER_LINEAR
    along one axis (weights 1 - f and f): pixel centres at half-integers,
    f32 positions. Along x a position off the source is clamped with its
    weight (one tap); along y only the rows are clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp_weights:
        f[(i0 < 0) | (i0 >= src - 1)] = 0
        i0 = np.clip(i0, 0, src - 1)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), f


def _linear_taps(dst: int, src: int, clamp_weights: bool):
    """_linear_frac's taps with the weights rounded to 11 bits."""
    i0, i1, f = _linear_frac(dst, src, clamp_weights)
    scale_f = np.float32(_COEF_SCALE)
    w0 = np.rint((np.float32(1) - f) * scale_f).astype(np.int64)
    w1 = np.rint(f * scale_f).astype(np.int64)
    return i0, i1, w0, w1


def resize_linear_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """Resize a [h, w] uint8 image to out_hw = (oh, ow) as
    ``cv2.resize(img, (ow, oh))`` does (INTER_LINEAR), on the host.

    cv2's arithmetic is reproduced: a horizontal pass with 11-bit integer
    weights, then the vertical pass as cv2's SIMD loop computes it (each
    row sum cut by 4 bits, multiplied by its weight keeping the high 16
    bits, the two added and rounded by 2 bits; this differs by a grey
    level here and there from exact rounding, and cv2 5.0 uses it for
    every column). An exact halving of both sides is a 2x2 box average
    (cv2 switches to INTER_AREA there); any other downscale stays
    bilinear, not area-averaged."""
    h, w = img.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return img.copy()
    src = img.astype(np.int64)
    if (h, w) == (2 * oh, 2 * ow):
        box = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] \
            + src[1::2, 1::2]
        return ((box + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(ow, w, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(oh, h, clamp_weights=False)
    rows = src[:, x0] * a0 + src[:, x1] * a1          # [h, ow], <= 2^19
    r0, r1 = rows[y0], rows[y1]
    b0, b1 = b0[:, None], b1[:, None]
    out = ((((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_linear_float(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize INTER_LINEAR of a [h, w] float image, in its dtype: the
    taps of _linear_frac with weights (1 - f, f) unrounded, a horizontal
    pass then a vertical one; an exact halving of both sides is the mean
    of each 2x2 block."""
    h, w = img.shape
    oh, ow = out_hw
    dt = img.dtype.type
    if (h, w) == (2 * oh, 2 * ow):
        return ((img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2]
                 + img[1::2, 1::2]) * dt(0.25)).astype(img.dtype)

    x0, x1, a = _linear_frac(ow, w, True)
    y0, y1, b = _linear_frac(oh, h, False)
    a, b = a.astype(img.dtype), b.astype(img.dtype)[:, None]
    rows = img[:, x0] * (dt(1) - a) + img[:, x1] * a
    return (rows[y0] * (dt(1) - b) + rows[y1] * b).astype(img.dtype)


def resize_linear(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (ow, oh))`` (INTER_LINEAR) of a [h, w] or
    [h, w, C] uint8 or float image, each channel alone."""
    if img.ndim == 3:
        return np.stack([resize_linear(img[..., c], out_hw)
                         for c in range(img.shape[2])], -1)
    if tuple(out_hw) == img.shape:
        return img.copy()
    if img.dtype == np.uint8:
        return resize_linear_u8(img, out_hw)
    if not np.issubdtype(img.dtype, np.floating):
        raise TypeError(f"resize_linear takes uint8 or float, not "
                        f"{img.dtype}")
    return _resize_linear_float(img, out_hw)
