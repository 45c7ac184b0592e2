"""Bilinear resize with aligned corners.

Counterpart of geoformer_tpu/ops/resize.py, which applies 1-D interpolation
matrices because jax.image.resize has no align_corners mode; here
F.interpolate(align_corners=True) computes the same function.
"""

from __future__ import annotations

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
