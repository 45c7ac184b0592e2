"""A synthetic image pair with a known homography, made from a seed.

Used by chip_smoke.py and the profiling script, whose inputs are made, not
read: a multi-scale noise texture (numpy draws, torch upsampling) and its
warp by a known homography.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

H_TRUE = np.array([[0.95, 0.05, 12.0], [-0.04, 0.98, -6.0],
                   [1e-5, 2e-5, 1.0]])


def textured_pair(hw, seed: int, H: np.ndarray = H_TRUE):
    """(img0, img1) float32 [h, w] arrays in [0, 1] with
    img1(p) = img0(H^-1 p) (bilinear, zeros outside)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    img = torch.zeros((1, 1, h, w))
    for cell, weight in ((64, 1.0), (16, 0.6), (4, 0.3)):
        lo = torch.from_numpy(rng.random(
            (1, 1, h // cell + 4, w // cell + 4)).astype(np.float32))
        up = F.interpolate(lo, scale_factor=cell, mode="bicubic")
        img += weight * up[..., :h, :w]
    img = (img - img.min()) / (img.max() - img.min())
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ torch.from_numpy(
        np.linalg.inv(H)).T
    src = p[..., :2] / p[..., 2:]
    grid = torch.stack([2 * src[..., 0] / (w - 1) - 1,
                        2 * src[..., 1] / (h - 1) - 1], -1)[None].float()
    warped = F.grid_sample(img, grid, align_corners=True)
    return img[0, 0].numpy(), warped[0, 0].numpy()
