"""Ground-truth labels for coarse and fine matching, homography branch.

Counterpart of geoformer_tpu/train/supervision.py (spvs_coarse /
spvs_fine2 of the reference, fixed shapes throughout). The coarse GT is kept
in its sparse row form: the cycle-consistent one-hot has at most one GT
column per image0 cell, so (gt_j [B, L0], gt_valid [B, L0]) is the whole
[B, L0, L1] matrix. The depth branch waits.
"""

from __future__ import annotations

from typing import Optional

import torch

from geoformer_tpu_torch.geometry.homography import warp_points
from geoformer_tpu_torch.models.coarse_matching import (
    CoarseMatches,
    match_coords,
)


def sparse_coarse_gt_from_warps(w_pt0_c, w_pt1_c, hw0_c, hw1_c):
    """Nearest cell of each warped point (rounded half to even, off-grid ->
    cell 0), kept where the round trip comes back to the same image0 cell;
    cell 0 is never a GT row (the reference's corner guard).

    w_pt0_c: [B, L0, 2] image0 cells warped into image1, in cells;
    w_pt1_c: [B, L1, 2] the reverse. Returns (gt_j [B, L0] int64,
    gt_valid [B, L0] bool)."""
    h0, w0 = hw0_c
    h1, w1 = hw1_c
    l0 = h0 * w0

    def nearest(pts, w, h, n):
        r = torch.round(pts).long()
        idx = r[..., 0] + r[..., 1] * w
        oob = ((r[..., 0] < 0) | (r[..., 0] >= w)
               | (r[..., 1] < 0) | (r[..., 1] >= h))
        return torch.where(oob, torch.zeros_like(idx),
                           torch.clamp(idx, 0, n - 1))

    nearest1 = nearest(w_pt0_c, w1, h1, h1 * w1)                 # [B, L0]
    nearest0 = nearest(w_pt1_c, w0, h0, l0)                      # [B, L1]
    loop_back = torch.gather(nearest0, 1, nearest1)
    correct = loop_back == torch.arange(l0, device=loop_back.device)[None]
    correct[:, 0] = False
    return nearest1, correct


def spvs_coarse_homography_sparse(H_0to1, H_1to0, image_hw,
                                  coarse_scale: int = 8,
                                  mask0: Optional[torch.Tensor] = None,
                                  mask1: Optional[torch.Tensor] = None):
    """Coarse GT of a homography pair in sparse row form: warp each grid
    into the other image, round to cells, keep cycle-consistent rows. Grid
    points of padded cells (mask 0) are moved to the origin first, as in the
    JAX package. Returns (gt_j [B, L0], gt_valid [B, L0])."""
    himg, wimg = image_hw
    h0 = h1 = himg // coarse_scale
    w0 = w1 = wimg // coarse_scale
    l0, l1 = h0 * w0, h1 * w1
    b = H_0to1.shape[0]
    dev = H_0to1.device
    grid0 = match_coords(torch.arange(l0, device=dev), w0,
                         coarse_scale).expand(b, l0, 2)
    grid1 = match_coords(torch.arange(l1, device=dev), w1,
                         coarse_scale).expand(b, l1, 2)
    if mask0 is not None:
        grid0 = grid0 * mask0.reshape(b, l0, 1)
    if mask1 is not None:
        grid1 = grid1 * mask1.reshape(b, l1, 1)
    w_pt0_c = warp_points(grid0, H_0to1) / coarse_scale
    w_pt1_c = warp_points(grid1, H_1to0) / coarse_scale
    return sparse_coarse_gt_from_warps(w_pt0_c, w_pt1_c, (h0, w0), (h1, w1))


def _fine_label_from_warp(w_pt0, kpts1, window: int, dist_thr: float):
    """[B, M, WW, WW] labels: 1 at the window pair of least distance, when
    that distance is in (0, dist_thr]."""
    b, m, ww, _ = w_pt0.shape
    d = torch.sqrt(((w_pt0[:, :, :, None, :] - kpts1[:, :, None, :, :]) ** 2)
                   .sum(-1) + 0.0)                              # [B,M,WW,WW]
    amin = d.reshape(b, m, ww * ww).argmin(-1)
    keep = torch.nn.functional.one_hot(amin, ww * ww).to(d.dtype)
    d = d * keep.reshape(b, m, ww, ww)
    return ((d <= dist_thr) & (d > 0)).float()


def spvs_fine_homography(matches: CoarseMatches, H_0to1, grid_w0: int,
                         grid_w1: int, coarse_scale: int = 8,
                         fine_scale: int = 2, window: int = 5,
                         dist_thr: float = 3.0):
    """Fine window labels: the 5x5 pixel windows around both coarse
    centres, image0's warped through H; the pair of least distance is
    positive iff 0 < d <= 3 px. Returns [B, M, WW, WW] in {0, 1}."""
    b, m = matches.i_ids.shape
    ww = window * window
    r = window // 2
    dev = H_0to1.device
    centers0 = match_coords(matches.i_ids, grid_w0, coarse_scale)
    centers1 = match_coords(matches.j_ids, grid_w1, coarse_scale)
    gy, gx = torch.meshgrid(torch.arange(window, device=dev),
                            torch.arange(window, device=dev), indexing="ij")
    off = torch.stack([gx.reshape(-1) - r, gy.reshape(-1) - r],
                      -1).float() * fine_scale                     # [WW, 2]
    kpts0 = centers0[:, :, None, :] + off[None, None]
    kpts1 = centers1[:, :, None, :] + off[None, None]
    w_pt0 = warp_points(kpts0.reshape(b, m * ww, 2), H_0to1).reshape(
        b, m, ww, 2)
    return _fine_label_from_warp(w_pt0, kpts1, window, dist_thr)
