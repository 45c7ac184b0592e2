"""Depth-based keypoint warping and epipolar geometry.

Counterpart of geoformer_tpu/geometry/depth.py: a keypoint of image0 is
lifted by its depth through K0^-1, moved by T_0to1 and projected by K1;
it is valid where it lies on depth0's map and its depth there is nonzero,
it lands inside image1, and image1's depth there is nonzero and agrees
with the computed one within 0.2 (relative). Two of these rules are the
published warp_kpts's (loftr_src/loftr/utils/geometry.py) and not the JAX
package's: a keypoint off the map is invalid (the JAX package reads the
nearest border pixel's depth; the published indexing reads the padding of
the padded map, whose depth is 0), and so is one that lands where image1
has no depth (the JAX package counts it consistent; the published ratio
(0 - z) / 0 is infinite there).
The 3x3 products are written out as elementwise sums in f32, so that no
TF32 matmul can move the cells that the rounding picks; the JAX package
runs them at Precision.HIGHEST.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _mat_vec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M [B, 3, 3] applied to rows x [B, L, 3] -> [B, L, 3], f32 sums."""
    return (M[:, None, :, :] * x[:, :, None, :]).sum(-1)


def _sample(depth: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """depth [B, H, W] at the rounded (half to even) and clipped pixel of
    pts [B, L, 2] -> [B, L]."""
    h, w = depth.shape[1:3]
    x = torch.clamp(torch.round(pts[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(pts[..., 1]).long(), 0, h - 1)
    return torch.gather(depth.reshape(depth.shape[0], -1), 1, y * w + x)


def warp_kpts_depth(kpts0: torch.Tensor, depth0: torch.Tensor,
                    depth1: torch.Tensor, T_0to1: torch.Tensor,
                    K0: torch.Tensor, K1: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp pixel keypoints from image0 to image1 by depth and relative pose.

    kpts0: [B, L, 2] (x, y) pixels; depth0/depth1: [B, H, W];
    T_0to1: [B, 4, 4] (or [B, 3, 4]); K0/K1: [B, 3, 3].
    Returns (valid [B, L] bool, w_kpts0 [B, L, 2])."""
    h, w = depth0.shape[1:3]
    d0 = _sample(depth0, kpts0)                                   # [B, L]
    r = torch.round(kpts0)
    nonzero = (d0 != 0) & (r[..., 0] >= 0) & (r[..., 0] < w) \
        & (r[..., 1] >= 0) & (r[..., 1] < h)
    ones = torch.ones_like(kpts0[..., :1])
    kpts0_h = torch.cat([kpts0, ones], -1) * d0[..., None]        # [B, L, 3]
    cam0 = _mat_vec(torch.linalg.inv(K0), kpts0_h)
    cam1 = _mat_vec(T_0to1[:, :3, :3], cam0) + T_0to1[:, None, :3, 3]
    z_computed = cam1[..., 2]
    proj = _mat_vec(K1, cam1)
    w_kpts0 = proj[..., :2] / (proj[..., 2:] + 1e-4)
    covis = ((w_kpts0[..., 0] > 0) & (w_kpts0[..., 0] < w - 1)
             & (w_kpts0[..., 1] > 0) & (w_kpts0[..., 1] < h - 1))
    # out-of-view points sample depth at (0, 0), as the reference does
    safe = torch.where(covis[..., None], w_kpts0,
                       torch.zeros_like(w_kpts0))
    d1 = _sample(depth1, torch.floor(safe))
    den = torch.where(d1 == 0, torch.ones_like(d1), d1)
    consistent = (d1 != 0) & (torch.abs((d1 - z_computed) / den) < 0.2)
    return nonzero & covis & consistent, w_kpts0


def essential_from_pose(T_0to1: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R of relative poses [B, 4, 4] -> [B, 3, 3]."""
    t = T_0to1[:, :3, 3]
    R = T_0to1[:, :3, :3]
    zeros = torch.zeros_like(t[:, 0])
    Tx = torch.stack([
        torch.stack([zeros, -t[:, 2], t[:, 1]], -1),
        torch.stack([t[:, 2], zeros, -t[:, 0]], -1),
        torch.stack([-t[:, 1], t[:, 0], zeros], -1),
    ], dim=1)
    return (Tx[:, :, :, None] * R[:, None, :, :]).sum(2)


def symmetric_epipolar_distance(pts0: torch.Tensor, pts1: torch.Tensor,
                                E: torch.Tensor, K0: torch.Tensor,
                                K1: torch.Tensor) -> torch.Tensor:
    """Squared symmetric epipolar distance in normalized coordinates,
    batched: pts [B, L, 2], E/K [B, 3, 3] -> [B, L]."""
    def norm(p, K):
        c = K[:, None, :2, 2]
        f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None]
        q = (p - c) / f
        return torch.cat([q, torch.ones_like(q[..., :1])], -1)

    p0h, p1h = norm(pts0, K0), norm(pts1, K1)
    Ep0 = _mat_vec(E, p0h)                                        # p0h @ E.T
    p1Ep0 = (p1h * Ep0).sum(-1)
    Etp1 = _mat_vec(E.transpose(1, 2), p1h)                       # p1h @ E
    return p1Ep0 ** 2 * (
        1.0 / (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + 1e-12)
        + 1.0 / (Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2 + 1e-12))


def relative_pose_error(T_0to1, R, t, ignore_gt_t_thr: float = 0.0):
    """Angular (t_err, R_err) in degrees of a pose against the ground
    truth, on the host (numpy)."""
    t_gt = np.asarray(T_0to1)[:3, 3]
    nrm = np.linalg.norm(t) * np.linalg.norm(t_gt)
    t_err = np.rad2deg(np.arccos(np.clip(np.dot(t, t_gt) / max(nrm, 1e-12),
                                         -1.0, 1.0)))
    t_err = np.minimum(t_err, 180 - t_err)
    if np.linalg.norm(t_gt) < ignore_gt_t_thr:
        t_err = 0.0
    R_gt = np.asarray(T_0to1)[:3, :3]
    cos = np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1.0, 1.0)
    return float(t_err), float(np.rad2deg(np.abs(np.arccos(cos))))
