"""Batched RANSAC + DLT homography estimation.

Counterpart of geoformer_tpu/geometry/ransac.py, batched over B instead of
vmapped: 4-point minimal samples (Gumbel top-4 over the valid entries) ->
batched exact 8x8 solves -> MSAC (truncated quadratic) scoring of the
forward reprojection -> best hypothesis -> annealed IRLS polish by weighted
normalized DLT, accepted by MSAC cost. Every shape is fixed: points arrive
capacity-padded with a validity mask.

The random draws cannot be JAX's: a caller may inject the hypotheses'
sample indices (``sample_idx``), as the parity tests do; otherwise the
Gumbel draw's uniforms come from a fixed ``noise`` tensor, as the serving
bundle bakes one in, or from a torch.Generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from geoformer_tpu_torch.geometry.homography import (
    four_point_homography,
    warp_points,
)


def _normalization(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalization transforms [B, 3, 3] of pts [B, N, 2] under
    weights [B, N]."""
    wsum = torch.clamp(w.sum(-1), min=1e-8)
    mean = (pts * w[..., None]).sum(1) / wsum[:, None]            # [B, 2]
    d = torch.sqrt(((pts - mean[:, None]) ** 2).sum(-1) + 1e-12)
    scale = math.sqrt(2.0) / torch.clamp((d * w).sum(-1) / wsum, min=1e-8)
    T = torch.zeros((pts.shape[0], 3, 3), dtype=pts.dtype, device=pts.device)
    T[:, 0, 0] = scale
    T[:, 1, 1] = scale
    T[:, 0, 2] = -scale * mean[:, 0]
    T[:, 1, 2] = -scale * mean[:, 1]
    T[:, 2, 2] = 1.0
    return T


def dlt_homography(pts0, pts1, weights) -> torch.Tensor:
    """Weighted normalized DLT, least-squares H with pts1 ~ H pts0.
    pts0, pts1: [B, N, 2]; weights: [B, N] >= 0. Returns [B, 3, 3]."""
    T0 = _normalization(pts0, weights)
    T1 = _normalization(pts1, weights)
    p0 = warp_points(pts0, T0)
    p1 = warp_points(pts1, T1)
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], -1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], -1)
    sw = torch.sqrt(torch.clamp(weights, min=0.0))[..., None]
    A = torch.cat([ax * sw, ay * sw], dim=1)                       # [B, 2N, 9]
    AtA = A.transpose(1, 2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    Hn = vecs[..., :, 0].reshape(-1, 3, 3)
    H = torch.linalg.inv_ex(T1)[0] @ Hn @ T0
    h22 = H[:, 2, 2]
    denom = torch.where(h22.abs() < 1e-12, torch.ones_like(h22), h22)
    return H / denom[:, None, None]


def _reproj_err2(H, pts0, pts1) -> torch.Tensor:
    """|H p0 - p1|^2; H [B, K, 3, 3] against pts [B, N, 2] -> [B, K, N]."""
    w = warp_points(pts0[:, None], H)
    return ((w - pts1[:, None]) ** 2).sum(-1)


def gumbel_sample_idx(valid: torch.Tensor, iters: int,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, iters, 4] minimal samples: Gumbel top-4 over the valid entries,
    from uniforms in [0, 1) drawn from ``generator`` or given as ``noise``
    [B, iters, N]."""
    b, n = valid.shape
    if noise is None:
        u = torch.rand((b, iters, n), generator=generator,
                       device=valid.device)
    elif tuple(noise.shape) != (b, iters, n):
        raise ValueError(f"RANSAC noise {tuple(noise.shape)}, expected "
                         f"{(b, iters, n)}")
    else:
        u = noise
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    g = torch.where(valid[:, None, :], g, torch.full_like(g, float("-inf")))
    return torch.topk(g, 4, dim=-1).indices


def ransac_homography(pts0, pts1, valid, thr: float = 3.0, iters: int = 512,
                      refine_iters: int = 2, min_valid: int = 4,
                      sample_idx: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Robust homography fit on capacity-padded correspondences.

    Args:
        pts0, pts1: [B, N, 2]; valid: [B, N] bool.
        sample_idx: optional [B, iters, 4] hypothesis samples; drawn by
            gumbel_sample_idx from ``noise`` or ``generator`` when absent.
    Returns:
        dict with 'H' [B, 3, 3], 'inliers' [B, N], 'num_inliers' [B],
        'ok' [B] (>= min_valid inputs, >= 4 inliers, finite H).
    """
    b, n = valid.shape
    validf = valid.float()
    if sample_idx is None:
        sample_idx = gumbel_sample_idx(valid, iters, generator, noise)
    bidx = torch.arange(b, device=valid.device)[:, None, None]
    s0 = pts0[bidx, sample_idx]                            # [B, K, 4, 2]
    s1 = pts1[bidx, sample_idx]
    Hs = four_point_homography(s0, s1)                     # [B, K, 3, 3]
    finite = torch.isfinite(Hs).all(dim=-1).all(dim=-1)    # [B, K]

    err2 = _reproj_err2(Hs, pts0, pts1)                    # [B, K, N]
    t2 = float(thr * thr)
    inl = (err2 < t2) & valid[:, None, :]
    cost = (torch.clamp(err2, max=t2) * validf[:, None, :]).sum(-1)
    cost = torch.where(finite, cost, torch.full_like(cost, float("inf")))
    best = cost.argmin(dim=1)                              # [B]
    ar = torch.arange(b, device=valid.device)
    H = Hs[ar, best]
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand_as(H)
    H = torch.where(torch.isfinite(H).all(-1).all(-1)[:, None, None], H, eye)
    inliers = inl[ar, best]

    def msac(Hc):
        e2 = _reproj_err2(Hc[:, None], pts0, pts1)[:, 0]
        return (torch.clamp(e2, max=t2) * validf).sum(-1)

    for i in range(refine_iters):
        m = min(2.0 ** (refine_iters - 1 - i), 4.0)
        e2 = _reproj_err2(H[:, None], pts0, pts1)[:, 0]
        w = ((e2 < t2 * m * m) & valid).float() * validf
        H_new = dlt_homography(pts0, pts1, w)
        good = torch.isfinite(H_new).all(-1).all(-1) & (w.sum(-1) >= 4)
        H_new = torch.where(good[:, None, None], H_new, H)
        new_inl = (_reproj_err2(H_new[:, None], pts0, pts1)[:, 0] < t2) & valid
        keep = msac(H_new) <= msac(H)
        H = torch.where(keep[:, None, None], H_new, H)
        inliers = torch.where(keep[:, None], new_inl, inliers)

    num_inliers = inliers.sum(-1)
    ok = (valid.sum(-1) >= min_valid) & (num_inliers >= 4) & \
        torch.isfinite(H).all(-1).all(-1)
    return {"H": H, "inliers": inliers, "num_inliers": num_inliers, "ok": ok}
