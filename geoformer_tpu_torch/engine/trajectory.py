"""Trajectory alignment and ATE (absolute trajectory error).

Counterpart of geoformer_tpu/engine/trajectory.py: Umeyama similarity
alignment followed by the RMSE of the camera centres. The SVD and its
products run at full f32 (engine/lie.full_f32); the determinants are
triple products (no LU, no host sync on CUDA).
"""

from __future__ import annotations

from typing import Tuple

import torch

from geoformer_tpu_torch.engine.lie import det3, full_f32


def align_umeyama(est: torch.Tensor, gt: torch.Tensor,
                  with_scale: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares similarity aligning est -> gt.

    Args:
        est, gt: [N, 3] camera centres.
    Returns:
        (s, R, t) with gt ~ s * R @ est + t (s a 0-d tensor).
    """
    with full_f32():
        mu_e = est.mean(0)
        mu_g = gt.mean(0)
        xe = est - mu_e
        xg = gt - mu_g
        cov = (xg.T @ xe) / est.shape[0]
        U, D, Vt = torch.linalg.svd(cov)
        det = det3(U) * det3(Vt)
        sign = torch.where(det < 0, -torch.ones_like(det),
                           torch.ones_like(det))
        diag = torch.stack([torch.ones_like(sign), torch.ones_like(sign),
                            sign])
        R = U @ torch.diag(diag) @ Vt
        var_e = (xe ** 2).sum() / est.shape[0]
        s = ((D * diag).sum() / var_e if with_scale
             else torch.ones((), dtype=est.dtype, device=est.device))
        t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: torch.Tensor, gt: torch.Tensor,
             align: bool = True) -> torch.Tensor:
    """RMSE of camera-centre error after (optional) similarity alignment."""
    if align:
        s, R, t = align_umeyama(est, gt)
        with full_f32():
            est = s * est @ R.T + t
    return torch.sqrt(((est - gt) ** 2).sum(-1).mean())


def camera_centers(cams: torch.Tensor) -> torch.Tensor:
    """World->cam [N, 4, 4] -> camera centres [N, 3] (-R^T t)."""
    R = cams[:, :3, :3]
    t = cams[:, :3, 3]
    return -torch.einsum("nij,ni->nj", R, t)
