"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Counterpart of geoformer_tpu/engine/pnp.py, batched over the hypotheses
instead of vmapped: 6-point samples (Gumbel top-6 over the valid entries)
-> a DLT pose and a planar (plane-homography) pose per sample, 2 x iters
hypotheses in one batch -> scored by reprojection inliers, the first of
equal counts kept -> both solvers refit on the inliers -> Gauss-Newton on
se(3) (torch.func.jacfwd of the residual at xi = 0).

The random draws cannot be JAX's: a caller may inject the samples
(``sample_idx`` [iters, 6]), as the parity tests do, or they come from a
torch.Generator on the points' device. A minimal fit reads only its 6
gathered points, which is the JAX fit's sum over all points with the
others weighted 0. Every solve runs at full f32 (engine/lie.full_f32).
On CUDA each batched eigh and svd checks its status on the host: a call
synchronises at each of them (the solves do not check: a singular system
gives NaN, as in JAX, and the step is not taken).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from geoformer_tpu_torch.engine.lie import det3, full_f32, se3_exp
from geoformer_tpu_torch.geometry.ransac import gumbel_sample_idx

SAMPLE_N = 6


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] from R [..., 3, 3] and t [..., 3]."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def _normal_eigvec(r1: torch.Tensor, r2: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """The smallest eigenvector of A^T A, A = [r1; r2] rows scaled by
    sqrt(w): r1, r2 [B, m, k], w [B, m] -> [B, k]."""
    sw = torch.sqrt(torch.clamp(w, min=0.0))[..., None]
    A = torch.cat([r1 * sw, r2 * sw], dim=-2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return vecs[..., :, 0]


def _dlt_pose(pts3d: torch.Tensor, uv_norm: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT for the 3x4 projection [R|t] from normalized image
    coordinates, made rigid by SVD orthogonalization: pts3d [B, m, 3],
    uv_norm [B, m, 2], w [B, m] -> T [B, 4, 4]."""
    X, Y, Z = pts3d.unbind(-1)
    u, v = uv_norm.unbind(-1)
    zeros = torch.zeros_like(X)
    ones = torch.ones_like(X)
    r1 = torch.stack([X, Y, Z, ones, zeros, zeros, zeros, zeros,
                      -u * X, -u * Y, -u * Z, -u], -1)
    r2 = torch.stack([zeros, zeros, zeros, zeros, X, Y, Z, ones,
                      -v * X, -v * Y, -v * Z, -v], -1)
    P = _normal_eigvec(r1, r2, w).reshape(-1, 3, 4)
    # fix sign: points must be in front (positive depth on average)
    depths = (pts3d * P[:, None, 2, :3]).sum(-1) + P[:, 2, 3:]
    P = P * torch.where((depths * w).sum(-1) < 0, -1.0, 1.0)[:, None, None]
    # closest rotation to the left 3x3
    U, S, Vh = torch.linalg.svd(P[:, :, :3])
    R = U @ Vh
    sign = torch.sign(det3(R))
    R = R * sign[:, None, None]
    scale = S.mean(-1) * sign
    t = P[:, :, 3] / torch.where(scale.abs() < 1e-12,
                                 torch.full_like(scale, 1e-12),
                                 scale)[:, None]
    return _rigid(R, t)


def _homography_pose(pts3d: torch.Tensor, uv_norm: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Pose from near-coplanar 2D-3D matches by plane-homography
    decomposition (the IPPE case): the 6-point DLT is rank-deficient when
    the sampled points are coplanar, so RANSAC scores both solvers.

    Fits a plane to the weighted points, maps plane coordinates to
    normalized image coordinates with a weighted homography DLT, and reads
    the pose off H = s * [R e1, R e2, R mu + t]. Shapes as _dlt_pose."""
    wsum = w.sum(-1) + 1e-9
    mu = (pts3d * w[..., None]).sum(-2) / wsum[:, None]
    d = pts3d - mu[:, None]
    C = (d * w[..., None]).transpose(-1, -2) @ d
    _, evecs = torch.linalg.eigh(C)                  # ascending eigenvalues
    e1, e2 = evecs[..., :, 2], evecs[..., :, 1]      # in-plane basis
    x = (d * e1[:, None]).sum(-1)                    # plane coordinates
    y = (d * e2[:, None]).sum(-1)
    u, v = uv_norm.unbind(-1)
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    r1 = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u],
                     -1)
    r2 = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v],
                     -1)
    H = _normal_eigvec(r1, r2, w).reshape(-1, 3, 3)
    # sign: the plane centroid (plane coordinates 0) has positive depth
    H = H * torch.where(H[:, 2, 2] < 0, -1.0, 1.0)[:, None, None]
    U, S, Vh = torch.linalg.svd(H[:, :, :2], full_matrices=False)
    R12 = U @ Vh                                     # closest orthonormal
    scale = S.mean(-1)
    c0, c1 = R12[..., 0], R12[..., 1]
    R_cp = torch.stack([c0, c1, torch.linalg.cross(c0, c1)], -1)
    t_cam = H[:, :, 2] / torch.where(scale < 1e-12,
                                     torch.full_like(scale, 1e-12),
                                     scale)[:, None]
    E = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], -1)
    R_w2c = R_cp @ E.transpose(-1, -2)
    t_w2c = t_cam - (R_w2c @ mu[..., None])[..., 0]
    return _rigid(R_w2c, t_w2c)


def _reproj_norm(T: torch.Tensor, pts3d: torch.Tensor,
                 uv_norm: torch.Tensor) -> torch.Tensor:
    """Reprojection distances of pts3d [N, 3] under poses T [B, 4, 4] to
    uv_norm [N, 2]: [B, N]. The norm is sqrt of the sum of squares, as
    jnp.linalg.norm computes it (so its derivative at 0 is NaN there too).
    """
    pc = torch.einsum("bij,nj->bni", T[:, :3, :3], pts3d) + T[:, None, :3, 3]
    z = pc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    proj = pc[..., :2] / z[..., None]
    return torch.sqrt(((proj - uv_norm) ** 2).sum(-1))


def pnp_ransac(pts3d: torch.Tensor, uv: torch.Tensor, K: torch.Tensor,
               valid: torch.Tensor, thr_px: float = 4.0, iters: int = 256,
               refine_iters: int = 5, min_valid: int = 6,
               sample_idx: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """Robust world->camera pose from capacity-padded 2D-3D matches.

    Args:
        pts3d [N, 3], uv [N, 2] pixels, K [3, 3], valid [N] bool, on one
            device and (but ``valid``) in one float dtype.
        sample_idx: optional [iters, 6] samples; drawn by gumbel_sample_idx
            from ``generator`` when absent.
    Returns dict with 'T' [4, 4], 'inliers' [N], 'num_inliers', 'ok'.
    """
    with full_f32():
        return _pnp_ransac(pts3d, uv, K, valid, thr_px, iters, refine_iters,
                           min_valid, sample_idx, generator)


def _pnp_ransac(pts3d, uv, K, valid, thr_px, iters, refine_iters, min_valid,
                sample_idx, generator):
    dtype = pts3d.dtype
    f = (K[0, 0] + K[1, 1]) / 2
    uv_norm = (uv - K[:2, 2]) / torch.stack([K[0, 0], K[1, 1]])
    thr = thr_px / f
    eye4 = torch.eye(4, dtype=dtype, device=pts3d.device)

    if sample_idx is None:
        sample_idx = gumbel_sample_idx(valid[None], iters, generator,
                                       k=SAMPLE_N)[0]
    w_s = valid[sample_idx].to(dtype)                     # [iters, 6]
    p_s, u_s = pts3d[sample_idx], uv_norm[sample_idx]
    # (DLT, planar) per sample, in the JAX order: [iters, 2] -> [2 iters]
    Ts = torch.stack([_dlt_pose(p_s, u_s, w_s),
                      _homography_pose(p_s, u_s, w_s)], 1).reshape(-1, 4, 4)
    errs = _reproj_norm(Ts, pts3d, uv_norm)
    inl = (errs < thr) & valid[None, :]
    finite = torch.isfinite(Ts).all(-1).all(-1)
    counts = torch.where(finite, inl.sum(-1), -1)
    best = torch.argmax(counts)                   # the first of equal counts
    T = Ts[best]
    T = torch.where(torch.isfinite(T).all(), T, eye4)
    inliers = inl[best]

    # refit on the inliers (both solvers), then Gauss-Newton on se(3)
    w = inliers.to(dtype) * valid

    def score(Tc):
        good = torch.isfinite(Tc).all() & (w.sum() >= 6)
        cnt = ((_reproj_norm(Tc[None], pts3d, uv_norm)[0] < thr)
               & valid).sum()
        return torch.where(good, cnt, -1)

    T_dlt = _dlt_pose(pts3d[None], uv_norm[None], w[None])[0]
    T_h = _homography_pose(pts3d[None], uv_norm[None], w[None])[0]
    # refits first: argmax keeps the first maximum, so an all-inlier refit
    # that matches the minimal-sample pose's count is preferred
    cands = torch.stack([T_dlt, T_h, T])
    scores = torch.stack([score(T_dlt), score(T_h), inliers.sum()])
    T = cands[torch.argmax(scores)]
    T = torch.where(torch.isfinite(T).all(), T, eye4)

    xi0 = torch.zeros(6, dtype=dtype, device=pts3d.device)
    eye6 = torch.eye(6, dtype=dtype, device=pts3d.device)
    for _ in range(refine_iters):
        def resid(xi, T=T):
            Tn = se3_exp(xi) @ T
            return _reproj_norm(Tn[None], pts3d, uv_norm)[0] * w

        r = resid(xi0)
        J = torch.func.jacfwd(resid)(xi0)                    # [N, 6]
        H = J.T @ J + 1e-8 * eye6
        dx = torch.linalg.solve_ex(H, -(J.T @ r))[0]
        T_new = se3_exp(dx) @ T
        r_new = _reproj_norm(T_new[None], pts3d, uv_norm)[0] * w
        T = torch.where((r ** 2).sum() > r_new @ r_new, T_new, T)

    inliers = (_reproj_norm(T[None], pts3d, uv_norm)[0] < thr) & valid
    ok = (valid.sum() >= min_valid) & (inliers.sum() >= 6) & \
        torch.isfinite(T).all()
    return {"T": T, "inliers": inliers, "num_inliers": inliers.sum(),
            "ok": ok}
