"""Essential-matrix RANSAC and relative pose, on the device.

Counterpart of geoformer_tpu/geometry/essential.py, batched over the pairs
and the hypotheses instead of vmapped:

    12-point samples (Gumbel top-12 over the valid entries) -> weighted
    8-point fits (eigh of A^T A, projected to singular values (1, 1, 0))
    -> Sampson scoring, leaders ranked by their capture at twice the
    threshold -> LO-RANSAC on the top 16 (re-fits on the capture at 4, 2,
    1, 1 times the threshold, kept when they keep as many inliers) -> the
    4-way decomposition with a cheirality vote.

Points arrive capacity-padded with a validity mask, normalized by the
intrinsics. The random draws cannot be JAX's: a caller may inject the
samples (``sample_idx`` [B, iters, 12]), as the parity tests do, or they
come from a torch.Generator on the points' device. Every product is an
elementwise sum in the points' dtype (no TF32 matmul), and no constant is
copied from the host. Batched eigh and svd on CUDA check their solver's
status on the host: a fit synchronises at each of its 5 eigh and 6 svd
calls.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from geoformer_tpu_torch.geometry.ransac import gumbel_sample_idx

SAMPLE_N = 12     # points of a hypothesis
K_LO = 16         # leaders refined by LO-RANSAC


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _rows(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ M.T for M [..., 3, 3] and rows x [..., N, 3] -> [..., N, 3]."""
    return (M[..., None, :, :] * x[..., :, None, :]).sum(-1)


def _matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for [..., 3, 3] matrices, as an elementwise sum."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def eight_point_essential(p0: torch.Tensor, p1: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point essential matrices with singular values (1, 1, 0).

    p0, p1: [..., N, 2] normalized points; w: [..., N] >= 0 weights.
    Returns [..., 3, 3]."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                     x0, y0, torch.ones_like(x0)], -1)            # [..., N, 9]
    A = A * torch.sqrt(torch.clamp(w, min=0.0))[..., None]
    AtA = (A[..., :, :, None] * A[..., :, None, :]).sum(-3)      # [..., 9, 9]
    _, vecs = torch.linalg.eigh(AtA)
    E = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    U, _, Vh = torch.linalg.svd(E)
    # U diag(1, 1, 0) Vh: the third singular pair drops out
    return (U[..., :, :2, None] * Vh[..., None, :2, :]).sum(-2)


def sampson_err2(E: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Squared Sampson distance of x1^T E x0 = 0: E [..., 3, 3] against
    points [..., N, 2] (broadcast over the leading axes) -> [..., N]."""
    h0, h1 = _homog(p0), _homog(p1)
    Ex0 = _rows(E, h0)                                            # h0 @ E.T
    Etx1 = _rows(E.transpose(-1, -2), h1)                         # h1 @ E
    num = (h1 * Ex0).sum(-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 \
        + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=eps)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinants of [..., 3, 3] matrices, by the triple product."""
    return (M[..., :, 0] * torch.linalg.cross(M[..., :, 1],
                                              M[..., :, 2])).sum(-1)


def decompose_essential(E: torch.Tensor):
    """The four (R, t) candidates of essential matrices [..., 3, 3]:
    Rs [..., 4, 3, 3] (det +1), ts [..., 4, 3] unit translations."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(_det3(U))[..., None, None]
    Vh = Vh * torch.sign(_det3(Vh))[..., None, None]
    u0, u1, u2 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    # U W and U W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    R1 = _matmul3(torch.stack([u1, -u0, u2], -1), Vh)
    R2 = _matmul3(torch.stack([-u1, u0, u2], -1), Vh)
    t = u2
    return (torch.stack([R1, R1, R2, R2], -3),
            torch.stack([t, -t, t, -t], -2))


def _depths(R: torch.Tensor, t: torch.Tensor, p0: torch.Tensor,
            p1: torch.Tensor, eps: float = 1e-12):
    """Least-squares depths (z0, z1) with z0 (R x0) + t = z1 x1 along the
    bearing rays: R [..., 3, 3], t [..., 3], points [..., N, 2]; the
    cheirality vote's triangulation."""
    x0, x1 = _homog(p0), _homog(p1)
    a = _rows(R, x0)                                              # x0 @ R.T
    aa = (a * a).sum(-1)
    bb = (x1 * x1).sum(-1)
    ab = (a * x1).sum(-1)
    at = (a * t[..., None, :]).sum(-1)
    bt = (x1 * t[..., None, :]).sum(-1)
    det = torch.clamp(aa * bb - ab * ab, min=eps)
    return (-at * bb + ab * bt) / det, (aa * bt - ab * at) / det


def _gather_pts(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p [B, N, 2] at idx [B, K, S] -> [B, K, S, 2]."""
    b = p.shape[0]
    return p[torch.arange(b, device=p.device)[:, None, None], idx]


def ransac_essential(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor,
                     thr, iters: int = 512, refine_iters: int = 2,
                     min_valid: int = 5,
                     sample_idx: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """Robust essential-matrix fit and pose of B padded correspondence sets.

    p0, p1: [B, N, 2] normalized points; valid: [B, N] bool; thr: the
    Sampson threshold in normalized units, a float or [B] (pixel threshold
    over the mean focal length); sample_idx: optional [B, iters, 12].
    Returns dict with 'E' [B, 3, 3], 'R' [B, 3, 3], 't' [B, 3], 'inliers'
    [B, N] (cheirality-filtered), 'num_inliers' [B], 'ok' [B]."""
    b, n = valid.shape
    dev = p0.device
    ar = torch.arange(b, device=dev)
    thr = torch.as_tensor(thr, dtype=p0.dtype, device=dev).expand(b)
    thr_b = thr[:, None, None]                                    # [B, 1, 1]
    validf = valid.to(p0.dtype)
    if sample_idx is None:
        sample_idx = gumbel_sample_idx(valid, iters, generator, k=SAMPLE_N)
    s0, s1 = _gather_pts(p0, sample_idx), _gather_pts(p1, sample_idx)
    Es = eight_point_essential(s0, s1, torch.ones_like(s0[..., 0]))
    finite = torch.isfinite(Es).all(-1).all(-1)                   # [B, K]

    # leaders ranked by their capture at twice the threshold
    err2 = sampson_err2(Es, p0[:, None], p1[:, None])             # [B, K, N]
    inl = (err2 < thr_b * thr_b) & valid[:, None]
    wide = (err2 < (2 * thr_b) ** 2) & valid[:, None]
    counts = torch.where(finite, wide.sum(-1), torch.full_like(
        finite, -1, dtype=torch.long))
    k_lo = min(K_LO, Es.shape[1])
    # lax.top_k order: ties to the lower index
    top = torch.sort(counts, dim=1, descending=True,
                     stable=True).indices[:, :k_lo]               # [B, k_lo]
    E = Es[ar[:, None], top]                                      # [B, k, 3, 3]
    inliers = inl[ar[:, None], top]                               # [B, k, N]
    eye = torch.eye(3, dtype=E.dtype, device=dev).expand_as(E)
    E = torch.where(torch.isfinite(E).all(-1).all(-1)[..., None, None],
                    E, eye)

    q0, q1 = p0[:, None], p1[:, None]
    vk = valid[:, None]
    for mult in [4.0, 2.0] + [1.0] * refine_iters:
        cap = (sampson_err2(E, q0, q1) < (mult * thr_b) ** 2) & vk
        w = cap.to(p0.dtype) * validf[:, None]
        E_new = eight_point_essential(q0.expand(-1, k_lo, -1, -1),
                                      q1.expand(-1, k_lo, -1, -1), w)
        good = torch.isfinite(E_new).all(-1).all(-1) & (w.sum(-1) >= 8)
        E_new = torch.where(good[..., None, None], E_new, E)
        new_inl = (sampson_err2(E_new, q0, q1) < thr_b * thr_b) & vk
        keep = new_inl.sum(-1) >= inliers.sum(-1)
        E = torch.where(keep[..., None, None], E_new, E)
        inliers = torch.where(keep[..., None], new_inl, inliers)

    best = inliers.sum(-1).argmax(1)                              # [B]
    E = E[ar, best]
    inliers = inliers[ar, best]

    # pose: the 4-way decomposition and the cheirality vote on the inliers
    Rs, ts = decompose_essential(E)                               # [B, 4, ...]
    z0, z1 = _depths(Rs, ts, p0[:, None], p1[:, None])            # [B, 4, N]
    front = (z0 > 0) & (z1 > 0) & inliers[:, None]
    votes = front.sum(-1)
    pick = votes.argmax(1)
    pose_inliers = front[ar, pick]
    ok = ((valid.sum(-1) >= min_valid) & (votes[ar, pick] > 0)
          & torch.isfinite(E).all(-1).all(-1))
    return {"E": E, "R": Rs[ar, pick], "t": ts[ar, pick],
            "inliers": pose_inliers, "num_inliers": pose_inliers.sum(-1),
            "ok": ok}


def normalize_by_intrinsics(kpts: torch.Tensor, K: torch.Tensor
                            ) -> torch.Tensor:
    """Pixels [B, N, 2] -> normalized camera coordinates under K [B, 3, 3]."""
    c = K[:, None, :2, 2]
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None]
    return (kpts - c) / f


def batched_pose_errors(mkpts0: torch.Tensor, mkpts1: torch.Tensor,
                        valid: torch.Tensor, K0: torch.Tensor,
                        K1: torch.Tensor, T_0to1: torch.Tensor,
                        thresh: float = 0.5, iters: int = 512,
                        sample_idx: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Relative pose of each pair and its angular errors, on the device.

    mkpts0/1: [B, N, 2] padded matches in pixels; valid [B, N]; K0/K1
    [B, 3, 3]; T_0to1 [B, 4, 4]; thresh: RANSAC threshold in pixels,
    divided by each pair's mean focal length. Returns (t_err_deg,
    R_err_deg, num_inliers, ok), each [B]; a failed fit has inf errors."""
    p0 = normalize_by_intrinsics(mkpts0, K0)
    p1 = normalize_by_intrinsics(mkpts1, K1)
    fmean = (K0[:, 0, 0] + K0[:, 1, 1] + K1[:, 0, 0] + K1[:, 1, 1]) / 4.0
    res = ransac_essential(p0, p1, valid, thresh / fmean, iters=iters,
                           sample_idx=sample_idx, generator=generator)
    R, t = res["R"], res["t"]
    t_gt, R_gt = T_0to1[:, :3, 3], T_0to1[:, :3, :3]
    nrm = torch.linalg.vector_norm(t, dim=-1) * torch.linalg.vector_norm(
        t_gt, dim=-1)
    cos_t = (t * t_gt).sum(-1) / torch.clamp(nrm, min=1e-12)
    t_err = torch.rad2deg(torch.arccos(torch.clamp(cos_t, -1.0, 1.0)))
    t_err = torch.minimum(t_err, 180.0 - t_err)
    trace = (R * R_gt).sum((-1, -2))                              # tr(R^T R_gt)
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    R_err = torch.rad2deg(torch.abs(torch.arccos(cos)))
    inf = torch.full_like(t_err, torch.inf)
    return (torch.where(res["ok"], t_err, inf),
            torch.where(res["ok"], R_err, inf),
            res["num_inliers"], res["ok"])
