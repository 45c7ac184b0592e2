"""Bundle adjustment: Levenberg-damped Gauss-Newton with a Schur complement.

Counterpart of geoformer_tpu/engine/ba.py:

  * per-observation projection Jacobians by
    torch.func.vmap(torch.func.jacfwd(...)), as engine/homography_graph.py
    takes its own;
  * block accumulation (U per camera, V per point, W per observation) with
    segment sums (index_add_), no sparse matrices;
  * the Schur complement: the 3x3 point blocks batch-inverted, the reduced
    camera system S [6C, 6C] assembled with dense einsums (``ba_solve``),
    or applied matrix-free inside a block-Jacobi preconditioned conjugate
    gradient (``ba_solve_cg``);
  * fixed shapes: observations arrive capacity-padded with a validity mask;
  * distribution over the ranks of a torch.distributed group
    (core/mesh.py), where the JAX package psums over a mesh axis:
    ``ba_solve_sharded`` shards the observations and sums the normal
    blocks, ``ba_solve_points_sharded`` shards the points with their
    observations and sums only the reduced camera system and its
    right-hand side; the accept test's squared errors and counts are
    summed too. Each sum is one all-reduce of the blocks' concatenation.

Cameras are world->camera SE(3), updated by left-multiplied se(3)
increments; camera 0 is gauge-fixed. Every product runs at full f32
(engine/lie.full_f32; the JAX solver runs at HIGHEST precision), and the
inverses and solves do not check their status, so an iteration does not
synchronise with the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from geoformer_tpu_torch.core import mesh
from geoformer_tpu_torch.engine.lie import full_f32, se3_exp


class BAProblem(NamedTuple):
    cams: torch.Tensor       # [C, 4, 4] world->cam
    points: torch.Tensor     # [P, 3]
    K: torch.Tensor          # [3, 3] shared intrinsics
    obs_cam: torch.Tensor    # [N] long
    obs_pt: torch.Tensor     # [N] long
    obs_uv: torch.Tensor     # [N, 2]
    obs_valid: torch.Tensor  # [N] bool


def _project(cam_T, pt, K):
    """World point -> pixel. cam_T [4, 4], pt [3], K [3, 3] -> [2]."""
    pc = cam_T[:3, :3] @ pt + cam_T[:3, 3]
    # a 1-element slice, not a 0-d tensor: a Python float meeting a 0-d
    # tensor promotes jacfwd's tangents to f64
    z = torch.clamp(pc[2:3], min=1e-6)
    uv = K @ (pc / z)
    return uv[:2]


def _residual(xi_c, dp, cam_T, pt, uv, K):
    """Residual at local update (xi_c for the camera, dp for the point)."""
    T = se3_exp(xi_c) @ cam_T
    return _project(T, pt + dp, K) - uv


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n, *x.shape[1:])).index_add_(0, idx, x)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def reprojection_errors(prob: BAProblem) -> torch.Tensor:
    """[N] pixel errors (padding slots -> 0)."""
    cams = prob.cams[prob.obs_cam]
    pts = prob.points[prob.obs_pt]
    with full_f32():
        uv = torch.func.vmap(_project, in_dims=(0, 0, None))(cams, pts,
                                                             prob.K)
    err = torch.linalg.norm(uv - prob.obs_uv, dim=-1)
    return torch.where(prob.obs_valid, err, torch.zeros_like(err))


def _build_normal_blocks(prob: BAProblem, huber_delta: float = 0.0):
    """Per-observation residuals [N, 2] and Jacobians Jc [N, 2, 6], Jp
    [N, 2, 3], padding rows zeroed. ``huber_delta`` > 0 scales each row by
    sqrt(w), w = 1 inside the delta and delta/|r| beyond (Huber IRLS)."""
    cams = prob.cams[prob.obs_cam]
    pts = prob.points[prob.obs_pt]
    z6 = prob.cams.new_zeros(6)
    z3 = prob.cams.new_zeros(3)
    in_dims = (None, None, 0, 0, 0, None)
    r = torch.func.vmap(_residual, in_dims=in_dims)(
        z6, z3, cams, pts, prob.obs_uv, prob.K)
    Jc, Jp = torch.func.vmap(torch.func.jacfwd(_residual, argnums=(0, 1)),
                             in_dims=in_dims)(z6, z3, cams, pts,
                                              prob.obs_uv, prob.K)
    w = prob.obs_valid.to(r.dtype)
    if huber_delta > 0:
        err = torch.linalg.norm(r, dim=-1)
        w = w * torch.sqrt(torch.where(
            err <= huber_delta, torch.ones_like(err),
            huber_delta / torch.clamp(err, min=1e-8)))
    w = w[:, None]
    return r * w, Jc * w[..., None], Jp * w[..., None]


def _cost(prob: BAProblem, huber_delta: float = 0.0,
          reduce_fn: Optional[Callable] = None) -> torch.Tensor:
    """sqrt(sum of squared errors / valid count), the Huber cost in place
    of the squares when ``huber_delta`` > 0; both sums reduced by
    ``reduce_fn``."""
    err = reprojection_errors(prob)
    if huber_delta > 0:
        e2 = torch.where(err <= huber_delta, err ** 2,
                         huber_delta * (2 * err - huber_delta)).sum()
    else:
        e2 = (err ** 2).sum()
    nv = prob.obs_valid.sum().to(e2.dtype)
    if reduce_fn is not None:
        e2, nv = reduce_fn([e2, nv])
    return torch.sqrt(e2 / torch.clamp(nv, min=1))


def _accept(prob, new_cams, new_points, huber_delta, reduce_fn):
    """The LM guard: the update where it lowers the cost, and the lower
    cost."""
    old = _cost(prob, huber_delta, reduce_fn)
    new = _cost(prob._replace(cams=new_cams, points=new_points), huber_delta,
                reduce_fn)
    ok = new < old
    return (torch.where(ok, new_cams, prob.cams),
            torch.where(ok, new_points, prob.points), torch.minimum(new, old))


def _gauge_solve(S: torch.Tensor, rhs: torch.Tensor, C: int) -> torch.Tensor:
    """Solve the reduced camera system [C, 6, C, 6] with camera 0 frozen
    (its block pinned to the identity, its right-hand side to 0)."""
    Sm = S.reshape(C * 6, C * 6)
    mask = torch.arange(C * 6, device=S.device) >= 6
    Sm = torch.where(mask[:, None] & mask[None, :], Sm, torch.zeros_like(Sm))
    Sm = Sm + torch.diag(torch.where(mask, 0.0, 1.0).to(S.dtype))
    rhs_m = torch.where(mask, rhs.reshape(-1),
                        torch.zeros_like(rhs.reshape(-1)))
    return torch.linalg.solve_ex(Sm, rhs_m)[0].reshape(C, 6)


def _reduced_system(U, WVW, damping):
    """The reduced camera system S = (U + lam) - W V^-1 W^T as
    [C, 6, C, 6], from the camera blocks U [C, 6, 6] and WVW = W V^-1 W^T
    [C, 6, C, 6]."""
    C = U.shape[0]
    return ((U + damping * _eye(6, U)[None]).reshape(C, 6, 1, 6)
            * _eye(C, U)[:, None, :, None] - WVW)


def _ba_solve_impl(prob: BAProblem, iters: int, damping: float, C: int,
                   P: int, reduce_fn: Optional[Callable],
                   huber_delta: float = 0.0):
    cams, points = prob.cams, prob.points
    hist = []
    for _ in range(iters):
        p = prob._replace(cams=cams, points=points)
        r, Jc, Jp = _build_normal_blocks(p, huber_delta)
        U = _segment_sum(torch.einsum("nri,nrj->nij", Jc, Jc), p.obs_cam, C)
        V = _segment_sum(torch.einsum("nri,nrj->nij", Jp, Jp), p.obs_pt, P)
        bc = -_segment_sum(torch.einsum("nri,nr->ni", Jc, r), p.obs_cam, C)
        bp = -_segment_sum(torch.einsum("nri,nr->ni", Jp, r), p.obs_pt, P)
        Wn = torch.einsum("nri,nrj->nij", Jc, Jp)             # [N, 6, 3]
        Wfull = _segment_sum(Wn, p.obs_cam * P + p.obs_pt, C * P).reshape(
            C, P, 6, 3)
        if reduce_fn is not None:
            U, V, bc, bp, Wfull = reduce_fn([U, V, bc, bp, Wfull])

        Vinv = torch.linalg.inv_ex(V + damping * _eye(3, V)[None])[0]
        WVinv = torch.einsum("cpij,pjk->cpik", Wfull, Vinv)
        S = _reduced_system(
            U, torch.einsum("cpik,dplk->cidl", WVinv, Wfull), damping)
        rhs = bc - torch.einsum("cpik,pk->ci", WVinv, bp)
        dx_c = _gauge_solve(S, rhs, C)
        dx_p = torch.einsum("pij,pj->pi", Vinv,
                            bp - torch.einsum("cpij,ci->pj", Wfull, dx_c))
        cams, points, cost = _accept(p, se3_exp(dx_c) @ cams, points + dx_p,
                                     huber_delta, reduce_fn)
        hist.append(cost)
    return cams, points, torch.stack(hist)


def ba_solve(prob: BAProblem, iters: int = 10, damping: float = 1e-3,
             n_cams: int = 0, n_points: int = 0, huber_delta: float = 0.0):
    """LM-damped Gauss-Newton BA. Returns (cams, points, rmse history
    [iters]). n_cams/n_points default to the array sizes. huber_delta > 0
    turns on Huber IRLS row weighting (robust to outlier observations)."""
    with full_f32():
        return _ba_solve_impl(prob, iters, damping,
                              n_cams or prob.cams.shape[0],
                              n_points or prob.points.shape[0], None,
                              huber_delta)


def ba_solve_cg(prob: BAProblem, iters: int = 10, damping: float = 1e-3,
                cg_iters: int = 32, huber_delta: float = 0.0):
    """Gauss-Newton BA with a matrix-free conjugate-gradient Schur solve.

    CG applies S = (U + lam) - W V^-1 W^T to a vector through the
    per-observation W blocks and segment sums, with no [6C, 6C] matrix and
    no [C, P, 6, 3] tensor:

        t_p = sum_{n: pt(n)=p} Wn^T x_cam(n) ;  s_p = V_p^-1 t_p ;
        (S x)_c = (U_c + lam) x_c - sum_{n: cam(n)=c} Wn s_pt(n)

    with camera 0 frozen inside the operator, and block-Jacobi
    preconditioned by the exact 6x6 diagonal blocks of S. Returns (cams,
    points, rmse history [iters])."""
    with full_f32():
        return _ba_solve_cg(prob, iters, damping, cg_iters, huber_delta)


def _ba_solve_cg(prob, iters, damping, cg_iters, huber_delta):
    C = prob.cams.shape[0]
    P = prob.points.shape[0]
    cams, points = prob.cams, prob.points
    gauge = (torch.arange(C, device=cams.device) >= 1).to(cams.dtype)[:, None]
    g3 = gauge[:, :, None]
    hist = []
    for _ in range(iters):
        p = prob._replace(cams=cams, points=points)
        r, Jc, Jp = _build_normal_blocks(p, huber_delta)
        U = _segment_sum(torch.einsum("nri,nrj->nij", Jc, Jc), p.obs_cam, C)
        V = _segment_sum(torch.einsum("nri,nrj->nij", Jp, Jp), p.obs_pt, P)
        bc = -_segment_sum(torch.einsum("nri,nr->ni", Jc, r), p.obs_cam, C)
        bp = -_segment_sum(torch.einsum("nri,nr->ni", Jp, r), p.obs_pt, P)
        Wn = torch.einsum("nri,nrj->nij", Jc, Jp)             # [N, 6, 3]
        Vinv = torch.linalg.inv_ex(V + damping * _eye(3, V)[None])[0]
        Ul = U + damping * _eye(6, U)[None]

        def WT_x(x):      # [C, 6] -> [P, 3]
            per = torch.einsum("nij,ni->nj", Wn, x[p.obs_cam])
            return _segment_sum(per, p.obs_pt, P)

        def W_s(s):       # [P, 3] -> [C, 6]
            per = torch.einsum("nij,nj->ni", Wn, s[p.obs_pt])
            return _segment_sum(per, p.obs_cam, C)

        def S_apply(x):   # [C, 6] -> [C, 6]; the frozen camera: I
            x = x * gauge
            s = torch.einsum("pij,pj->pi", Vinv, WT_x(x))
            y = torch.einsum("cij,cj->ci", Ul, x) - W_s(s)
            return y * gauge + x * (1 - gauge)

        rhs = (bc - W_s(torch.einsum("pij,pj->pi", Vinv, bp))) * gauge
        WVW = torch.einsum("nij,njk,nlk->nil", Wn, Vinv[p.obs_pt], Wn)
        Sdiag = Ul - _segment_sum(WVW, p.obs_cam, C)
        Minv = g3 * torch.linalg.inv_ex(Sdiag)[0] + (1 - g3) * _eye(6, U)[None]

        def apply_Minv(v):
            return torch.einsum("cij,cj->ci", Minv, v)

        x = torch.zeros_like(rhs)
        res = rhs
        d = apply_Minv(rhs)
        rz = (rhs * d).sum()
        for _ in range(cg_iters):
            Sd = S_apply(d)
            alpha = rz / torch.clamp((d * Sd).sum(), min=1e-20)
            x = x + alpha * d
            res = res - alpha * Sd
            z = apply_Minv(res)
            rz_new = (res * z).sum()
            d = z + (rz_new / torch.clamp(rz, min=1e-20)) * d
            rz = rz_new
        dx_c = x * gauge
        dx_p = torch.einsum("pij,pj->pi", Vinv, bp - WT_x(dx_c))
        cams, points, cost = _accept(p, se3_exp(dx_c) @ cams, points + dx_p,
                                     huber_delta, None)
        hist.append(cost)
    return cams, points, torch.stack(hist)


def _local_slice(n: int, what: str) -> slice:
    if n % mesh.world():
        raise ValueError(f"{n} {what} do not divide over {mesh.world()} "
                         "ranks")
    return mesh.local_shard_slice(n)


def ba_solve_sharded(prob: BAProblem, iters: int = 10,
                     damping: float = 1e-3):
    """Distributed BA over the ranks of the process group: each rank takes
    its local_shard_slice of the observations (their count must divide by
    the world size), the normal blocks are summed over the ranks and the
    reduced camera system is solved on every rank alike. Every rank passes
    the whole problem and gets (cams, points, rmse history); world size 1
    is ba_solve."""
    sl = _local_slice(prob.obs_cam.shape[0], "observations")
    local = prob._replace(obs_cam=prob.obs_cam[sl], obs_pt=prob.obs_pt[sl],
                          obs_uv=prob.obs_uv[sl],
                          obs_valid=prob.obs_valid[sl])
    with full_f32():
        return _ba_solve_impl(local, iters, damping, prob.cams.shape[0],
                              prob.points.shape[0], mesh.all_sum_flat)


def huberize(prob: BAProblem, delta: float) -> torch.Tensor:
    """Per-observation Huber IRLS weights for the current residuals:
    w = 1 for |r| <= delta, delta/|r| beyond; 0 on padding slots."""
    err = reprojection_errors(prob)
    w = torch.where(err <= delta, torch.ones_like(err),
                    delta / torch.clamp(err, min=1e-8))
    return torch.where(prob.obs_valid, w, torch.zeros_like(w))


def ba_solve_points_sharded(prob: BAProblem, iters: int = 10,
                            damping: float = 1e-3):
    """Map-partitioned distributed BA: the points and their observations
    shard over the ranks (each rank its local_shard_slice of both); each
    rank keeps its V blocks, W strip and point updates, and only the
    reduced camera system [6C, 6C] and its right-hand side are summed over
    the ranks.

    The observations come pre-grouped, so that every observation of a
    point lies in the same rank's slice as the point, with obs_pt indices
    LOCAL to that slice; both counts divide by the world size. Every rank
    passes the whole problem and gets (cams, all the points, rmse
    history)."""
    with full_f32():
        return _ba_points_sharded(prob, iters, damping)


def _ba_points_sharded(prob, iters, damping):
    C = prob.cams.shape[0]
    P_total = prob.points.shape[0]
    P = P_total // mesh.world()
    sp = _local_slice(P_total, "points")
    so = _local_slice(prob.obs_cam.shape[0], "observations")
    obs_cam, obs_pt = prob.obs_cam[so], prob.obs_pt[so]
    p0 = prob._replace(points=prob.points[sp], obs_cam=obs_cam,
                       obs_pt=obs_pt, obs_uv=prob.obs_uv[so],
                       obs_valid=prob.obs_valid[so])
    cams, points = p0.cams, p0.points
    hist = []
    for _ in range(iters):
        p = p0._replace(cams=cams, points=points)
        r, Jc, Jp = _build_normal_blocks(p)
        U = _segment_sum(torch.einsum("nri,nrj->nij", Jc, Jc), obs_cam, C)
        V = _segment_sum(torch.einsum("nri,nrj->nij", Jp, Jp), obs_pt, P)
        bc = -_segment_sum(torch.einsum("nri,nr->ni", Jc, r), obs_cam, C)
        bp = -_segment_sum(torch.einsum("nri,nr->ni", Jp, r), obs_pt, P)
        Wn = torch.einsum("nri,nrj->nij", Jc, Jp)
        Wl = _segment_sum(Wn, obs_cam * P + obs_pt, C * P).reshape(
            C, P, 6, 3)
        Vinv = torch.linalg.inv_ex(V + damping * _eye(3, V)[None])[0]
        WVinv = torch.einsum("cpij,pjk->cpik", Wl, Vinv)
        S_local = torch.einsum("cpik,dplk->cidl", WVinv, Wl)
        rhs_local = torch.einsum("cpik,pk->ci", WVinv, bp)
        # only the camera system crosses the ranks
        U, bc, S_sum, rhs_sum = mesh.all_sum_flat([U, bc, S_local,
                                                   rhs_local])
        dx_c = _gauge_solve(_reduced_system(U, S_sum, damping),
                            bc - rhs_sum, C)
        dx_p = torch.einsum("pij,pj->pi", Vinv,
                            bp - torch.einsum("cpij,ci->pj", Wl, dx_c))
        cams, points, cost = _accept(p, se3_exp(dx_c) @ cams, points + dx_p,
                                     0.0, mesh.all_sum_flat)
        hist.append(cost)
    full = prob.points.new_zeros(prob.points.shape)
    full[sp] = points
    return cams, mesh.all_sum(full), torch.stack(hist)
