"""Pose-graph optimization over SE(3) by Gauss-Newton.

Counterpart of geoformer_tpu/engine/pose_graph.py. Pairwise relative-pose
measurements are fused into globally consistent keyframe poses. The
residual of an edge (i, j) is log(T_ij_meas^-1 @ T_j @ T_i^-1), minimized
over left-multiplied local updates; node 0 is gauge-fixed.

The per-edge Jacobians are torch.func.vmap(torch.func.jacfwd(...)) of the
residual at 0, and the dense [6K, 6K] normal matrix is built through
one-hot incidence products, as engine/homography_graph.py builds its own
(deterministic on CUDA, no float atomics). Every product runs at full f32
(engine/lie.full_f32), as the JAX solver runs at HIGHEST precision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geoformer_tpu_torch.engine.lie import full_f32, se3_exp, se3_log


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # [K, 4, 4] world->keyframe
    edge_i: torch.Tensor      # [E] long
    edge_j: torch.Tensor      # [E] long
    edge_T: torch.Tensor      # [E, 4, 4] measured T_itoj (cam_j @ cam_i^-1)
    edge_valid: torch.Tensor  # [E] bool
    edge_weight: torch.Tensor  # [E]


def _edge_residual(xi_i, xi_j, Ti, Tj, Tij):
    Ti_new = se3_exp(xi_i) @ Ti
    Tj_new = se3_exp(xi_j) @ Tj
    return se3_log(torch.linalg.inv(Tij) @ Tj_new
                   @ torch.linalg.inv(Ti_new))


def optimize_pose_graph(graph: PoseGraph, iters: int = 10,
                        damping: float = 1e-6):
    """Returns (poses [K, 4, 4], residual-norm history [iters]) on the
    graph's device."""
    with full_f32():
        return _optimize(graph, iters, damping)


def _optimize(graph: PoseGraph, iters: int, damping: float):
    poses = graph.poses
    dtype, device = poses.dtype, poses.device
    K, E = poses.shape[0], graph.edge_i.shape[0]
    Oi = torch.nn.functional.one_hot(graph.edge_i, K).to(dtype)   # [E, K]
    Oj = torch.nn.functional.one_hot(graph.edge_j, K).to(dtype)
    w = (graph.edge_valid.to(dtype) * graph.edge_weight)[:, None]
    z = torch.zeros(6, dtype=dtype, device=device)
    jac = torch.func.vmap(torch.func.jacfwd(_edge_residual, argnums=(0, 1)),
                          in_dims=(None, None, 0, 0, 0))
    mask = torch.arange(K * 6, device=device) >= 6
    fixed = torch.diag(torch.where(mask, 0.0, 1.0).to(dtype))
    damp = damping * torch.eye(K * 6, dtype=dtype, device=device)
    hist = []
    for _ in range(iters):
        Ti, Tj = poses[graph.edge_i], poses[graph.edge_j]
        zE = z.expand(E, 6)
        r = _edge_residual(zE, zE, Ti, Tj, graph.edge_T) * w
        Ji, Jj = jac(z, z, Ti, Tj, graph.edge_T)              # [E, 6, 6]
        Ji = Ji * w[..., None]
        Jj = Jj * w[..., None]
        # block (a, b) sums J_a^T J_b over the edges incident as (a, b)
        Hm = sum(torch.einsum("ea,eb,eij->aibj", Oa, Ob,
                              Ja.transpose(1, 2) @ Jb)
                 for Ja, Oa in ((Ji, Oi), (Jj, Oj))
                 for Jb, Ob in ((Ji, Oi), (Jj, Oj)))
        b = -(Oi.T @ (Ji.transpose(1, 2) @ r[..., None])[..., 0]
              + Oj.T @ (Jj.transpose(1, 2) @ r[..., None])[..., 0])
        A = Hm.reshape(K * 6, K * 6) + damp
        A = torch.where(mask[:, None] & mask[None, :], A,
                        torch.zeros_like(A)) + fixed
        bm = torch.where(mask, b.reshape(-1), torch.zeros_like(b.reshape(-1)))
        dx = torch.linalg.solve_ex(A, bm)[0].reshape(K, 6)
        poses = se3_exp(dx) @ poses
        hist.append(torch.linalg.norm(r))
    return poses, torch.stack(hist)
