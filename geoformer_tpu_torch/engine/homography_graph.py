"""SL(3) homography pose graph: globally consistent planar alignment.

Counterpart of geoformer_tpu/engine/homography_graph.py. Keyframe states
are 3x3 homographies to a reference frame. Pairwise measurements H_ij
(matcher + RANSAC) are fused by Gauss-Newton over sl(3) tangent updates:
the residual of an edge is vee(log(H_ij^-1 @ H_j @ H_i^-1)), the log taken
to first order (the normalized deviation from identity), exact at the
optimum. Node 0 is gauge-fixed.

The per-edge Jacobians are torch.func.vmap(torch.func.jacfwd(...)) of the
residual at 0. The normal matrix is built dense through one-hot incidence
products in place of segment_sum: deterministic on CUDA (no float
atomics), and as cheap for graphs of a few dozen frames. Every product runs
at full f32 (engine/lie.full_f32). On CUDA each batched inverse in the
residual checks its status on the host (4 syncs an iteration); the dense
solve of each iteration does not check, so it does not synchronise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geoformer_tpu_torch.engine.lie import det3, full_f32

def sl3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 8] -> [..., 3, 3] matrix exponential by scaling-and-squaring
    (8 squarings + 6-term series), accurate for pixel-scale translation
    generators (|A| up to ~100).

    The sl(3) basis (8 traceless generators) is xi's placement in A:
    diag(1, -1, 0), diag(0, -1, 1), then E01, E10, E02, E12, E20, E21;
    A is stacked from xi, with no constant copied to the device."""
    x = xi.unbind(-1)
    A = torch.stack([
        torch.stack([x[0], x[2], x[4]], -1),
        torch.stack([x[3], -x[0] - x[1], x[5]], -1),
        torch.stack([x[6], x[7], x[1]], -1)], -2) / 256.0
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(A.shape)
    term = eye
    out = eye
    for i in range(1, 7):
        term = (term @ A) / i
        out = out + term
    for _ in range(8):
        out = out @ out
    return out


def _residual(xi_i, xi_j, Hi, Hj, Hij):
    """vee of the deviation of Hij^-1 Hj Hi^-1 from identity (normalized)."""
    Hi_new = sl3_exp(xi_i) @ Hi
    Hj_new = sl3_exp(xi_j) @ Hj
    M = torch.linalg.inv(Hij) @ Hj_new @ torch.linalg.inv(Hi_new)
    # scale-normalize (det ambiguity); M * (3 / tr) under jacfwd yields f64
    M = M * 3.0 / M.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    D = M - torch.eye(3, dtype=M.dtype, device=M.device)
    # project the deviation onto the sl(3) basis (first-order log)
    return torch.stack([
        (D[..., 0, 0] - D[..., 1, 1]) / 2, (D[..., 2, 2] - D[..., 1, 1]) / 2,
        D[..., 0, 1], D[..., 1, 0], D[..., 0, 2], D[..., 1, 2],
        D[..., 2, 0], D[..., 2, 1]], -1)


class HomographyGraph(NamedTuple):
    H: torch.Tensor           # [K, 3, 3] frame -> reference homographies
    edge_i: torch.Tensor      # [E] long
    edge_j: torch.Tensor      # [E] long
    edge_H: torch.Tensor      # [E, 3, 3] measured H_itoj
    edge_valid: torch.Tensor  # [E] bool
    edge_weight: torch.Tensor  # [E]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root of any sign (torch has no cbrt)."""
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def optimize_homography_graph(graph: HomographyGraph, iters: int = 10,
                              damping: float = 1e-5,
                              norm_scale: float = 256.0):
    """Returns (H [K, 3, 3], residual-norm history [iters]) on the graph's
    device.

    All homographies are conjugated into a normalized frame (pixels /
    norm_scale) before optimization: without it the sl(3) tangent mixes
    pixel-scale translations with ~1e-6 perspective terms and Gauss-Newton
    diverges on the resulting conditioning."""
    with full_f32():
        return _optimize(graph, iters, damping, norm_scale)


def _optimize(graph, iters, damping, norm_scale):
    H = graph.H
    dtype, device = H.dtype, H.device
    K, E = H.shape[0], graph.edge_i.shape[0]
    S = torch.diag(torch.tensor([1.0 / norm_scale, 1.0 / norm_scale, 1.0],
                                dtype=dtype, device=device))
    Sinv = torch.diag(torch.tensor([norm_scale, norm_scale, 1.0],
                                   dtype=dtype, device=device))

    def unimodular(Hk):
        # measured homographies are h22-normalized with arbitrary det; bring
        # them onto SL(3) so tangent updates and residuals are consistent
        return Hk / _cbrt(det3(Hk))[..., None, None]

    H = unimodular(S @ H @ Sinv)
    edge_H = unimodular(S @ graph.edge_H @ Sinv)
    Oi = torch.nn.functional.one_hot(graph.edge_i, K).to(dtype)   # [E, K]
    Oj = torch.nn.functional.one_hot(graph.edge_j, K).to(dtype)
    w = (graph.edge_valid.to(dtype) * graph.edge_weight)[:, None]
    z = torch.zeros(8, dtype=dtype, device=device)
    jac = torch.func.vmap(torch.func.jacfwd(_residual, argnums=(0, 1)),
                          in_dims=(None, None, 0, 0, 0))
    mask = torch.arange(K * 8, device=device) >= 8
    fixed = torch.diag(torch.where(mask, 0.0, 1.0).to(dtype))
    damp = damping * torch.eye(K * 8, dtype=dtype, device=device)
    hist = []
    for _ in range(iters):
        Hi, Hj = H[graph.edge_i], H[graph.edge_j]
        zE = z.expand(E, 8)
        r = _residual(zE, zE, Hi, Hj, edge_H) * w
        Ji, Jj = jac(z, z, Hi, Hj, edge_H)                  # [E, 8, 8] each
        Ji = Ji * w[..., None]
        Jj = Jj * w[..., None]
        # dense normal matrix: block (a, b) sums J_a^T J_b over the edges
        # incident as (a, b)
        Hm = sum(torch.einsum("ea,eb,eij->aibj", Oa, Ob,
                              Ja.transpose(1, 2) @ Jb)
                 for Ja, Oa in ((Ji, Oi), (Jj, Oj))
                 for Jb, Ob in ((Ji, Oi), (Jj, Oj)))
        b = -(Oi.T @ (Ji.transpose(1, 2) @ r[..., None])[..., 0]
              + Oj.T @ (Jj.transpose(1, 2) @ r[..., None])[..., 0])
        A = Hm.reshape(K * 8, K * 8) + damp
        A = torch.where(mask[:, None] & mask[None, :], A,
                        torch.zeros_like(A)) + fixed
        bm = torch.where(mask, b.reshape(-1), torch.zeros_like(b.reshape(-1)))
        dx = torch.linalg.solve_ex(A, bm)[0].reshape(K, 8)
        H = sl3_exp(dx) @ H
        hist.append(torch.linalg.norm(r))
    H = Sinv @ H @ S                                        # pixel frame
    return H, torch.stack(hist)
