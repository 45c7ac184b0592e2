"""Homography helpers, batched.

Counterpart of warp_points, four_point_homography and _solve8 in
geoformer_tpu/geometry/homography.py. Warps are explicit multiply-adds in
f32 (as in the JAX package); the 8x8 solve is an unrolled Gauss-Jordan with
partial pivoting that gives inf/nan on singular systems instead of raising,
so callers can test finiteness as the JAX package does.
"""

from __future__ import annotations

import torch


def warp_points(points: torch.Tensor, H: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """points: [..., N, 2] (x, y); H: [..., 3, 3] broadcastable.
    Returns [..., N, 2]; a zero denominator is replaced by eps."""
    x, y = points[..., 0], points[..., 1]
    h = H[..., None, :, :]  # [..., 1, 3, 3] against [..., N]
    u = h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]
    v = h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]
    d = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    d = torch.where(d == 0, torch.full_like(d, eps), d)
    return torch.stack([u / d, v / d], dim=-1)


def solve8(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 8x8 solve: A [..., 8, 8], b [..., 8] -> x [..., 8]."""
    n = 8
    M = torch.cat([A, b[..., None]], dim=-1)            # [..., 8, 9]
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = M[..., :, k].abs()
        col = torch.where(rows >= k, col, torch.full_like(col, -1.0))
        p = col.argmax(dim=-1)                          # [...]
        # swap rows k and p through a per-system row permutation
        perm = rows.expand(*p.shape, n).clone()
        perm[..., k] = p
        perm.scatter_(-1, p[..., None], k)
        M = torch.gather(M, -2, perm[..., None].expand(*perm.shape, n + 1))
        pivot_row = M[..., k, :] / M[..., k, k:k + 1]
        M = torch.cat([M[..., :k, :], pivot_row[..., None, :],
                       M[..., k + 1:, :]], dim=-2)
        factor = M[..., :, k:k + 1]
        upd = factor * pivot_row[..., None, :]
        M = M - torch.where((rows != k)[:, None], upd, torch.zeros_like(upd))
    return M[..., :, n]


def four_point_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homography (h33 = 1) from 4 correspondences.
    src, dst: [..., 4, 2] -> [..., 3, 3] with H [src, 1] ~ [dst, 1]."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = torch.cat([ax, ay], dim=-2)                     # [..., 8, 8]
    b = torch.cat([u, v], dim=-1)                       # [..., 8]
    sol = solve8(A, b)
    return torch.cat([sol, torch.ones_like(sol[..., :1])],
                     dim=-1).reshape(*sol.shape[:-1], 3, 3)
