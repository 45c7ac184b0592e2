"""Homography helpers, batched.

Counterpart of grid_points, warp_points, four_point_homography, _solve8
and sample_homography in geoformer_tpu/geometry/homography.py. Warps are
explicit multiply-adds in f32 (as in the JAX package); the 8x8 solve is an
unrolled Gauss-Jordan with partial pivoting that gives inf/nan on singular
systems instead of raising, so callers can test finiteness as the JAX
package does. The random draws of sample_homography come from a
torch.Generator, or are given, so that a test can hand both packages the
same draws.
"""

from __future__ import annotations

import torch


def grid_points(h: int, w: int, scale: int = 1, device=None) -> torch.Tensor:
    """[h*w, 2] (x, y) pixel coordinates of a row-major grid with stride
    ``scale``: cell (r, c) -> (c * scale, r * scale), f32."""
    ys = torch.arange(h, dtype=torch.float32, device=device) * scale
    xs = torch.arange(w, dtype=torch.float32, device=device) * scale
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


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


def sample_homography_draws(b: int, image_hw, generator=None, device=None):
    """The random draws of sample_homography for b samples, from
    ``generator``: corner offsets ("big" in [-rg//3, rg//3), "small" in
    [-5, 5), [b, 4, 2] float), "u_warp" [b], "flip" [b] int in {0, 1} and
    "u_flip" [b, 2], uniforms in [0, 1)."""
    h, w = image_hw
    rg = max(h, w)
    kw = dict(generator=generator, device=device)
    return {
        "big": torch.randint(-rg // 3, rg // 3, (b, 4, 2), **kw).float(),
        "small": torch.randint(-5, 5, (b, 4, 2), **kw).float(),
        "u_warp": torch.rand((b,), **kw),
        "flip": torch.randint(0, 2, (b,), **kw),
        "u_flip": torch.rand((b, 2), **kw),
    }


def sample_homography(draws, image_hw, small_warp_p: float = 0.2,
                      flip_p: float = 0.2) -> torch.Tensor:
    """Random training homographies [b, 3, 3] from sample_homography_draws
    (counterpart of the JAX sample_homography, batched): a random 4-corner
    perturbation, the small one with probability small_warp_p, and with
    probability flip_p an axis flip (replacing H with probability 0.6, else
    composed after it)."""
    h, w = image_hw
    big = draws["big"]
    dev = big.device
    corners = torch.tensor([[0, 0], [0, h], [w, 0], [w, h]],
                           dtype=torch.float32, device=dev)
    small_now = (draws["u_warp"] < small_warp_p)[:, None, None]
    warp = torch.where(small_now, draws["small"], big)
    H = four_point_homography(corners.expand_as(warp), corners + warp)
    flips = torch.tensor([[[-1, 0, w], [0, 1, 0], [0, 0, 1]],
                          [[1, 0, 0], [0, -1, h], [0, 0, 1]]],
                         dtype=torch.float32, device=dev)
    flip = flips[draws["flip"].long()]
    u = draws["u_flip"]
    return torch.where((u[:, 0] < flip_p)[:, None, None],
                       torch.where((u[:, 1] < 0.6)[:, None, None], flip,
                                   H @ flip), H)
