"""Homography helpers, batched.

Counterpart of geoformer_tpu/geometry/homography.py: grid_points,
warp_points, four_point_homography, _solve8, sample_homography,
corner_error, the valid-pixel mask of a warp with its elliptical erosion,
pixel_shuffle and its inverse (NHWC, the JAX layout), mutual matching of
keypoints under a known homography and scale_homography. Warps are
explicit multiply-adds in
f32 (as in the JAX package); the 8x8 solve is an unrolled Gauss-Jordan
with partial pivoting that gives inf/nan on singular systems instead of
raising, so callers can test finiteness as the JAX package does. The
random draws of sample_homography come from a torch.Generator, or are
given, so that a test can hand both packages the same draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


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


def corner_error(H_pred: torch.Tensor, H_gt: torch.Tensor,
                 image_hw) -> torch.Tensor:
    """Mean distance of the four image corners ((0, 0) to (w - 1, h - 1))
    warped through H_pred and through H_gt, in f32: H [..., 3, 3] -> [...]
    (the HPatches homography error)."""
    h, w = image_hw
    corners = torch.tensor([[0, 0], [0, h - 1], [w - 1, 0], [w - 1, h - 1]],
                           dtype=torch.float32, device=H_pred.device)
    a = warp_points(corners, H_pred)
    b = warp_points(corners, H_gt)
    return torch.linalg.norm(a - b, dim=-1).mean(-1)


def _disk_kernel(radius: int) -> np.ndarray:
    """[2r, 2r] float32 0/1 ellipse, rasterized as
    cv2.getStructuringElement(MORPH_ELLIPSE, (2r, 2r)) does it (the kernel
    the JAX package erodes with): row i spans the columns within
    c -/+ round(c * sqrt(1 - (i - r)^2 / r^2)) of c = r, clipped to the
    size."""
    size = 2 * radius
    r = c = size // 2
    k = np.zeros((size, size), np.float32)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * math.sqrt((r * r - dy * dy) / (r * r))))
            k[i, max(c - dx, 0):min(c + dx + 1, size)] = 1.0
    return k


def erode_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion of a [..., h, w] {0, 1} mask by the disk of
    ``radius``: a pixel survives iff every tap of the kernel lands on a 1
    (zeros outside the image; the kernel's anchor at its centre, rounded
    down-right for even sizes)."""
    if radius <= 0:
        return mask
    k = torch.from_numpy(_disk_kernel(radius)).to(mask.device)
    kh, kw = k.shape
    h, w = mask.shape[-2:]
    x = F.pad(mask.reshape(-1, 1, h, w).float(),
              ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    out = F.conv2d(x, k[None, None])
    eroded = (out[:, 0] >= k.sum() - 1e-3).to(mask.dtype)
    return eroded.reshape(mask.shape)


def compute_valid_mask(image_hw, H: torch.Tensor, inverse: bool = False,
                       erosion_radius: int = 0) -> torch.Tensor:
    """[h, w] float32 {0, 1}: the pixels p whose source H^-1 p (or H p when
    ``inverse``, H being the dst->src map already) lies inside the h x w
    image, pixel centres at integers and edges at -0.5 and w - 0.5; then
    eroded by ``erosion_radius``."""
    h, w = image_hw
    Minv = H if inverse else torch.linalg.inv(H)
    src = warp_points(grid_points(h, w, device=H.device), Minv)
    inb = ((src[:, 0] >= -0.5) & (src[:, 0] <= w - 0.5)
           & (src[:, 1] >= -0.5) & (src[:, 1] <= h - 0.5))
    return erode_mask(inb.reshape(h, w).float(), erosion_radius)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth to space on NHWC: [N, H, W, C*r*r] -> [N, r*H, r*W, C]."""
    n, h, w, c = x.shape
    if c % (r * r):
        raise ValueError(f"{c} channels do not split into {r}x{r} blocks")
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_shuffle_inv(x: torch.Tensor, r: int) -> torch.Tensor:
    """Space to depth on NHWC: [N, H, W, C] -> [N, H/r, W/r, C*r*r]."""
    n, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"{h}x{w} does not split into {r}x{r} blocks")
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def mutual_matches_under_homography(kpts1: torch.Tensor, kpts2: torch.Tensor,
                                    H: torch.Tensor, dist_thresh: float = 3.0,
                                    valid1=None, valid2=None):
    """Mutual nearest neighbours of kpts1 [N1, 2] warped by H (1 -> 2) among
    kpts2 [N2, 2], closer than dist_thresh px; slots where the optional
    valid1 [N1] / valid2 [N2] are False take no part. Returns (match12
    [N1] int32 index into kpts2, matched [N1] bool)."""
    p1 = warp_points(kpts1, H)
    d = torch.linalg.norm(p1[:, None, :] - kpts2[None, :, :], dim=-1)
    inf = torch.full_like(d, math.inf)
    if valid1 is not None:
        d = torch.where(valid1[:, None], d, inf)
    if valid2 is not None:
        d = torch.where(valid2[None, :], d, inf)
    min1 = d.argmin(dim=1)
    min2 = d.argmin(dim=0)
    mutual = min2[min1] == torch.arange(len(kpts1), device=d.device)
    close = d.gather(1, min1[:, None])[:, 0] < dist_thresh
    return min1.int(), mutual & close


def scale_homography(H: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """S H S^-1 with S = diag(sx, sy, 1): H between frames resized by
    (sx, sy)."""
    S = torch.tensor([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], dtype=H.dtype,
                     device=H.device)
    Sinv = torch.tensor([[1 / sx, 0, 0], [0, 1 / sy, 0], [0, 0, 1]],
                        dtype=H.dtype, device=H.device)
    return S @ H @ Sinv
