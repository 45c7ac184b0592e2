"""Synthetic inputs made from a seed.

Used by chip_smoke.py, the profiling script and the tests, whose inputs
are made, not read: a multi-scale noise texture (numpy draws, torch
upsampling) and its warp by a known homography; and two-view
correspondences of a known relative pose for the host pose estimator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

H_TRUE = np.array([[0.95, 0.05, 12.0], [-0.04, 0.98, -6.0],
                   [1e-5, 2e-5, 1.0]])


def textured_pair(hw, seed: int, H: np.ndarray = H_TRUE):
    """(img0, img1) float32 [h, w] arrays in [0, 1] with
    img1(p) = img0(H^-1 p) (bilinear, zeros outside)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    img = torch.zeros((1, 1, h, w))
    for cell, weight in ((64, 1.0), (16, 0.6), (4, 0.3)):
        lo = torch.from_numpy(rng.random(
            (1, 1, h // cell + 4, w // cell + 4)).astype(np.float32))
        up = F.interpolate(lo, scale_factor=cell, mode="bicubic")
        img += weight * up[..., :h, :w]
    img = (img - img.min()) / (img.max() - img.min())
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ torch.from_numpy(
        np.linalg.inv(H)).T
    src = p[..., :2] / p[..., 2:]
    grid = torch.stack([2 * src[..., 0] / (w - 1) - 1,
                        2 * src[..., 1] / (h - 1) - 1], -1)[None].float()
    warped = F.grid_sample(img, grid, align_corners=True)
    return img[0, 0].numpy(), warped[0, 0].numpy()


POSE_K = np.array([[420.0, 0, 320], [0, 420, 240], [0, 0, 1]])
# (outlier share, pixel noise, rotation in degrees) of the twelve two-view
# sets the host pose estimator is checked on
POSE_SETS = tuple(((0.0, 0.2, 0.4)[k % 3], (0.0, 0.5, 1.0)[(k // 3) % 3],
                   4.0 + 10.0 * k / 11) for k in range(12))


def two_view(rng, n: int = 300, outlier_frac: float = 0.2,
             noise_px: float = 0.5, angle_deg: float = 8.0,
             t=(0.6, 0.15, 0.05)):
    """(uv0, uv1, K, T_0to1): n points in a box 4-9 units in front of camera
    0 seen by two cameras of intrinsics POSE_K, camera 1 rotated by
    angle_deg about y and moved by t; Gaussian pixel noise on both views
    and the share outlier_frac of view 1 replaced by uniform points."""
    K = POSE_K
    pts = rng.uniform([-2, -2, 4], [2, 2, 9], size=(n, 3))
    th = np.deg2rad(angle_deg)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    t = np.asarray(t, np.float64)

    def project(X):
        uv = X @ K.T
        return uv[:, :2] / uv[:, 2:]

    uv0 = project(pts)
    uv1 = project(pts @ R.T + t)
    uv0 = uv0 + rng.normal(0, noise_px, uv0.shape)
    uv1 = uv1 + rng.normal(0, noise_px, uv1.shape)
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    uv1[idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return uv0, uv1, K, T


def pose_sets(seed: int = 0, n: int = 300):
    """The twelve POSE_SETS pairs, (uv0, uv1, K, T_0to1) each, drawn in
    order from one generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    return [two_view(rng, n, o, nz, a) for o, nz, a in POSE_SETS]


def rotation(axis_angle) -> np.ndarray:
    """The rotation matrix of an axis-angle vector (Rodrigues' formula)."""
    w = np.asarray(axis_angle, np.float64)
    th = np.linalg.norm(w)
    if th == 0:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def five_tuples(seed: int = 20, count: int = 20):
    """``count`` noise-free minimal sets (x1 [5, 2], x2 [5, 2], E [3, 3]):
    normalized views of 5 points 4-9 units in front of camera 0 under a
    random rotation (axis-angle in [-0.3, 0.3]^3) and translation (normal),
    with the true essential matrix [t]x R at unit Frobenius norm."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        R = rotation(rng.uniform(-0.3, 0.3, 3))
        t = rng.normal(size=3)
        X = rng.uniform([-2, -2, 4], [2, 2, 9], (5, 3))
        Y = X @ R.T + t
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]])
        E = tx @ R
        out.append((X[:, :2] / X[:, 2:], Y[:, :2] / Y[:, 2:],
                    E / np.linalg.norm(E)))
    return out
