"""Textured-plane scenes rendered with exact per-pixel depth.

Counterpart of geoformer_tpu/data/planes.py, the posed-RGBD stand-in for
MegaDepth/ScanNet: a scene is a set of textured quads {origin + s*e1 +
t*e2}; a pinhole view composites them far to near by exact plane-induced
homography warps, giving the image and its ground-truth depth map.
plane_homography, look_at and room_scene are its code, with the same
``rng`` draws in the same order. render_planes warps with the port's
counterpart of cv2.warpPerspective (eval/hpatches_synth.warp_perspective:
INTER_LINEAR with a constant border of -1, so that edge taps mix with -1
as cv2's do) and takes the coverage mask by nearest-pixel lookup
(INTER_NEAREST of a ones texture), both from H^-1 in float64.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from geoformer_tpu_torch.eval.hpatches_synth import warp_perspective

Plane = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def plane_homography(K: np.ndarray, T: np.ndarray, origin: np.ndarray,
                     e1: np.ndarray, e2: np.ndarray,
                     tex_hw: Tuple[int, int]) -> np.ndarray:
    """Image-from-texture homography for the quad {origin + s*e1 + t*e2},
    texture pixel (u, v) = (s * (W-1), t * (H-1))."""
    R, t = T[:3, :3], T[:3, 3]
    th, tw = tex_hw
    M = np.stack([e1, e2, origin], axis=1)
    H_img_from_st = K @ (R @ M + t[:, None] @ np.array([[0.0, 0.0, 1.0]]))
    S = np.diag([1.0 / (tw - 1), 1.0 / (th - 1), 1.0])
    return H_img_from_st @ S


def coverage_mask(H: np.ndarray, tex_hw: Tuple[int, int],
                  out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.warpPerspective(ones(tex_hw), H, out, INTER_NEAREST) > 0.5: the
    output pixels whose source position, rounded half to even, lies on the
    texture."""
    th, tw = tex_hw
    h, w = out_hw
    hi = np.linalg.inv(np.asarray(H, np.float64))
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    d = hi[2, 0] * x + hi[2, 1] * y + hi[2, 2]
    inv = np.divide(1.0, d, out=np.zeros_like(d), where=d != 0)
    with np.errstate(invalid="ignore", over="ignore"):
        sx = np.rint((hi[0, 0] * x + hi[0, 1] * y + hi[0, 2]) * inv)
        sy = np.rint((hi[1, 0] * x + hi[1, 1] * y + hi[1, 2]) * inv)
    return (sx >= 0) & (sx < tw) & (sy >= 0) & (sy < th)


def render_planes(K: np.ndarray, T: np.ndarray, planes: Sequence[Plane],
                  hw: Tuple[int, int], return_depth: bool = False):
    """Composite plane textures far to near with a per-pixel z-buffer.

    Returns the image in [0, 1]; with ``return_depth`` also the depth map
    (0 where no plane is visible, MegaDepth's invalid-depth convention)."""
    h, w = hw
    img = np.zeros((h, w), np.float32)
    depth = np.full((h, w), np.inf, np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    st = np.stack([xx, yy, np.ones_like(xx)], 0).reshape(3, -1)
    for origin, e1, e2, tex in planes:
        Hm = plane_homography(K, T, origin, e1, e2, tex.shape)
        warped = warp_perspective(tex, Hm, (h, w), border=-1.0)
        mask = coverage_mask(Hm, tex.shape, (h, w))
        # per-pixel depth of the plane: z of the world point seen at (x, y)
        uv = np.linalg.inv(Hm) @ st
        with np.errstate(divide="ignore", invalid="ignore"):
            # off-quad pixels divide by ~0; `mask` drops them below
            s = uv[0] / uv[2]
            tt = uv[1] / uv[2]
            th, tw = tex.shape
            Xw = (origin[:, None] + e1[:, None] * (s / (tw - 1))
                  + e2[:, None] * (tt / (th - 1)))
        z = (T[:3, :3] @ Xw + T[:3, 3:4])[2].reshape(h, w)
        vis = mask & (z > 0.1) & (z < depth)
        img[vis] = warped[vis]
        depth[vis] = z[vis]
    img = np.clip(img, 0.0, 1.0)
    if return_depth:
        return img, np.where(np.isfinite(depth), depth, 0.0).astype(
            np.float32)
    return img


def look_at(center, target, up=(0, -1, 0)) -> np.ndarray:
    """World->camera 4x4 for a camera at ``center`` looking at ``target``."""
    z = np.asarray(target, float) - np.asarray(center, float)
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, float), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ np.asarray(center, float)
    return T


def room_scene(rng: np.random.Generator, textures: np.ndarray,
               depth_z: float = 8.0, cluttered: bool = False) -> List[Plane]:
    """A random 3-5-plane room: back wall, floor, side wall, optionally a
    ceiling strip and free-standing slabs, with jittered extents.
    ``cluttered`` guarantees the ceiling and (textures permitting) one or
    two slabs at staggered depths, so that the matches of a view do not
    all lie on one plane (the essential matrix is degenerate there)."""
    zb = depth_z * rng.uniform(0.85, 1.15)
    planes: List[Plane] = [
        (np.array([-5.0, -3.0, zb]), np.array([10.0, 0, 0]),
         np.array([0, 6.0, 0]), textures[0]),
        (np.array([-5.0, rng.uniform(1.8, 2.5), 2.0]),
         np.array([10.0, 0, 0]),
         np.array([0, rng.uniform(0.8, 1.5), zb - 2.0]), textures[1]),
        (np.array([rng.choice([-4.5, 4.5]), -3.0, 2.0]),
         np.array([0, 0, zb - 2.0]), np.array([0, 6.0, 0]), textures[2]),
    ]
    if len(textures) > 3 and (cluttered or rng.random() < 0.6):
        planes.append(
            (np.array([-5.0, rng.uniform(-3.0, -2.2), 2.5]),
             np.array([10.0, 0, 0]),
             np.array([0, rng.uniform(-0.8, -0.2), zb - 2.5]), textures[3]))
    n_slabs = 0
    if len(textures) > 4:
        n_slabs = (1 + int(rng.random() < 0.7) if cluttered
                   else int(rng.random() < 0.5))
    for k in range(n_slabs):
        cx = rng.uniform(-2.5, 2.5)
        zc = zb * rng.uniform(0.42, 0.75)
        tex = textures[4 + (k % max(1, len(textures) - 4))]
        planes.append(
            (np.array([cx - 1.2, rng.uniform(-1.2, 0.6), zc]),
             np.array([rng.uniform(2.0, 3.0), 0, rng.uniform(-0.8, 0.8)]),
             np.array([rng.uniform(-0.4, 0.4), rng.uniform(1.8, 2.6), 0]),
             tex))
    return planes
