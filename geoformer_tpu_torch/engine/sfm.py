"""Structure-from-motion glue: triangulation, track chaining, and the BA
problem built from matcher output.

Counterpart of geoformer_tpu/engine/sfm.py: correspondences from the
matcher become multi-view tracks, triangulated landmarks, and a
capacity-padded BAProblem for the Schur solver (engine/ba.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from geoformer_tpu_torch.engine.ba import BAProblem
from geoformer_tpu_torch.engine.lie import full_f32


def _triangulate_pairs(T0: torch.Tensor, T1: torch.Tensor, K: torch.Tensor,
                       uv0: torch.Tensor, uv1: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of N points, each from its own two views:
    T0/T1 [N, 4, 4], K [3, 3], uv0/uv1 [N, 2] -> [N, 3]."""
    P0 = K @ T0[:, :3, :]                                # [N, 3, 4]
    P1 = K @ T1[:, :3, :]
    A = torch.stack([
        uv0[:, 0:1] * P0[:, 2] - P0[:, 0],
        uv0[:, 1:2] * P0[:, 2] - P0[:, 1],
        uv1[:, 0:1] * P1[:, 2] - P1[:, 0],
        uv1[:, 1:2] * P1[:, 2] - P1[:, 1],
    ], 1)                                                # [N, 4, 4]
    _, v = torch.linalg.eigh(A.transpose(1, 2) @ A)
    X = v[..., :, 0]
    w = X[:, 3:]
    return X[:, :3] / torch.where(w.abs() < 1e-12,
                                  torch.full_like(w, 1e-12), w)


def triangulate(T0: torch.Tensor, T1: torch.Tensor, K: torch.Tensor,
                uv0: torch.Tensor, uv1: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) two-view triangulation.

    Args:
        T0, T1: [4, 4] world->cam poses.
        K: [3, 3] shared intrinsics.
        uv0, uv1: [N, 2] pixel observations.
    Returns:
        [N, 3] world points.
    """
    n = uv0.shape[0]
    with full_f32():
        return _triangulate_pairs(T0.expand(n, 4, 4), T1.expand(n, 4, 4), K,
                                  uv0, uv1)


def chain_tracks(pair_matches: Sequence[Tuple[np.ndarray, np.ndarray]],
                 cell: float = 8.0) -> List[List[Tuple[int, np.ndarray]]]:
    """Link per-pair matches into multi-frame tracks (host-side).

    Args:
        pair_matches: list over frames i of (kpts_i [N,2], kpts_{i+1} [N,2]).
        cell: quantization for linking frame i's match endpoints to frame i's
            query grid of the next pair (the matcher anchors queries on the
            coarse grid, so endpoints land near grid centres).
    Returns:
        tracks: list of [(frame_idx, uv), ...] with length >= 2.
    """
    open_tracks: Dict[Tuple[int, int], list] = {}
    done: List[list] = []
    for fi, (k0, k1) in enumerate(pair_matches):
        next_open: Dict[Tuple[int, int], list] = {}
        for a, b in zip(np.asarray(k0), np.asarray(k1)):
            keya = (int(round(a[0] / cell)), int(round(a[1] / cell)))
            tr = open_tracks.pop(keya, None)
            if tr is None:
                tr = [(fi, a)]
            tr.append((fi + 1, b))
            keyb = (int(round(b[0] / cell)), int(round(b[1] / cell)))
            next_open[keyb] = tr
        done.extend(tr for tr in open_tracks.values())
        open_tracks = next_open
    done.extend(open_tracks.values())
    return [t for t in done if len(t) >= 2]


def build_ba_problem(cams: np.ndarray, K: np.ndarray,
                     tracks: List[List[Tuple[int, np.ndarray]]],
                     max_points: int, max_obs: int,
                     device="cuda") -> BAProblem:
    """Triangulate tracks (first/last observation) and pack a fixed-capacity
    BAProblem on ``device``."""
    tracks = tracks[:max_points]
    pts = np.zeros((max_points, 3), np.float32)
    obs_cam = np.zeros(max_obs, np.int64)
    obs_pt = np.zeros(max_obs, np.int64)
    obs_uv = np.zeros((max_obs, 2), np.float32)
    obs_valid = np.zeros(max_obs, bool)

    def dev(a):
        return torch.as_tensor(a, device=device)

    # triangulate in one batch from each track's first/last view
    f0 = np.array([t[0][0] for t in tracks], np.int64)
    f1 = np.array([t[-1][0] for t in tracks], np.int64)
    uv0 = np.stack([t[0][1] for t in tracks]).astype(np.float32)
    uv1 = np.stack([t[-1][1] for t in tracks]).astype(np.float32)
    cams_t = dev(np.asarray(cams, np.float32))
    K_t = dev(np.asarray(K, np.float32))
    with full_f32():
        X = _triangulate_pairs(cams_t[dev(f0)], cams_t[dev(f1)], K_t,
                               dev(uv0), dev(uv1))
    pts[:len(tracks)] = X.cpu().numpy()

    n = 0
    for pi, tr in enumerate(tracks):
        for (fi, uv) in tr:
            if n >= max_obs:
                break
            obs_cam[n] = fi
            obs_pt[n] = pi
            obs_uv[n] = uv
            obs_valid[n] = True
            n += 1
    return BAProblem(cams=cams_t, points=dev(pts), K=K_t,
                     obs_cam=dev(obs_cam), obs_pt=dev(obs_pt),
                     obs_uv=dev(obs_uv), obs_valid=dev(obs_valid))
