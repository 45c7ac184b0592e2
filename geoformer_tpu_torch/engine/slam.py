"""Planar SLAM over an image sequence: matcher -> pairwise RANSAC
homographies -> SL(3) pose-graph optimization.

Counterpart of geoformer_tpu/engine/slam.py: the matcher's
correspondences become a homography-world trajectory. The matcher is
injectable, so the pipeline runs without trained weights; cli.py `slam`
wires BatchedMatcher. The pairwise fits (eval/hpatches.fit_homography_np)
and the graph solve run on ``device``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from geoformer_tpu_torch.engine.homography_graph import (
    HomographyGraph,
    optimize_homography_graph,
)
from geoformer_tpu_torch.eval.hpatches import fit_homography_np
from geoformer_tpu_torch.geometry.homography import corner_error


def build_edges(n_frames: int, loop_stride: int = 0
                ) -> List[Tuple[int, int]]:
    """Consecutive edges + optional loop-closure edges every ``loop_stride``
    frames (i, i+loop_stride)."""
    edges = [(k, k + 1) for k in range(n_frames - 1)]
    if loop_stride > 1:
        edges += [(k, k + loop_stride)
                  for k in range(0, n_frames - loop_stride)]
    return edges


def run_planar_slam(
    frames: Sequence[np.ndarray],
    match_fn: Callable[[int, int], Tuple[np.ndarray, np.ndarray]],
    loop_stride: int = 0,
    ransac_thr: float = 3.0,
    graph_iters: int = 20,
    loop_weight: float = 3.0,
    log=print,
    device="cuda",
) -> Dict:
    """Estimate a globally consistent planar trajectory.

    Args:
        frames: sequence of images (only len/shape used here).
        match_fn: (i, j) -> (mkpts_i [N,2], mkpts_j [N,2]) correspondences.
        loop_stride: add (i, i+stride) loop edges when > 1.
    Returns:
        dict with 'H_traj' [K,3,3] (H_traj[k] maps frame-0 points into
        frame k), 'H_chained' (before optimization), 'edges' diagnostics.
    """
    K = len(frames)
    edges = build_edges(K, loop_stride)
    ei, ej, eH, weights, diag = [], [], [], [], []
    consecutive_H: Dict[int, np.ndarray] = {}
    for (a, b) in edges:
        mk0, mk1 = match_fn(a, b)
        Hp, inl = fit_homography_np(np.asarray(mk0, np.float32),
                                    np.asarray(mk1, np.float32),
                                    thr=ransac_thr, device=device)
        if Hp is None:
            log(f"edge {a}->{b}: fit failed ({len(mk0)} matches)")
            diag.append({"i": a, "j": b, "ok": False,
                         "n_matches": int(len(mk0))})
            continue
        ph = np.concatenate([mk0, np.ones((len(mk0), 1))], 1) @ Hp.T
        proj = ph[:, :2] / ph[:, 2:]
        res = np.linalg.norm(proj - np.asarray(mk1), axis=1)[inl]
        rms = float(np.sqrt((res ** 2).mean())) if inl.any() else 10.0
        w = (1.0 / max(rms, 0.05)) * (loop_weight if b - a > 1 else 1.0)
        ei.append(a)
        ej.append(b)
        eH.append(Hp.astype(np.float32))
        weights.append(w)
        if b == a + 1:
            consecutive_H[a] = Hp
        diag.append({"i": a, "j": b, "ok": True,
                     "n_matches": int(len(mk0)),
                     "n_inliers": int(inl.sum()), "rms_px": round(rms, 3)})

    # chained odometry from consecutive edges (identity where a fit failed)
    H0 = [np.eye(3, dtype=np.float32)]
    for k in range(K - 1):
        Hk = consecutive_H.get(k, np.eye(3, dtype=np.float32))
        H0.append((Hk @ H0[-1]).astype(np.float32))
    H0 = np.stack(H0)

    if not ei:
        return {"H_traj": H0, "H_chained": H0, "edges": diag}

    device = torch.device(device)
    graph = HomographyGraph(
        H=torch.from_numpy(H0).to(device),
        edge_i=torch.tensor(ei, device=device),
        edge_j=torch.tensor(ej, device=device),
        edge_H=torch.from_numpy(np.stack(eH)).to(device),
        edge_valid=torch.ones(len(ei), dtype=torch.bool, device=device),
        edge_weight=torch.tensor(weights, dtype=torch.float32,
                                 device=device))
    opt, _ = optimize_homography_graph(graph, iters=graph_iters)
    return {"H_traj": opt.cpu().numpy(), "H_chained": H0, "edges": diag}


def trajectory_drift(H_traj: np.ndarray, H_gt: np.ndarray,
                     image_hw) -> float:
    """Mean corner drift (px) of an estimated homography trajectory vs GT,
    the homography-world ATE (f32, on the host)."""
    return float(np.mean([
        float(corner_error(torch.from_numpy(np.asarray(H_traj[k],
                                                       np.float32)),
                           torch.from_numpy(np.asarray(H_gt[k], np.float32)),
                           image_hw))
        for k in range(len(H_traj))]))


def save_trajectory(H_traj: np.ndarray, path: str):
    """One line per frame: k h00 h01 ... h22 (row-major, frame0->framek)."""
    with open(path, "w") as f:
        for k, Hk in enumerate(H_traj):
            vals = " ".join(f"{x:.8f}" for x in np.asarray(Hk).ravel())
            f.write(f"{k} {vals}\n")
