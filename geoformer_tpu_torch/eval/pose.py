"""Relative pose from matches, and its AUC (MegaDepth/ScanNet validation).

Counterpart of geoformer_tpu/eval/pose.py, with its numpy code for
error_auc and aggregate_metrics. The host pose estimator (estimate_pose,
and pose_error_for_pair on it) is the JAX package's, the reference's
metric (metrics.py:72-134), with OpenCV's findEssentialMat (Nister's
5-point RANSAC) and recoverPose carried by geometry/five_point.py in
numpy float64: the port imports no cv2. The validation's default backend,
the on-device essential RANSAC (geometry/essential.py), is the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from geoformer_tpu_torch.geometry.depth import relative_pose_error
from geoformer_tpu_torch.geometry.five_point import (
    find_essential_mat,
    recover_pose,
)


def estimate_pose(kpts0: np.ndarray, kpts1: np.ndarray, K0: np.ndarray,
                  K1: np.ndarray, thresh: float = 0.5, conf: float = 0.99999,
                  iters: Optional[List[int]] = None):
    """(R, t, inlier_mask) from matched pixel keypoints [N, 2], or None:
    the keypoints normalized by their intrinsics, the essential RANSAC at
    ``thresh`` px over the reference's mean focal length (f0x, f1y, f0x,
    f1y), then of its solutions the one with most points in front of both
    cameras (recover_pose, distance threshold 1e9). ``iters``, a list when
    given, gets the RANSAC's iteration count where it runs (5 points or
    more)."""
    if len(kpts0) < 5:
        return None
    K0 = np.asarray(K0, np.float64)
    K1 = np.asarray(K1, np.float64)
    norm0 = (kpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    norm1 = (kpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    ransac_thr = thresh / np.mean([K0[0, 0], K1[1, 1], K0[0, 0], K1[1, 1]])
    E, mask, n_iters = find_essential_mat(norm0, norm1, ransac_thr,
                                          prob=conf)
    if iters is not None:
        iters.append(n_iters)
    if E is None:
        return None
    best = (0, None, None, None)
    for e in np.split(E, len(E) // 3):
        n, R, t, _ = recover_pose(e, norm0, norm1, 1e9, mask=mask.copy())
        if n > best[0]:
            best = (n, R, t[:, 0], mask.ravel() > 0)
    return best[1:] if best[0] > 0 else None


def pose_error_for_pair(mkpts0: np.ndarray, mkpts1: np.ndarray,
                        K0: np.ndarray, K1: np.ndarray, T_0to1: np.ndarray,
                        thresh: float = 0.5,
                        iters: Optional[List[int]] = None):
    """(t_err_deg, R_err_deg, inliers) of a pair's estimated pose against
    T_0to1; (inf, inf, []) when no pose is found. ``iters`` as
    estimate_pose takes it."""
    ret = estimate_pose(mkpts0, mkpts1, K0, K1, thresh, iters=iters)
    if ret is None:
        return float("inf"), float("inf"), np.array([])
    R, t, inliers = ret
    t_err, R_err = relative_pose_error(T_0to1, R, t, ignore_gt_t_thr=0.0)
    return t_err, R_err, inliers


def error_auc(errors: Sequence[float], thresholds=(5, 10, 20)) -> Dict:
    """Pose AUC by the cumulative-recall trapezoid."""
    errors = np.asarray(errors, np.float64)
    errors = np.where(np.isnan(errors), np.inf, errors)
    errors = np.sort(np.append([0.0], errors))
    recall = np.arange(len(errors)) / (len(errors) - 1) if len(errors) > 1 \
        else np.zeros(1)
    out = {}
    for t in thresholds:
        last = np.searchsorted(errors, t)
        y = np.append(recall[:last], recall[last - 1])
        x = np.append(errors[:last], t)
        out[f"auc@{t}"] = float(np.trapezoid(y, x) / t)
    return out


def aggregate_metrics(metrics: Dict[str, List], epi_err_thr: float = 5e-4,
                      thresholds=(5, 10, 20)) -> Dict:
    """Pose AUC and epipolar precision over pairs deduplicated by id (the
    last occurrence of an id is kept, as the reference's OrderedDict
    overwrite keeps it)."""
    ids = metrics["identifiers"]
    last = {}
    for i, idn in enumerate(ids):
        last[idn] = i
    keep = np.asarray(sorted(last.values()))
    pose_errs = np.maximum(np.asarray(metrics["R_errs"])[keep],
                           np.asarray(metrics["t_errs"])[keep])
    out = error_auc(pose_errs, thresholds)
    prec = [np.mean(np.asarray(e) < epi_err_thr) if len(e) else 0.0
            for i, e in enumerate(metrics["epi_errs"]) if i in set(keep)]
    out[f"prec@{epi_err_thr:.0e}"] = float(np.mean(prec)) if prec else 0.0
    return out
