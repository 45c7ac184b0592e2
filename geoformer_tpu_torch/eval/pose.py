"""Relative-pose AUC aggregation (MegaDepth/ScanNet validation).

Counterpart of geoformer_tpu/eval/pose.py. error_auc and
aggregate_metrics are its numpy code. The host pose estimator of the JAX
package (estimate_pose, and pose_error_for_pair on it) wraps OpenCV's
findEssentialMat (Nister's 5-point RANSAC) and recoverPose, which the port
does not have: they raise NotImplementedError. The validation's default
backend, the on-device essential RANSAC (geometry/essential.py), is ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

HOST_POSE = ("the host pose estimator wraps cv2.findEssentialMat and "
             "cv2.recoverPose (Nister's 5-point RANSAC), which the port does "
             "not carry; use the device backend "
             "(geometry/essential.batched_pose_errors)")


def estimate_pose(kpts0, kpts1, K0, K1, thresh: float = 0.5,
                  conf: float = 0.99999):
    raise NotImplementedError(HOST_POSE)


def pose_error_for_pair(mkpts0, mkpts1, K0, K1, T_0to1,
                        thresh: float = 0.5):
    raise NotImplementedError(HOST_POSE)


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
