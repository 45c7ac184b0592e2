"""Benchmark metrics: error AUC, correctness rates, reprojection distances.

A copy of geoformer_tpu/eval/metrics.py (numpy only), itself an exact
reimplementation of the reference's hpatches_helper.py:13-57, so that AUC
numbers of both packages are directly comparable.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def cal_error_auc(errors: Sequence[float], thresholds: Sequence[float]
                  ) -> np.ndarray:
    """Area under the cumulative error curve at each threshold. NaN errors
    count as infinite."""
    errors = np.asarray(errors, np.float64)
    errors = np.where(np.isnan(errors), np.inf, errors)
    if errors.size == 0:
        return np.zeros(len(thresholds))
    n = len(errors)
    errors = np.append([0.0], np.sort(errors))
    recalls = np.arange(n + 1) / n
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        rcs = np.append(recalls[:last], recalls[last - 1])
        errs = np.append(errors[:last], t)
        aucs.append(np.trapezoid(rcs, x=errs) / t)
    return np.array(aucs)


def correctness(errors: Sequence[float], thresholds: Sequence[float]
                ) -> np.ndarray:
    """Fraction of errors at or below each threshold (NaN = failure)."""
    errors = np.asarray(errors, np.float64)
    errors = np.where(np.isnan(errors), np.inf, errors)
    if errors.size == 0:
        return np.zeros(len(thresholds))
    return np.array([(errors <= t).mean() for t in thresholds])


def reproj_dists(p1s: np.ndarray, p2s: np.ndarray, H: np.ndarray
                 ) -> np.ndarray:
    """Distances between p1s mapped through H and p2s."""
    ph = np.concatenate([p1s, np.ones((len(p1s), 1))], axis=1)
    proj = ph @ H.T
    proj = proj[:, :2] / proj[:, 2:]
    return np.sqrt(((p2s - proj) ** 2).sum(axis=1))


def corner_error(H_gt: np.ndarray, H_pred: np.ndarray, hw) -> float:
    """Mean distance of the four image corners (pixel centres (0, 0) to
    (w - 1, h - 1)) mapped through H_gt and H_pred: the HPatches homography
    error."""
    h, w = hw
    corners = np.array([[0, 0, 1], [0, h - 1, 1], [w - 1, 0, 1],
                        [w - 1, h - 1, 1]], np.float64)
    wr = corners @ H_gt.T
    wp = corners @ np.asarray(H_pred, np.float64).T
    return float(np.linalg.norm(wr[:, :2] / wr[:, 2:] - wp[:, :2] / wp[:, 2:],
                                axis=1).mean())
