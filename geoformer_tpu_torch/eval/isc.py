"""ISC-HE industrial homography estimation, and same-scene classification.

Counterpart of geoformer_tpu/eval/isc.py, the reference protocol
(eval_ISC.py, my_helper.py): query/refer pairs with normalised control
points (x1 y1 x2 y2 in [0, 1], scaled by each image's size), imsize 480,
the homography fitted in the resized frames and rescaled into the original
ones, AUC@[3, 5, 10] of each pair's mean control-point error (1e6 for a
failed fit), failed and inaccurate rates (largest error > 10 px or median
> 5 px). The classification protocol scores each ``query refer label``
line by its RANSAC inlier count and reports the ROC's equal-error rate.
The fits run on the caller's device (eval/hpatches.py); the raw image
sizes come from the files' headers (eval/image_io.read_size).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from geoformer_tpu_torch.eval.hpatches import fit_homography_np
from geoformer_tpu_torch.eval.image_io import read_size
from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray
from geoformer_tpu_torch.eval.metrics import cal_error_auc


def eval_isc(
    model,
    config,
    data_root: str,
    imsize: int = 480,
    ransac_thr: float = 3.0,
    thresholds=(3, 5, 10),
    batch_size: int = 2,
    max_pairs: Optional[int] = None,
    log=print,
    device="cuda",
) -> Dict:
    """Run the benchmark with ``model`` on ``device``. data_root layout:
    query/<name>_2.jpg, refer/<name>_1.jpg, gd/<name>_2-<name>_1.txt."""
    queries = sorted(glob.glob(os.path.join(data_root, "query", "*")))
    if max_pairs:
        queries = queries[:max_pairs]
    matcher = BatchedMatcher(config, model, batch_size=batch_size,
                             device=device)

    dists, inlier_rates = [], []
    failed = inaccurate = n = 0
    for q in queries:
        name = os.path.basename(q).split("_")[0]
        r = os.path.join(data_root, "refer", f"{name}_1.jpg")
        gd = os.path.join(data_root, "gd", f"{name}_2-{name}_1.txt")
        if not (os.path.exists(r) and os.path.exists(gd)):
            continue
        h1r, w1r = read_size(q)
        h2r, w2r = read_size(r)
        im1, sc1 = load_gray(q, imsize)
        im2, sc2 = load_gray(r, imsize)
        n += 1
        (mk0, mk1, _), = matcher.match_batch([im1], [im2])
        H, inl = fit_homography_np(mk0.astype(np.float32),
                                   mk1.astype(np.float32), ransac_thr,
                                   device=device)
        if H is None:
            failed += 1
            dists.append(1e6)
            inlier_rates.append(0.0)
            continue
        H = np.diag([sc2[0], sc2[1], 1.0]) @ H @ \
            np.diag([1.0 / sc1[0], 1.0 / sc1[1], 1.0])
        pts = np.loadtxt(gd)
        raw = pts[:, :2] * np.array([w1r, h1r])
        dst = pts[:, 2:4] * np.array([w2r, h2r])
        ph = np.concatenate([raw, np.ones((len(raw), 1))], 1)
        proj = ph @ H.T
        proj = proj[:, :2] / proj[:, 2:]
        d = np.sqrt(((dst - proj) ** 2).sum(1))
        if d.max() > 10 or np.median(d) > 5:
            inaccurate += 1
        dists.append(float(d.mean()))
        inlier_rates.append(float(inl.mean()))

    auc = cal_error_auc(dists, thresholds).tolist() if dists else []
    out = {
        "n_pairs": n, "failed": failed, "inaccurate": inaccurate,
        "auc": auc,
        "acceptable": (n - failed - inaccurate) / n if n else 0.0,
        "inlier_rate": float(np.mean(inlier_rates)) if inlier_rates else 0.0,
    }
    log(f">>ISC-HE: pairs={n} failed={failed} inaccurate={inaccurate} "
        f"AUC@{list(thresholds)}={auc}")
    return out


def roc_curve_np(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) by descending score, one point per distinct
    score (sklearn.roc_curve's construction, as the reference uses it)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    labels, scores = labels[order], scores[order]
    distinct = np.r_[np.where(np.diff(scores))[0], len(scores) - 1]
    tps = np.cumsum(labels)[distinct].astype(np.float64)
    fps = (distinct + 1 - tps).astype(np.float64)
    tpr = np.r_[0.0, tps / max(labels.sum(), 1)]
    fpr = np.r_[0.0, fps / max((~labels).sum(), 1)]
    thr = np.r_[scores[0] + 1, scores[distinct]]
    return fpr, tpr, thr


def compute_eer(labels: np.ndarray, scores: np.ndarray):
    """(equal-error rate, its threshold) from the ROC, by linear
    interpolation of the zero crossing of 1 - tpr - fpr."""
    fpr, tpr, thr = roc_curve_np(labels, scores)
    diff = (1.0 - tpr) - fpr
    idx = int(np.where(diff <= 0)[0][0]) if (diff <= 0).any() else len(fpr) - 1
    if idx == 0:
        return float(fpr[0]), float(thr[0])
    d0, d1 = diff[idx - 1], diff[idx]
    t = d0 / (d0 - d1) if d0 != d1 else 0.0
    eer = float(fpr[idx - 1] + t * (fpr[idx] - fpr[idx - 1]))
    thresh = float(thr[idx - 1] + t * (thr[idx] - thr[idx - 1]))
    return eer, thresh


def eval_isc_classification(
    model,
    config,
    pairs,
    imsize: int = 480,
    ransac_thr: float = 2.0,
    batch_size: int = 2,
    log=print,
    device="cuda",
) -> Dict:
    """Same-scene classification by RANSAC inlier count, then ROC and EER.

    pairs: (query_path, refer_path, label) triples with label in {0, 1},
    or the path of a text file of ``query refer label`` lines. A pair that
    fails to load or match counts as 0 inliers, its message logged."""
    if isinstance(pairs, str):
        with open(pairs) as f:
            pairs = [tuple(line.split()[:3]) for line in f if line.strip()]
    matcher = BatchedMatcher(config, model, batch_size=batch_size,
                             device=device)

    inlier_counts, classes = [], []
    match_failed = 0
    for q, r, lb in pairs:
        try:
            im1, sc1 = load_gray(q, imsize)
            im2, sc2 = load_gray(r, imsize)
            (mk0, mk1, _), = matcher.match_batch([im1], [im2])
            mk0o = mk0 * np.array(sc1)
            mk1o = mk1 * np.array(sc2)
            H, inl = fit_homography_np(mk0o.astype(np.float32),
                                       mk1o.astype(np.float32), ransac_thr,
                                       device=device)
            n_inl = int(inl.sum()) if H is not None else 0
        except Exception as e:  # a failed pair counts as 0 inliers
            log(f"match failed: {e}")
            match_failed += 1
            n_inl = 0
        inlier_counts.append(n_inl)
        classes.append(int(lb))

    eer, thresh = compute_eer(np.asarray(classes), np.asarray(inlier_counts))
    out = {"eer": eer, "threshold": thresh, "n_pairs": len(classes),
           "match_failed": match_failed}
    log(f">>ISC-cls: EER: {eer * 100:.2f}%, threshold: {thresh:.0f}")
    return out
