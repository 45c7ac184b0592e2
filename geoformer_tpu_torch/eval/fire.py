"""FIRE retinal image registration evaluation.

Counterpart of geoformer_tpu/eval/fire.py, the reference protocol
(eval_FIRE.py, fire_helper.py): pairs in classes S/P/A (P37 excluded),
imsize 768, RANSAC threshold 15 resized pixels. The query image ``_2`` is
matched against the reference ``_1``; the homography is fitted in the
resized frames and rescaled into the original ones; a pair's error is the
mean distance of its 10 control points of image 2, warped by it, to those
of image 1 (inf for a failed fit). AUC per class is the mean over
thresholds 1..25 px of the share of pairs strictly below it; mAUC is their
mean; a pair is inaccurate where its largest error exceeds 50 px or its
median 20 px. The fit runs on the caller's device (eval/hpatches.py).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from geoformer_tpu_torch.eval.hpatches import fit_homography_np
from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray


def _auc_curve(errors: np.ndarray, limit: int = 25) -> float:
    """Mean over thresholds 1..limit of the share of errors strictly below
    the threshold."""
    if errors.size == 0:
        return 0.0
    rates = [(errors < t).mean() for t in range(1, limit + 1)]
    return float(np.mean(rates))


def eval_fire(
    model,
    config,
    data_root: str,
    imsize: int = 768,
    ransac_thr: float = 15.0,
    batch_size: int = 2,
    max_pairs: Optional[int] = None,
    log=print,
    device="cuda",
) -> Dict:
    """Run the benchmark with ``model`` (a GeoFormer of ``config``) on
    ``device``. data_root is in the official layout: images/<PAIR>_1.jpg,
    images/<PAIR>_2.jpg, ground_truth/control_points_<PAIR>_1_2.txt
    ([10, 4]: x1 y1 x2 y2)."""
    gt_files = sorted(glob.glob(
        os.path.join(data_root, "ground_truth", "control_points_*_1_2.txt")))
    gt_files = [g for g in gt_files if "P37" not in g]
    if max_pairs:
        gt_files = gt_files[:max_pairs]

    matcher = BatchedMatcher(config, model, batch_size=batch_size,
                             device=device)
    errs = {"S": [], "P": [], "A": []}
    failed, inaccurate = 0, 0
    n = 0

    for gt in gt_files:
        pair = os.path.basename(gt)[len("control_points_"):-len("_1_2.txt")]
        cls = pair[0]
        im1p = os.path.join(data_root, "images", f"{pair}_1.jpg")
        im2p = os.path.join(data_root, "images", f"{pair}_2.jpg")
        if not (os.path.exists(im1p) and os.path.exists(im2p)):
            continue
        pts = np.loadtxt(gt)
        im1, sc1 = load_gray(im1p, imsize)        # _1: reference
        im2, sc2 = load_gray(im2p, imsize)        # _2: query
        (mkq, mkr, _), = matcher.match_batch([im2], [im1])
        n += 1
        H, _ = fit_homography_np(mkq.astype(np.float32),
                                 mkr.astype(np.float32), ransac_thr,
                                 device=device)
        if H is None:
            failed += 1
            errs[cls].append(np.inf)
            continue
        H = np.diag([sc1[0], sc1[1], 1.0]) @ H @ \
            np.diag([1.0 / sc2[0], 1.0 / sc2[1], 1.0])
        p2 = np.concatenate([pts[:, 2:4], np.ones((len(pts), 1))], 1)
        proj = p2 @ H.T
        proj = proj[:, :2] / proj[:, 2:]
        d = np.sqrt(((proj - pts[:, :2]) ** 2).sum(1))
        mae, mee = d.max(), np.median(d)
        if mae > 50 or mee > 20:
            inaccurate += 1
        errs[cls].append(float(d.mean()))

    aucs = {c: _auc_curve(np.asarray(v)) for c, v in errs.items() if v}
    mauc = float(np.mean(list(aucs.values()))) if aucs else 0.0
    out = {"n_pairs": n, "failed": failed, "inaccurate": inaccurate,
           "auc_per_class": aucs, "mAUC": mauc}
    log(f">>FIRE: pairs={n} failed={failed} inaccurate={inaccurate} "
        f"AUC={aucs} mAUC={mauc:.4f}")
    return out
