"""HPatches homography estimation and matching evaluation.

Counterpart of geoformer_tpu/eval/hpatches.py, the reference protocol
(eval_Hpatches.py, hpatches_helper.py): sequences of ``1.ppm`` ... ``6.ppm``
with ground truth ``H_1_k``, each image's shorter edge resized to
``imsize`` on the /8 grid, the ground truth rescaled into the resized
frames, matching accuracy (MMA) at 1-15 px, a robust homography fit on the
matches and its mean corner error, correctness and AUC at 1/3/5/10 px,
split into illumination (``i_*``) and viewpoint (``v_*``) sequences.

The fit is the port's batched RANSAC (geometry/ransac.py) on the device the
caller gives, with 2048 hypotheses drawn from a torch.Generator seeded with
``seed`` on that device (the JAX package's draws cannot be reproduced;
a caller may inject ``sample_idx``).
"""

from __future__ import annotations

import glob
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from geoformer_tpu_torch.eval.image_io import read_size
from geoformer_tpu_torch.eval.matcher import (
    BatchedMatcher,
    load_gray,
    resize_shape,
)
from geoformer_tpu_torch.eval.metrics import (
    cal_error_auc,
    corner_error,
    correctness,
    reproj_dists,
)
from geoformer_tpu_torch.geometry.ransac import ransac_homography


def _scale_H(sx: float, sy: float) -> np.ndarray:
    return np.diag([sx, sy, 1.0])


def fit_capacity(n: int, cap: int = 4096) -> int:
    """Padded point count of a fit on n correspondences: the next power of
    two, at least 64, at most ``cap``."""
    return max(64, min(cap, int(2 ** np.ceil(np.log2(min(n, cap))))))


def fit_homography_np(p0: np.ndarray, p1: np.ndarray, thr: float,
                      iters: int = 2048, cap: int = 4096, seed: int = 0,
                      device="cuda",
                      sample_idx: Optional[np.ndarray] = None):
    """Robust homography fit of host point sets on ``device``: (H [3, 3],
    inlier mask [n]) as numpy arrays, or (None, None) under 4 points or
    when the fit fails. Points beyond ``cap`` are dropped with a warning.
    ``sample_idx`` ([iters, 4] indices into the fit_capacity(n) padded
    points) replaces the generator's draws."""
    n = len(p0)
    if n < 4:
        return None, None
    if n > cap:
        warnings.warn(f"fit_homography_np: truncating {n} -> {cap} "
                      "correspondences (raise cap= to keep them all)")
        n = cap
    m = fit_capacity(n, cap)
    a = np.zeros((1, m, 2), np.float32)
    b = np.zeros((1, m, 2), np.float32)
    v = np.zeros((1, m), bool)
    a[0, :n], b[0, :n], v[0, :n] = p0[:n], p1[:n], True
    device = torch.device(device)
    a, b, v = (torch.from_numpy(x).to(device) for x in (a, b, v))
    if sample_idx is not None:
        idx = torch.tensor(np.asarray(sample_idx), dtype=torch.long,
                           device=device)[None]
        gen = None
    else:
        idx = None
        gen = torch.Generator(device).manual_seed(seed)
    out = ransac_homography(a, b, v, thr=thr, iters=iters, refine_iters=3,
                            sample_idx=idx, generator=gen)
    if not bool(out["ok"][0]):
        return None, None
    return out["H"][0].cpu().numpy(), out["inliers"][0, :n].cpu().numpy()


def _sequence_shapes(seq_dirs, imsize: int):
    """One ((h, w), (h, w)) entry a sequence: the elementwise largest
    resized shape of its images, the bucket that match_batch pads the whole
    sequence into (read from the files' headers)."""
    pair_shapes = []
    for seq_dir in seq_dirs:
        paths = [os.path.join(seq_dir, f"{i}.ppm") for i in range(1, 7)]
        if not os.path.exists(paths[0]):
            continue
        shapes = []
        for p in filter(os.path.exists, paths):
            ho, wo = read_size(p)
            wt, ht, _ = resize_shape(wo, ho, imsize)
            shapes.append((ht, wt))
        joint = (max(h for h, _ in shapes), max(w for _, w in shapes))
        pair_shapes.append((joint, joint))
    return pair_shapes


def eval_hpatches(
    model,
    config,
    data_root: str,
    imsize: int = 480,
    ransac_thr: float = 3.0,
    thresholds=(1, 3, 5, 10),
    batch_size: int = 2,
    max_seqs: Optional[int] = None,
    task: str = "both",
    prewarm: bool = True,
    log=print,
    device="cuda",
) -> Dict:
    """Run the benchmark with ``model`` (a GeoFormer of ``config``) on
    ``device``; returns the JAX package's dict of metrics."""
    seq_dirs = sorted(glob.glob(os.path.join(data_root, "*")))
    if max_seqs:
        seq_dirs = seq_dirs[:max_seqs]
    matcher = BatchedMatcher(config, model, batch_size=batch_size,
                             device=device)
    if prewarm:
        matcher.prewarm(_sequence_shapes(seq_dirs, imsize), log=log)

    dists_all, dists_i, dists_v = [], [], []
    inlier_rates, n_matches, match_times = [], [], []
    h_failed = 0
    mma = {t: [] for t in range(1, 16)}
    mma_i = {t: [] for t in range(1, 16)}
    mma_v = {t: [] for t in range(1, 16)}

    for seq_dir in seq_dirs:
        sname = os.path.basename(seq_dir)
        im1_path = os.path.join(seq_dir, "1.ppm")
        if not os.path.exists(im1_path):
            continue
        im1, sc1 = load_gray(im1_path, imsize)
        pairs, gts = [], []
        for idx in range(2, 7):
            H_gt = np.loadtxt(os.path.join(seq_dir, f"H_1_{idx}"))
            im2, sc2 = load_gray(os.path.join(seq_dir, f"{idx}.ppm"), imsize)
            pairs.append(im2)
            # the ground truth in the resized frames
            gts.append(np.linalg.inv(_scale_H(*sc2)) @ H_gt
                       @ _scale_H(*sc1))

        t0 = time.time()
        results = matcher.match_batch([im1] * len(pairs), pairs)
        match_times.append((time.time() - t0) / len(pairs))

        split_mma = mma_i if sname[0] == "i" else mma_v
        split_dists = dists_i if sname[0] == "i" else dists_v
        for (mk0, mk1, _), H_gt in zip(results, gts):
            n_matches.append(len(mk0))
            if "matching" in task or task == "both":
                d = (reproj_dists(mk0, mk1, H_gt) if len(mk0)
                     else np.array([np.inf]))
                for t in mma:
                    mma[t].append((d <= t).mean())
                    split_mma[t].append((d <= t).mean())
            if "homography" in task or task == "both":
                H_pred, inliers = fit_homography_np(mk0, mk1, ransac_thr,
                                                    device=device)
                if H_pred is None:
                    h_failed += 1
                    dist = np.nan
                    inlier_rates.append(0.0)
                else:
                    dist = corner_error(H_gt, H_pred, im1.shape)
                    inlier_rates.append(float(inliers.mean()))
                dists_all.append(dist)
                split_dists.append(dist)

    out = {
        "n_pairs": len(dists_all) or len(n_matches),
        "est_failed": h_failed,
        "mean_matches": float(np.mean(n_matches)) if n_matches else 0.0,
        "match_time": float(np.mean(match_times)) if match_times else 0.0,
        "inlier_rate": float(np.mean(inlier_rates)) if inlier_rates else 0.0,
    }
    if dists_all:
        for split, d in (("a", dists_all), ("i", dists_i), ("v", dists_v)):
            out[f"correct_{split}"] = correctness(d, thresholds).tolist()
        for split, d in (("a", dists_all), ("i", dists_i), ("v", dists_v)):
            out[f"auc_{split}"] = cal_error_auc(d, thresholds).tolist()
    if any(len(v) for v in mma.values()):
        for split, m in (("a", mma), ("i", mma_i), ("v", mma_v)):
            out[f"mma_{split}"] = {t: float(np.mean(v))
                                   for t, v in m.items() if v}

    log(f">>HPatches: pairs={out['n_pairs']} est_failed={h_failed} "
        f"matches={out['mean_matches']:.1f} time={out['match_time']:.3f}s")
    if "auc_a" in out:
        log(f"Hest Correct: a={out['correct_a']}")
        log(f"Hest AUC:     a={out['auc_a']}")
        log(f"   illum AUC: i={out['auc_i']}")
        log(f"   view  AUC: v={out['auc_v']}")
    return out
