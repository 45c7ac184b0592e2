"""Held-out accuracy self-check: synthetic HPatches-style pairs.

Counterpart of scripts/selfcheck_eval.py. Base images (the procedural
textures of cpp/synthgen.cpp from ``--seed``, or photographs) are warped by
known random homographies; the model matches each pair, the port's RANSAC
fits a homography to the matches, and the mean corner error gives
correctness and AUC at 1/3/5/10 px, with the metric code of the HPatches
driver.

    python -m geoformer_tpu_torch.eval.selfcheck \\
        --ckpt checkpoints/tpu_r3_main/params_final.npz [--bf16] [--pallas] \\
        [--int8 | --int8-full] [--image held-out-photos] [--device cpu]

``--pallas`` selects the hand-written GAM kernels (the JAX flag's name);
``--image held-out-photos`` reads data/holdout_photos/*.png, the
photographs kept out of the training corpus; ``--image real-photos`` the
JPEG photographs of installed packages that the JAX script globs. The
homographies come from the port's sample_homography with a CPU
torch.Generator seeded with ``--seed`` (the JAX script's jax.random draws
cannot be reproduced in torch), so the pairs are the JAX script's textures
under other warps. It prints the JAX script's JSON keys.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sysconfig
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from geoformer_tpu_torch import weights
from geoformer_tpu_torch.config import (
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
    with_int8,
)
from geoformer_tpu_torch.data.native import native_textures, native_warp
from geoformer_tpu_torch.eval.hpatches import fit_homography_np
from geoformer_tpu_torch.eval.image_io import read_gray
from geoformer_tpu_torch.eval.metrics import (
    cal_error_auc,
    corner_error,
    correctness,
)
from geoformer_tpu_torch.geometry.homography import (
    sample_homography,
    sample_homography_draws,
)
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.ops.resize import resize_linear_u8

REPO_DIR = Path(__file__).resolve().parent.parent.parent
HOLDOUT_DIR = REPO_DIR / "data" / "holdout_photos"
# scripts/selfcheck_eval.py's real-photos, under site-packages
REAL_PHOTOS = ("sklearn/datasets/images/*.jpg",
               "matplotlib/mpl-data/sample_data/grace_hopper.jpg",
               "pygame/docs/generated/_images/camera_rgb.jpg")
THRESHOLDS = (1, 3, 5, 10)
BATCH = 4


def selfcheck_config(bf16: bool = False, pallas: bool = False,
                     int8: bool = False, int8_full: bool = False
                     ) -> GeoFormerConfig:
    """The JAX script's model: 1024 matches, 256 GAM hypotheses, 1024
    inliers; ``int8`` quantizes the backbone, ``int8_full`` every stage."""
    return with_int8(GeoFormerConfig(
        match=MatchConfig(max_matches=1024),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=1024,
                            use_pallas=pallas),
        use_bf16=bf16), int8, int8_full)


def load_model(cfg: GeoFormerConfig, ckpt: str, device) -> GeoFormer:
    """A GeoFormer of ``cfg`` with the JAX ``.npz`` checkpoint's weights, in
    eval mode on ``device``."""
    model = weights.load_jax_params(GeoFormer(cfg), weights.load_npz(ckpt))
    return model.to(torch.device(device)).eval()


def photo_bases(paths: Sequence[str], n: int, hw) -> np.ndarray:
    """[n, h, w] float32 bases: the photographs read grey and resized to
    hw (aspect not kept), cycled over the n pairs."""
    ims = [resize_linear_u8(read_gray(p), hw).astype(np.float32) / 255.0
           for p in paths]
    return np.stack([ims[i % len(ims)] for i in range(n)])


def real_photos() -> List[str]:
    """The JAX script's ``--image real-photos``: the photographs that some
    installed packages ship (sklearn's sample images, matplotlib's
    grace_hopper.jpg, pygame's camera_rgb.jpg), sorted; FileNotFoundError
    where none is installed, as the JAX script asserts."""
    site = sysconfig.get_paths()["purelib"]
    paths = sorted(sum((glob.glob(os.path.join(site, g)) for g in REAL_PHOTOS),
                       []))
    if not paths:
        raise FileNotFoundError(
            f"no package photos found under {site} ({', '.join(REAL_PHOTOS)})")
    return paths


def make_pairs(n: int, hw, seed: int, image: Optional[Sequence[str]] = None):
    """(base [n, h, w], warped [n, h, w], Hs [n, 3, 3] float32) of the
    protocol: procedural textures from ``seed`` (or photographs), their
    homographies and warps, on the host."""
    if image is not None and list(image) == ["real-photos"]:
        image = real_photos()
    if image is not None and list(image) == ["held-out-photos"]:
        image = sorted(str(p) for p in HOLDOUT_DIR.glob("*.png"))
        if not image:
            raise FileNotFoundError(f"no photographs in {HOLDOUT_DIR}")
    base = (photo_bases(image, n, hw) if image
            else native_textures(n, hw[0], hw[1], seed))
    gen = torch.Generator().manual_seed(seed)
    Hs = sample_homography(sample_homography_draws(n, hw, gen), hw).numpy()
    return base, native_warp(base, Hs), Hs


def match_pairs(model: GeoFormer, base: np.ndarray, warped: np.ndarray,
                device="cuda", gam_sample_idx: Optional[np.ndarray] = None,
                gam_seed: int = 0):
    """Match every pair (base[i], warped[i]) in batches of 4, as the JAX
    script does: no padding masks, the GAM's RANSAC from a generator seeded
    with ``gam_seed`` (0, as the JAX script's key) for every batch, on
    ``device``. ``gam_sample_idx`` [n, iters, 4] replaces the GAM's
    draws. Returns the (mkpts0, mkpts1) numpy arrays of each pair and the
    host seconds of the forwards, through the copy of their results to the
    host."""
    device = torch.device(device)
    matches = []
    seconds = 0.0
    for s in range(0, len(base), BATCH):
        i0, i1 = (torch.from_numpy(np.ascontiguousarray(
            x[s:s + BATCH, :, :, None], np.float32)).to(device)
            for x in (base, warped))
        idx = None if gam_sample_idx is None else torch.tensor(
            gam_sample_idx[s:s + BATCH], dtype=torch.long, device=device)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(i0, i1, sample_idx=idx,
                        generator=torch.Generator(device).manual_seed(
                            gam_seed))
        mk0 = out.fine.mkpts0.float().cpu().numpy()
        mk1 = out.fine.mkpts1.float().cpu().numpy()
        ok = out.fine.valid.cpu().numpy()
        seconds += time.perf_counter() - t0
        matches += [(mk0[b][ok[b]], mk1[b][ok[b]]) for b in range(len(i0))]
    return matches, seconds


def fit_pairs(matches, Hs: np.ndarray, hw, ransac_thr: float = 3.0,
              device="cuda", seed: int = 0,
              fit_sample_idx: Optional[Sequence[np.ndarray]] = None):
    """Fit a homography to each pair's matches on ``device`` (a generator
    seeded with ``seed`` a fit, or ``fit_sample_idx``, one [2048, 4] array
    a pair) and measure its mean corner error against Hs (NaN where the fit
    fails). Returns the errors and the host seconds of the fits."""
    dists = []
    t0 = time.perf_counter()
    for i, (p0, p1) in enumerate(matches):
        Hp, _ = fit_homography_np(
            p0, p1, ransac_thr, seed=seed, device=device,
            sample_idx=None if fit_sample_idx is None else fit_sample_idx[i])
        dists.append(np.nan if Hp is None else corner_error(Hs[i], Hp, hw))
    return dists, time.perf_counter() - t0


def run_pairs(model: GeoFormer, base: np.ndarray, warped: np.ndarray,
              Hs: np.ndarray, ransac_thr: float = 3.0, device="cuda") -> Dict:
    """The protocol on given pairs: match_pairs, then fit_pairs with seed 0.
    Returns dists, n_matches, match_s and fit_s."""
    matches, match_s = match_pairs(model, base, warped, device)
    dists, fit_s = fit_pairs(matches, Hs, base.shape[1:], ransac_thr, device)
    return dict(dists=dists, n_matches=[len(p0) for p0, _ in matches],
                match_s=match_s, fit_s=fit_s)


def summary(res: Dict) -> Dict:
    """The JAX script's JSON record of a run_pairs result."""
    dists, n = res["dists"], len(res["dists"])
    return {
        "pairs": n,
        "mean_matches": float(np.mean(res["n_matches"])),
        "match_time_per_pair_s": res["match_s"] / n,
        "correct@1/3/5/10": correctness(dists, THRESHOLDS).round(4).tolist(),
        "auc@1/3/5/10": cal_error_auc(dists, THRESHOLDS).round(4).tolist(),
        "failed": int(np.isnan(dists).sum()),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="geoformer_tpu_torch.eval.selfcheck")
    ap.add_argument("--ckpt",
                    default="checkpoints/tpu_r3_main/params_final.npz")
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--seed", type=int, default=123456)
    ap.add_argument("--ransac-thr", type=float, default=3.0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--pallas", action="store_true",
                    help="the hand-written GAM kernels (K1, K2)")
    ap.add_argument("--int8", action="store_true",
                    help="dynamic int8 backbone convolutions (eval-only)")
    ap.add_argument("--int8-full", action="store_true",
                    help="int8 backbone AND transformer projections/MLPs")
    ap.add_argument("--image", action="append", default=None,
                    help="grey base image file(s), cycled over the pairs; "
                         "held-out-photos = data/holdout_photos/*.png; "
                         "real-photos = the JPEG photographs that sklearn, "
                         "matplotlib and pygame install (raises where none "
                         "is installed, as on a machine without them)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    hw = (args.height, args.width)
    base, warped, Hs = make_pairs(args.pairs, hw, args.seed, args.image)
    model = load_model(selfcheck_config(args.bf16, args.pallas, args.int8,
                                        args.int8_full), args.ckpt,
                       args.device)
    res = run_pairs(model, base, warped, Hs, args.ransac_thr, args.device)
    print(json.dumps(summary(res)))


if __name__ == "__main__":
    main()
