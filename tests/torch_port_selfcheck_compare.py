"""The self-check's full protocol through both packages on the CPU.

Not a test (pytest does not collect it): the comparison behind the
self-check figures of PERF.md, run by hand because it takes ~1 h on a
CPU. For each image set (procedural textures, the held-out photographs) it
builds two sets of 40 pairs at 480x640:

- the JAX script's own (scripts/selfcheck_eval.py): textures from the seed,
  or the two held-out JPEGs read with cv2, homographies from jax.random,
  warps by cpp/synthgen.cpp;
- the port's own (geoformer_tpu_torch.eval.selfcheck.make_pairs): the same
  textures, or data/holdout_photos/*.png, homographies from a torch
  generator.

and runs the trained checkpoint over them: the JAX forward in f32 and in
bf16 (the JAX CPU path: gather GAM, no Pallas), the port's in f32 on the
CPU, at one or more seeds of its GAM's RANSAC generator. Each forward's
matches are fitted at several RANSAC seeds (the JAX fit's key, the port
fit's generator seed), which gives the spread of each AUC. One JSON record
a (pairs, implementation, GAM seed) goes to ``--out``.

    JAX_PLATFORMS=cpu python tests/torch_port_selfcheck_compare.py \\
        --out outputs/selfcheck_compare.json
    JAX_PLATFORMS=cpu python tests/torch_port_selfcheck_compare.py \\
        --pairs-from port_pairs --runs port_f32 --gam-seeds 1,2 \\
        --out outputs/selfcheck_compare_gam.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from geoformer_tpu.config import (  # noqa: E402
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
)
from geoformer_tpu.data.native import native_textures, native_warp  # noqa: E402
from geoformer_tpu.eval.hpatches import fit_homography_np as j_fit  # noqa: E402
from geoformer_tpu.eval.metrics import cal_error_auc, correctness  # noqa: E402
from geoformer_tpu.geometry.homography import sample_homography  # noqa: E402
from geoformer_tpu.models import GeoFormer  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu_torch.eval import selfcheck as ps  # noqa: E402
from geoformer_tpu_torch.eval.metrics import corner_error  # noqa: E402

THRESHOLDS = (1, 3, 5, 10)


def jax_pairs(n, hw, seed, photos):
    """The JAX script's base images, homographies and warps."""
    h, w = hw
    if photos:
        import sysconfig

        import cv2

        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        from build_texture_corpus import HOLDOUT

        site = sysconfig.get_paths()["purelib"]
        ims = [cv2.resize(cv2.imread(os.path.join(site, p),
                                     cv2.IMREAD_GRAYSCALE), (w, h))
               .astype(np.float32) / 255.0 for p in HOLDOUT]
        base = np.stack([ims[i % len(ims)] for i in range(n)])
    else:
        base = native_textures(n, h, w, seed)
    keys = jax.random.split(jax.random.key(seed), n)
    Hs = np.asarray(jax.vmap(lambda k: sample_homography(k, hw))(keys))
    return base, native_warp(base, Hs), Hs


def jax_matches(variables, bf16, base, warped):
    cfg = GeoFormerConfig(
        match=MatchConfig(max_matches=1024),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=1024),
        use_bf16=bf16)
    model = GeoFormer(cfg)
    fwd = jax.jit(lambda v, i0, i1: model.apply(
        v, i0, i1, rngs={"ransac": jax.random.key(0)}))
    out = []
    for s in range(0, len(base), 4):
        r = fwd(variables, jnp.asarray(base[s:s + 4, :, :, None]),
                jnp.asarray(warped[s:s + 4, :, :, None]))
        mk0, mk1 = np.asarray(r.fine.mkpts0), np.asarray(r.fine.mkpts1)
        ok = np.asarray(r.fine.valid)
        out += [(mk0[b][ok[b]], mk1[b][ok[b]]) for b in range(len(mk0))]
    return out


def jax_dists(matches, Hs, hw, key):
    dists = []
    for (p0, p1), H in zip(matches, Hs):
        Hp, _ = j_fit(p0, p1, 3.0, seed=key)
        dists.append(np.nan if Hp is None else corner_error(H, Hp, hw))
    return dists


def record(name, matches, runs):
    aucs = np.array([cal_error_auc(d, THRESHOLDS) for d in runs])
    return {
        "run": name, "pairs": len(matches),
        "mean_matches": float(np.mean([len(p) for p, _ in matches])),
        "auc_per_seed": aucs.round(4).tolist(),
        "auc_mean": aucs.mean(0).round(4).tolist(),
        "auc_spread": (aucs.max(0) - aucs.min(0)).round(4).tolist(),
        "correct_per_seed": [correctness(d, THRESHOLDS).round(4).tolist()
                             for d in runs],
        "failed_per_seed": [int(np.isnan(d).sum()) for d in runs],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(
        ROOT, "checkpoints/tpu_r3_main/params_final.npz"))
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--seed", type=int, default=123456)
    ap.add_argument("--fit-seeds", type=int, default=3)
    ap.add_argument("--sets", default="procedural,held-out-photos")
    ap.add_argument("--pairs-from", default="jax_pairs,port_pairs")
    ap.add_argument("--runs", default="port_f32,jax_f32,jax_bf16")
    ap.add_argument("--gam-seeds", default="0",
                    help="the port's GAM generator seeds (comma list)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    hw = (args.height, args.width)
    seeds = range(args.fit_seeds)
    runs = args.runs.split(",")
    variables = load_variables(args.ckpt)
    port = ps.load_model(ps.selfcheck_config(), args.ckpt, "cpu")
    records = []

    def emit(rec):
        rec["set"] = image_set
        records.append(rec)
        print(json.dumps(rec), flush=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)

    for image_set in args.sets.split(","):
        photos = image_set == "held-out-photos"
        pairs = {
            "jax_pairs": lambda: jax_pairs(args.pairs, hw, args.seed, photos),
            "port_pairs": lambda: ps.make_pairs(
                args.pairs, hw, args.seed, [image_set] if photos else None),
        }
        pairs = {k: pairs[k]() for k in args.pairs_from.split(",")}
        for pname in args.pairs_from.split(","):
            base, warped, Hs = pairs[pname]
            for gam_seed in ([int(g) for g in args.gam_seeds.split(",")]
                             if "port_f32" in runs else []):
                t0 = time.time()
                m, _ = ps.match_pairs(port, base, warped, "cpu",
                                      gam_seed=gam_seed)
                dists = [ps.fit_pairs(m, Hs, hw, device="cpu", seed=s)[0]
                         for s in seeds]
                emit(record(f"port_f32/{pname}/gam{gam_seed}", m, dists)
                     | {"seconds": round(time.time() - t0, 1)})
            for bf16 in [b for b in (False, True)
                         if f"jax_{'bf16' if b else 'f32'}" in runs]:
                t0 = time.time()
                m = jax_matches(variables, bf16, base, warped)
                dists = [jax_dists(m, Hs, hw, s) for s in seeds]
                emit(record(f"jax_{'bf16' if bf16 else 'f32'}/{pname}", m,
                            dists) | {"seconds": round(time.time() - t0, 1)})


if __name__ == "__main__":
    main()
