"""The depth gate's CPU references (not collected by pytest).

    python tests/torch_port_depth_reference.py port --corpus DIR_P \
        [--matches FILE]
    python tests/torch_port_depth_reference.py jax --corpus DIR_J [--batch 2]
    python tests/torch_port_depth_reference.py cv2 --matches FILE

``port``: the port's depth gate sweep (geoformer_tpu_torch/eval/
depth_gate.py) on the CPU, on the val corpus the port renders into
DIR_P, each val step run once and both pose backends on its matches: the
references chip_smoke.py's depth phase holds the card's numbers to
(CPU_REF for the device pose backend, CPU_REF_HOST and CPU_HOST_FAILED
for the host one). It prints one record a backend and, with
``--matches``, saves the val steps' matches, intrinsics and poses to
FILE (npz).

``jax``: the JAX package's own validation sweep of the same checkpoint
(geoformer_tpu.train.depth_loop.run_depth_validation with its jitted
make_depth_val_step and the device pose backend) on the val corpus the
JAX script renders (scripts/render_depth_corpus.build_scene: cv2's warps
and JPEG, h5py), the record's 32 pairs from the val stream with seed 67.
``--batch 2`` draws the same pairs in the same order as batches of 4 (the
stream yields consecutive pairs of one shuffled order) at half the
memory; only the GAM's RANSAC keys differ.

``cv2``: on the matches ``port --matches`` saved, the JAX package's host
validation (cv2's findEssentialMat and recoverPose) beside the port's
host and device backends: each record, and each pair's errors, inliers
and whether its inlier mask equals cv2's. Seconds on a CPU.

Each prints one JSON record a line; PERF.md keeps them. At 640x640 each
pair's forward takes seconds on a CPU and the JAX compile minutes.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def port(args):
    """The gate's sweep with each val step run once (its output kept by
    batch) and both pose backends on its matches."""
    import numpy as np
    import torch

    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.data import depth_corpus
    from geoformer_tpu_torch.eval import depth_gate as dg
    from geoformer_tpu_torch.train.depth_loop import run_depth_validation
    from geoformer_tpu_torch.train.trainer import make_depth_val_step

    device = torch.device("cpu")
    if not os.path.isdir(os.path.join(args.corpus, "index_val")):
        depth_corpus.build(args.corpus, n_scenes=0,
                           n_val_scenes=dg.N_VAL_SCENES,
                           seed=dg.CORPUS_SEED, cluttered=True)
    state = dg.load_state(device)
    vb = dg.val_batches(args.corpus, device)
    step = make_depth_val_step(TrainConfig(batch_size=dg.BATCH,
                                           image_hw=(dg.IMSIZE, dg.IMSIZE)))
    kept = {}

    def val_fn(state, batch, generator=None):
        if id(batch) not in kept:
            kept[id(batch)] = step(state, batch, generator=generator)
        return kept[id(batch)]

    recs = []
    for backend in ("device", "host"):
        t0 = time.time()
        stats = {}
        rec = run_depth_validation(val_fn, state, vb, pose_backend=backend,
                                   pose_stats=stats)
        rec.update(pose_backend=backend, pairs=dg.BATCHES * dg.BATCH,
                   validation_s=round(time.time() - t0, 1))
        if backend == "host":
            rec.update(dg.host_fields(stats), host_ms=stats["ms"],
                       ransac_iters=stats["iters"])
        recs.append(rec)
    if args.matches:
        pds = [kept[id(b)][1] for b in vb]
        np.savez_compressed(args.matches, **{
            k: np.concatenate([pd[k].numpy() for pd in pds])
            for k in ("mkpts0", "mkpts1", "valid", "epi_errs")}, **{
            k: np.concatenate([b[k].numpy() for b in vb])
            for k in ("K0", "K1", "T_0to1")})
    return recs


def cv2_on_matches(args):
    """The JAX package's host validation (cv2) and the port's two backends
    on the saved matches, in the gate's batches of 4."""
    import jax
    import numpy as np
    import torch

    from geoformer_tpu.eval.pose import pose_error_for_pair as cv2_pose
    from geoformer_tpu.train import depth_loop as jloop
    from geoformer_tpu_torch.eval.pose import pose_error_for_pair
    from geoformer_tpu_torch.geometry.essential import batched_pose_errors
    from geoformer_tpu_torch.train import depth_loop as ploop

    m = dict(np.load(args.matches))
    n = len(m["valid"])
    batches = [{k: v[i:i + 4] for k, v in m.items()} for i in range(0, n, 4)]
    for b in batches:
        b["pd"] = {k: b[k] for k in ("mkpts0", "mkpts1", "valid",
                                     "epi_errs")}
    scalars = {"val_loss": np.float32(0.0)}
    t0 = time.time()
    want = jloop.run_depth_validation(
        lambda state, batch, key: (scalars, batch["pd"]), None, batches,
        jax.random.key(0), pose_backend="host")
    cv2_s = time.time() - t0
    tb = [{"image0": torch.zeros(1), **{k: torch.from_numpy(v)
                                        for k, v in b.items() if k != "pd"}}
          for b in batches]
    port_val = (lambda state, batch, generator=None: (
        {"val_loss": torch.tensor(0.0)},
        {k: batch[k] for k in ("mkpts0", "mkpts1", "valid", "epi_errs")}))
    recs = [dict(want, backend="cv2 (JAX package, host)",
                 validation_s=round(cv2_s, 1))]
    for backend in ("host", "device"):
        t0 = time.time()
        rec = ploop.run_depth_validation(port_val, None, tb,
                                         pose_backend=backend)
        recs.append(dict(rec, backend=f"port {backend}",
                         validation_s=round(time.time() - t0, 1)))
    pairs = []
    for b, t in zip(batches, tb):
        t_dev, R_dev, _, _ = batched_pose_errors(
            t["mkpts0"], t["mkpts1"], t["valid"], t["K0"], t["K1"],
            t["T_0to1"], thresh=0.5,
            generator=torch.Generator().manual_seed(0))
        for i in range(len(b["valid"])):
            v = b["valid"][i]
            args_i = (b["mkpts0"][i][v], b["mkpts1"][i][v], b["K0"][i],
                      b["K1"][i], b["T_0to1"][i])
            ct, cR, cin = cv2_pose(*args_i, thresh=0.5)
            pt, pR, pin = pose_error_for_pair(*args_i, thresh=0.5)
            pairs.append({
                "matches": int(v.sum()),
                "cv2": [float(ct), float(cR), int(np.sum(cin))],
                "host": [float(pt), float(pR), int(np.sum(pin))],
                "device": [float(t_dev[i]), float(R_dev[i])],
                "mask_equal": bool(np.array_equal(cin, pin))})
    gap = max(max(abs(p["cv2"][0] - p["host"][0]),
                  abs(p["cv2"][1] - p["host"][1])) for p in pairs)
    err = {b: np.array([max(p[b][:2]) for p in pairs])
           for b in ("cv2", "host", "device")}
    both = (err["host"] < 5) & (err["device"] < 5)
    recs.append({
        "pairs": pairs,
        "masks_equal": sum(p["mask_equal"] for p in pairs),
        "max_err_gap_deg": gap,
        # max(R, t) error by backend: the pairs under 5 degrees in both
        # backends, and the pairs over 5 and over 20 degrees in each
        "pairs_under_5_in_both": int(both.sum()),
        "median_err_deg_under_5_in_both": {
            b: float(np.median(e[both])) for b, e in err.items()},
        "mean_err_deg_under_5_in_both": {
            b: float(np.mean(e[both])) for b, e in err.items()},
        "pairs_over_5_deg": {b: int((e > 5).sum()) for b, e in err.items()},
        "pairs_over_20_deg": {b: int((e > 20).sum())
                              for b, e in err.items()},
        "inlier_share": float(np.mean([p["host"][2] / p["matches"]
                                       for p in pairs]))})
    return recs


def jax_sweep(args):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "scripts"))
    from render_depth_corpus import build_scene

    from geoformer_tpu.config import (
        GeoFormerConfig,
        GeoModuleConfig,
        MatchConfig,
        TrainConfig,
    )
    from geoformer_tpu.data.megadepth import scene_balanced_stream
    from geoformer_tpu.models import GeoFormer
    from geoformer_tpu.train.checkpoint import load_variables
    from geoformer_tpu.train.depth_loop import run_depth_validation
    from geoformer_tpu.train.trainer import TrainState, make_depth_val_step

    corpus = args.corpus
    t0 = time.time()
    if not os.path.isdir(os.path.join(corpus, "index_val")):
        for k in range(6):
            build_scene(corpus, os.path.join(corpus, "index_val"),
                        f"val{k:04d}", 20260820 + 777_000 + 31 * k,
                        cluttered=True)
    render_s = time.time() - t0
    cfg = GeoFormerConfig(
        match=MatchConfig(max_matches=512, force_one_match=True),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=512,
                            use_pallas=True))
    v = load_variables(str(ROOT / "checkpoints" / "tpu_r5_depth2"
                           / "params_final.npz"))
    state = TrainState(v["params"], v["batch_stats"], None,
                       jnp.zeros((), jnp.int32))
    tcfg = TrainConfig(batch_size=args.batch, image_hw=(640, 640))
    val_fn = jax.jit(make_depth_val_step(GeoFormer(cfg), tcfg))
    stream = scene_balanced_stream(
        os.path.join(corpus, "index_val"), corpus, args.batch, 67,
        min_overlap_score=0.4, img_resize=640, depth_pad=640)
    n = 32 // args.batch
    batches = [{k: jnp.asarray(x) for k, x in next(stream).items()}
               for _ in range(n)]
    t0 = time.time()
    rec = run_depth_validation(val_fn, state, batches, jax.random.key(0))
    rec.update(pairs=32, batch=args.batch, render_s=round(render_s, 1),
               validation_s=round(time.time() - t0, 1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=("port", "jax", "cv2"))
    ap.add_argument("--corpus")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--matches", default=None,
                    help="npz of the port sweep's matches (written by "
                         "port, read by cv2)")
    args = ap.parse_args()
    if args.which == "cv2":
        recs = cv2_on_matches(args)
    elif args.which == "jax":
        recs = [jax_sweep(args)]
    else:
        recs = port(args)
    for rec in recs:
        print(json.dumps({"reference": args.which, **rec}, default=float))


if __name__ == "__main__":
    main()
