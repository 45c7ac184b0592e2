"""Depth-supervised (MegaDepth/ScanNet) training loop with pose-AUC
validation, on one device or data-parallel.

Counterpart of geoformer_tpu/train/depth_loop.py, with its parameters,
defaults, files and printed lines: scene-balanced batches from npz index
files (data/megadepth.py), the depth train step (train/trainer.py), and a
validation that recovers each pair's relative pose from its matches by
the on-device essential RANSAC (geometry/essential.py) or, when the
caller names the host backend, the reference's per-pair 5-point RANSAC
on the host (eval/pose.py), aggregates the pose AUC at 5/10/20 degrees
and the epipolar precision over the pairs of every process
(core/dist.py), and keeps the best five checkpoints by
auc@10 in ``<ckpt_dir>/best`` beside the three newest in ``ckpt_dir``. It
runs on the card unless the caller asks for the CPU (``device="cpu"``).

In a process group of several ranks (core/mesh.py; ``cli train-depth``
under torchrun), as the JAX loop over processes: each rank reads its
share of the scenes (``shard=(rank, world)``) and trains on
``batch_size // world`` pairs a step of the data-parallel step
(train/trainer.py); its validation pairs are numbered from
``rank * 10**9``, gathered from every rank and deduplicated by number
before the AUC, and the val scalars are averaged over the ranks. Rank 0
alone prints and writes the metrics and checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from geoformer_tpu_torch.config import (
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
    OptimConfig,
    TrainConfig,
)
from geoformer_tpu_torch.core import mesh
from geoformer_tpu_torch.core.dist import all_gather_metrics, host_mean
from geoformer_tpu_torch.data.megadepth import scene_balanced_stream
from geoformer_tpu_torch.eval.pose import error_auc, pose_error_for_pair
from geoformer_tpu_torch.geometry.essential import batched_pose_errors
from geoformer_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_monitored,
    save_params,
)
from geoformer_tpu_torch.train.optim import make_schedule
from geoformer_tpu_torch.train.trainer import (
    init_state,
    make_depth_train_step,
    make_depth_val_step,
)


def to_device(batch: dict, device) -> dict:
    """A numpy batch of the stream as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def run_depth_validation(val_fn, state, val_batches,
                         epi_err_thr: float = 5e-4,
                         pose_thresh: float = 0.5,
                         pose_backend: str = "device",
                         pose_stats: Optional[dict] = None) -> dict:
    """One validation sweep: the val step on each batch (the GAM's RANSAC
    drawn from a generator seeded 0, as the JAX loop passes key(0)), the
    pose of every pair, pairs gathered over processes and deduplicated by
    id, the AUC of max(R, t) angular error at 5/10/20 degrees, the mean
    per-pair precision of epipolar errors below epi_err_thr, and the val
    scalars' means (over the batches, then the ranks). This rank's pairs
    are numbered from rank * 10**9.

    pose_backend: "device" runs the batched essential RANSAC on the
    batch's device (draws seeded 0 a batch); "host" copies the matches to
    the host and runs the reference-faithful per-pair estimator
    (eval/pose.pose_error_for_pair: the 5-point RANSAC and recoverPose of
    geometry/five_point.py) at ``pose_thresh`` px. With the host backend,
    ``pose_stats`` (a dict, when given) gets each pair's ms in
    pose_error_for_pair ("ms"), the RANSAC iterations of each pair with
    at least 5 matches ("iters") and the count of pairs without a pose
    ("failed"), this rank's pairs only."""
    R_errs, t_errs, precs, identifiers, val_scalars = [], [], [], [], []
    pair_id = mesh.rank() * 10 ** 9
    for batch in val_batches:
        dev = batch["image0"].device
        scalars, pd = val_fn(state, batch,
                             generator=torch.Generator(dev).manual_seed(0))
        val_scalars.append({k: float(v) for k, v in scalars.items()})
        valid = pd["valid"].cpu().numpy()
        epi = pd["epi_errs"].cpu().numpy()
        if pose_backend == "device":
            t_e, R_e, _, _ = batched_pose_errors(
                pd["mkpts0"], pd["mkpts1"], pd["valid"], batch["K0"],
                batch["K1"], batch["T_0to1"], thresh=pose_thresh,
                generator=torch.Generator(dev).manual_seed(0))
            R_errs.extend(R_e.cpu().tolist())
            t_errs.extend(t_e.cpu().tolist())
        else:
            mk0, mk1, K0, K1, T = (x.cpu().numpy() for x in (
                pd["mkpts0"], pd["mkpts1"], batch["K0"], batch["K1"],
                batch["T_0to1"]))
            stats = {} if pose_stats is None else pose_stats
            for key, empty in (("ms", []), ("iters", []), ("failed", 0)):
                stats.setdefault(key, empty)
            for i in range(len(valid)):
                v = valid[i]
                t0 = time.perf_counter()
                t_err, R_err, _ = pose_error_for_pair(
                    mk0[i][v], mk1[i][v], K0[i], K1[i], T[i],
                    thresh=pose_thresh, iters=stats["iters"])
                stats["ms"].append((time.perf_counter() - t0) * 1e3)
                stats["failed"] += not np.isfinite(t_err)
                R_errs.append(R_err)
                t_errs.append(t_err)
        for i in range(len(valid)):
            e = epi[i][valid[i]]
            precs.append(float(np.mean(e < epi_err_thr)) if len(e) else 0.0)
            identifiers.append(pair_id)
            pair_id += 1

    gathered = all_gather_metrics({
        "R_errs": np.asarray(R_errs, np.float32),
        "t_errs": np.asarray(t_errs, np.float32),
        "prec": np.asarray(precs, np.float32),
        "identifiers": np.asarray(identifiers, np.int64),
    })
    _, keep = np.unique(gathered["identifiers"], return_index=True)
    pose_errs = np.maximum(gathered["R_errs"][keep], gathered["t_errs"][keep])
    agg = error_auc(pose_errs, (5, 10, 20))
    agg[f"prec@{epi_err_thr:.0e}"] = (
        float(np.mean(gathered["prec"][keep])) if len(keep) else 0.0)
    for k in val_scalars[0]:
        agg[k] = host_mean(np.mean([s[k] for s in val_scalars]))
    return agg


def run_depth_training(
    npz_dir: str,
    root_dir: str,
    val_npz_dir: Optional[str] = None,
    steps: int = 1000,
    batch_size: int = 2,
    image_hw: Tuple[int, int] = (640, 640),
    ckpt_dir: str = "checkpoints_depth",
    log_every: int = 50,
    ckpt_every: int = 1000,
    val_every: int = 500,
    n_val_batches: int = 8,
    seed: int = 66,
    match_capacity: int = 512,
    model_cfg: Optional[GeoFormerConfig] = None,
    lr: float = 0.0,
    resume: bool = False,
    min_overlap_score: float = 0.4,
    depth_pad: int = 2000,
    device="cuda",
):
    """Train for ``steps`` steps (CLI: train-depth); returns (state, the
    validation record of the best auc@10)."""
    device = torch.device(device)
    if batch_size % mesh.world():
        raise ValueError(f"batch {batch_size} does not divide over "
                         f"{mesh.world()} ranks")
    local_batch = batch_size // mesh.world()
    writer = mesh.rank() == 0
    cfg = model_cfg or GeoFormerConfig(
        match=MatchConfig(max_matches=match_capacity, force_one_match=True),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=512),
    )
    optim = OptimConfig()
    if lr > 0:
        optim = dataclasses.replace(optim, true_lr=lr)
    tcfg = TrainConfig(batch_size=batch_size, image_hw=image_hw, seed=seed,
                       steps_per_epoch=max(1, steps // 15), optim=optim)
    schedule, true_lr, warmup_actual = make_schedule(
        tcfg.optim, batch_size, tcfg.steps_per_epoch, total_steps=steps)
    if writer:
        print(f"schedule: true_lr={true_lr:.3e} warmup={warmup_actual} "
              "steps")
    state = init_state(cfg, tcfg, seed, device)
    if resume:
        state = restore_checkpoint(ckpt_dir, state, require=True)
        if writer:
            print(f"resumed at step {state.step}")
    step_fn = make_depth_train_step(tcfg)
    val_fn = make_depth_val_step(tcfg)

    scene_kw = dict(min_overlap_score=min_overlap_score,
                    img_resize=image_hw[0], depth_pad=depth_pad,
                    shard=(mesh.rank(), mesh.world()))
    stream = scene_balanced_stream(npz_dir, root_dir, local_batch, seed,
                                   **scene_kw)
    val_batches = []
    if val_npz_dir:
        val_stream = scene_balanced_stream(
            val_npz_dir, root_dir, local_batch, seed + 1, **scene_kw)
        val_batches = [to_device(next(val_stream), device)
                       for _ in range(n_val_batches)]

    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    metrics_path = os.path.join(ckpt_dir, "metrics.jsonl")
    ransac_gen = torch.Generator(device).manual_seed(seed + 2)
    t0 = time.time()
    last = t0
    best = {"auc@10": -1.0}
    with (open(metrics_path, "a") if writer
          else contextlib.nullcontext()) as mf:

        def log(m):
            if mf is None:
                return
            print(json.dumps(m))
            mf.write(json.dumps(m) + "\n")
            mf.flush()

        for step in range(state.step, steps):
            batch = to_device(next(stream), device)
            metrics = step_fn(state, batch, schedule(step),
                              generator=ransac_gen)
            if (step + 1) % log_every == 0 or step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                m.update(step=step + 1,
                         imgs_per_s=batch_size * log_every / (now - last)
                         if step else batch_size / (now - t0))
                last = now
                log(m)
            run_val = val_batches and (
                (step + 1) % val_every == 0 or step + 1 == steps)
            # Two retention policies, two directories: the top-k by auc@10
            # in ckpt_dir/best drops a step as soon as five better ones
            # exist, so resume reads the rolling newest three in ckpt_dir.
            if run_val:
                agg = run_depth_validation(val_fn, state, val_batches)
                agg["step"] = step + 1
                log(agg)
                if writer:
                    save_checkpoint(ckpt_dir, state, step + 1, keep=3)
                    save_checkpoint_monitored(
                        os.path.join(ckpt_dir, "best"), state, step + 1,
                        agg, monitor="auc@10")
                if agg["auc@10"] > best["auc@10"]:
                    best = agg
            elif writer and ((step + 1) % ckpt_every == 0
                             or step + 1 == steps):
                save_checkpoint(ckpt_dir, state, step + 1, keep=3)

    if writer:
        save_params(os.path.join(ckpt_dir, "params_final.npz"),
                    state.model, state.step)
    return state, best
