"""Self-supervised homography training loop, on one device or data-parallel.

Counterpart of run_training in geoformer_tpu/train/loop.py, with its
parameters, defaults, files and printed lines: base images from the
procedural texture bank (cpp/synthgen.cpp, rebuilt every ``bank_refresh``
batches when set) and, with ``image_dir``, from the image files there in
the share ``image_fraction``; homography pairs made on the device
(data/synthetic.py, with the camera-realism stack when ``sensor_aug``);
one train step per batch (train/trainer.py); one JSON metrics line per
logged step and per validation, printed and appended to
``<ckpt_dir>/metrics.jsonl``; a state checkpoint every ``ckpt_every``
steps and at the last one (train/checkpoint.py, ``<ckpt_dir>/<step>/``);
``params_final.npz`` at the end. ``resume`` continues from the newest
checkpoint with the data seeds moved by the step, so that the resumed run
does not replay the batches already trained on. ``tensorboard`` writes
every logged scalar to an event file under ``<ckpt_dir>/tb``
(utils/tb_events.py), and ``log_figures`` a match figure of the
validation batch at each validation (utils/plotting.py). It runs on the
card unless the caller asks for the CPU (``device="cpu"``).

In a process group of several ranks (core/mesh.py; ``cli train`` under
torchrun) it is the JAX loop over a mesh of that many devices: every rank
builds the global batch from the shared seeds and trains on its slice of
it (train/trainer.shard_train_step), so a run at world size N takes the
steps of the run at world size 1. ``batch_size`` is the global batch and
must divide by the world size. Rank 0 alone validates, on the whole
validation batch (a val step holds no collective), so the validation
scalars are those of any world size; it alone prints and writes the
metrics, checkpoints, event files, figures and ``params_final.npz``.
Every rank restores on ``resume``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional, Tuple

import torch

from geoformer_tpu_torch.config import (
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
    OptimConfig,
    TrainConfig,
)
from geoformer_tpu_torch.core import mesh
from geoformer_tpu_torch.data.synthetic import (
    base_image_stream,
    make_pair_batch,
)
from geoformer_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_params,
)
from geoformer_tpu_torch.train.optim import make_schedule
from geoformer_tpu_torch.train.trainer import (
    init_state,
    make_train_step,
    make_val_step,
    shard_train_step,
)
from geoformer_tpu_torch.utils.plotting import log_val_match_figure
from geoformer_tpu_torch.utils.tb_events import EventWriter

# the data seeds of a run resumed at step k start at seed + RESUME_STRIDE * k
RESUME_STRIDE = 1_000_003


def run_training(
    image_dir: Optional[str] = None,
    steps: int = 1000,
    batch_size: int = 8,
    image_hw: Tuple[int, int] = (480, 640),
    ckpt_dir: str = "checkpoints",
    log_every: int = 50,
    ckpt_every: int = 1000,
    seed: int = 66,
    match_capacity: int = 512,
    model_cfg: Optional[GeoFormerConfig] = None,
    lr: float = 0.0,
    warmup_steps: int = 0,
    resume: bool = False,
    val_every: int = 0,
    tensorboard: bool = False,
    texture_style: str = "mixed",
    image_fraction: float = 1.0,
    log_figures: bool = False,
    sensor_aug: bool = False,
    bank_size: int = 256,
    bank_refresh: int = 0,
    device="cuda",
):
    """Train for ``steps`` steps; returns the TrainState."""
    device = torch.device(device)
    if batch_size % mesh.world():
        raise ValueError(f"batch {batch_size} does not divide over "
                         f"{mesh.world()} ranks")
    writer = mesh.rank() == 0
    cfg = model_cfg or GeoFormerConfig(
        match=MatchConfig(max_matches=match_capacity, force_one_match=True),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=512),
    )
    optim = OptimConfig()
    if lr > 0:
        optim = dataclasses.replace(optim, true_lr=lr)
    if warmup_steps > 0:
        optim = dataclasses.replace(optim, warmup_actual=warmup_steps)
    tcfg = TrainConfig(batch_size=batch_size, image_hw=image_hw, seed=seed,
                       steps_per_epoch=max(1, steps // 15), optim=optim)
    schedule, true_lr, warmup_actual = make_schedule(
        tcfg.optim, batch_size, tcfg.steps_per_epoch, total_steps=steps)
    if writer:
        print(f"schedule: true_lr={true_lr:.3e} warmup={warmup_actual} "
              f"steps scheduler={tcfg.optim.scheduler} "
              f"steps_per_epoch={tcfg.steps_per_epoch}")
    state = init_state(cfg, tcfg, seed, device)
    if resume:
        state = restore_checkpoint(ckpt_dir, state, require=True)
        if writer:
            print(f"resumed at step {state.step}")
    step_fn = shard_train_step(make_train_step(tcfg))
    val_fn = make_val_step(tcfg) if val_every and writer else None

    data_seed = seed + RESUME_STRIDE * state.step
    stream = base_image_stream(image_hw, batch_size, data_seed,
                               image_dir=image_dir,
                               texture_style=texture_style,
                               image_fraction=image_fraction,
                               bank_size=bank_size,
                               bank_refresh=bank_refresh)
    pair_gen = torch.Generator(device).manual_seed(data_seed + 1)
    ransac_gen = torch.Generator(device).manual_seed(data_seed + 2)
    if val_fn is not None:
        # held-out validation batch from disjoint seeds
        val_stream = base_image_stream(image_hw, batch_size, seed + 9999,
                                       image_dir=image_dir,
                                       texture_style=texture_style,
                                       image_fraction=image_fraction)
        val_base = torch.from_numpy(next(val_stream)).to(device)
        val_batch = make_pair_batch(
            val_base, torch.Generator(device).manual_seed(seed + 777),
            sensor=sensor_aug)

    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    tb = (EventWriter(os.path.join(ckpt_dir, "tb"))
          if tensorboard and writer else None)
    figures = tb is not None and log_figures and val_every

    def log(mf, m: dict, step: int) -> None:
        if mf is None:
            return
        print(json.dumps(m))
        mf.write(json.dumps(m) + "\n")
        mf.flush()
        if tb is not None:
            for k, v in m.items():
                if k != "step":
                    tb.add_scalar(k, v, step)

    metrics_path = os.path.join(ckpt_dir, "metrics.jsonl")
    t0 = time.time()
    last = t0
    try:
        with (open(metrics_path, "a") if writer
              else contextlib.nullcontext()) as mf:
            for step in range(state.step, steps):
                base = torch.from_numpy(next(stream)).to(device)
                batch = make_pair_batch(base, pair_gen, sensor=sensor_aug)
                metrics = step_fn(state, batch, schedule(step),
                                  generator=ransac_gen)
                if (step + 1) % log_every == 0 or step == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    m.update(step=step + 1,
                             imgs_per_s=batch_size * log_every / (now - last)
                             if step else batch_size / (now - t0))
                    last = now
                    log(mf, m, step + 1)
                if val_fn is not None and (step + 1) % val_every == 0:
                    vm = {k: float(v) for k, v in val_fn(
                        state, val_batch,
                        generator=torch.Generator(device).manual_seed(0)
                    ).items()}
                    vm["step"] = step + 1
                    log(mf, vm, step + 1)
                    if figures:
                        with torch.no_grad():
                            out = state.model(
                                val_batch["image0"], val_batch["image1"],
                                generator=torch.Generator(device)
                                .manual_seed(0))
                        log_val_match_figure(tb, out, val_batch, step + 1)
                if writer and ((step + 1) % ckpt_every == 0
                               or step + 1 == steps):
                    save_checkpoint(ckpt_dir, state, step + 1)
    finally:
        if tb is not None:
            tb.close()

    if writer:
        save_params(os.path.join(ckpt_dir, "params_final.npz"),
                    state.model, state.step)
    return state
