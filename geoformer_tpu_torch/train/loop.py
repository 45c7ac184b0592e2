"""Self-supervised homography training loop on one device.

Counterpart of run_training in geoformer_tpu/train/loop.py, with its
parameters and defaults: base images from the procedural texture bank
(cpp/synthgen.cpp), homography pairs made on the device (data/synthetic.py),
one train step per batch (train/trainer.py), one JSON metrics line per logged
step, printed and appended to ``<ckpt_dir>/metrics.jsonl``, and
``params_final.npz`` at the end. It runs on the card unless the caller asks
for the CPU (``device="cpu"``).

Not ported yet, and raising NotImplementedError when set: resume and orbax
state checkpoints (``ckpt_every < steps``, which would ask for one before
the end), validation (``val_every``), tensorboard and match figures, image
directories, sensor augmentation and bank refresh.
"""

from __future__ import annotations

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
from geoformer_tpu_torch.data.synthetic import (
    base_image_stream,
    make_pair_batch,
)
from geoformer_tpu_torch.train.checkpoint import save_params
from geoformer_tpu_torch.train.optim import make_schedule
from geoformer_tpu_torch.train.trainer import init_state, make_train_step


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
    waiting = {"image_dir": image_dir is not None, "resume": resume,
               "val_every": bool(val_every), "tensorboard": tensorboard,
               "log_figures": log_figures, "sensor_aug": sensor_aug,
               "bank_refresh": bool(bank_refresh),
               "ckpt_every": ckpt_every < steps}
    unported = [k for k, v in waiting.items() if v]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
    device = torch.device(device)
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
    print(f"schedule: true_lr={true_lr:.3e} warmup={warmup_actual} steps "
          f"scheduler={tcfg.optim.scheduler} "
          f"steps_per_epoch={tcfg.steps_per_epoch}")
    state = init_state(cfg, tcfg, seed, device)
    step_fn = make_train_step(tcfg)

    stream = base_image_stream(image_hw, batch_size, seed,
                               texture_style=texture_style,
                               image_fraction=image_fraction,
                               bank_size=bank_size)
    pair_gen = torch.Generator(device).manual_seed(seed + 1)
    ransac_gen = torch.Generator(device).manual_seed(seed + 2)

    os.makedirs(ckpt_dir, exist_ok=True)
    metrics_path = os.path.join(ckpt_dir, "metrics.jsonl")
    t0 = time.time()
    last = t0
    with open(metrics_path, "a") as mf:
        for step in range(state.step, steps):
            base = torch.from_numpy(next(stream)).to(device)
            batch = make_pair_batch(base, pair_gen)
            metrics = step_fn(state, batch, schedule(step),
                              generator=ransac_gen)
            if (step + 1) % log_every == 0 or step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                m.update(step=step + 1,
                         imgs_per_s=batch_size * log_every / (now - last)
                         if step else batch_size / (now - t0))
                last = now
                print(json.dumps(m))
                mf.write(json.dumps(m) + "\n")
                mf.flush()

    save_params(os.path.join(ckpt_dir, "params_final.npz"), state.model,
                state.step)
    return state
