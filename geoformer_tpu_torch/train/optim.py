"""Optimizer and LR schedule.

Counterpart of geoformer_tpu/train/optim.py and of the update in
geoformer_tpu/train/trainer.py: the JAX package runs
``optax.chain(clip_by_global_norm(c), adamw(1.0, weight_decay=wd))`` at unit
LR and scales the updates by the step's LR. ``torch.optim.AdamW`` with the
step's LR in its parameter groups gives the same update (decay applied to
every parameter, eps 1e-8 outside the square root); the clip is written out
as optax's ``g * c / max(norm, c)``, because
``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

from geoformer_tpu_torch.config import OptimConfig


def make_schedule(cfg: OptimConfig, batch_size: int, steps_per_epoch: int,
                  total_steps: int = 0):
    """Returns (schedule_fn, true_lr, warmup_steps_actual).

    The canonical LR is scaled by batch_size / canonical_bs and the warm-up
    divided by the same factor; with ``total_steps`` and no explicit
    warmup_actual the warm-up is clamped to max(100, total_steps // 12), so
    short runs reach true_lr."""
    scaling = batch_size / cfg.canonical_bs
    true_lr = cfg.true_lr if cfg.true_lr > 0 else cfg.canonical_lr * scaling
    if cfg.warmup_actual > 0:
        warmup = int(cfg.warmup_actual)
    else:
        warmup = max(1, int(cfg.warmup_steps / max(scaling, 1e-8)))
        if total_steps > 0:
            warmup = min(warmup, max(100, total_steps // 12))

    def schedule(step):
        step = float(step)
        warm = cfg.warmup_ratio * true_lr + (
            step / warmup) * (1.0 - cfg.warmup_ratio) * true_lr
        base = min(warm, true_lr)
        if cfg.scheduler == "multistep":
            epoch = step // steps_per_epoch
            k = sum(1 for m in cfg.mslr_milestones if epoch >= m)
            decay = cfg.mslr_gamma ** k
        elif cfg.scheduler == "cosine":
            epoch = step / steps_per_epoch
            decay = 0.5 * (1 + math.cos(math.pi * epoch / cfg.cosa_tmax))
        elif cfg.scheduler == "exponential":
            decay = cfg.elr_gamma ** step
        else:
            raise ValueError(cfg.scheduler)
        return base * decay

    return schedule, true_lr, warmup


def make_optimizer(cfg: OptimConfig,
                   params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """AdamW (or Adam) over ``params``; the LR is set on every step."""
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.adamw_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(cfg.optimizer)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm_(grads, max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g * max / norm when norm
    exceeds max_norm, else g unchanged."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
