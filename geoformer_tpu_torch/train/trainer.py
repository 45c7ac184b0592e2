"""Training state and the self-supervised homography train step.

Counterpart of init_state, make_train_step and TrainState in
geoformer_tpu/train/trainer.py. One step: the train-mode forward (BatchNorm
on batch statistics over the 2B images, updating the running ones; the
force-one-match rule), sparse coarse GT and fine labels from the pair's
homography, the streaming GeoLoss, the backward (through the GAM kernels'
backwards K3-K5 on the card), optax's global-norm clip, and AdamW at the
step's LR. The validation step, the depth steps and data parallelism
(shard_train_step) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from geoformer_tpu_torch import weights
from geoformer_tpu_torch.config import GeoFormerConfig, TrainConfig
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.train.loss import geo_loss_streaming
from geoformer_tpu_torch.train.optim import (
    clip_by_global_norm_,
    global_norm,
    make_optimizer,
)
from geoformer_tpu_torch.train.supervision import (
    spvs_coarse_homography_sparse,
    spvs_fine_homography,
)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, and
    the number of steps taken; a train step updates all three in place."""

    model: GeoFormer
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_state(model_cfg: GeoFormerConfig, tcfg: TrainConfig,
               seed: int = 0, device="cuda") -> TrainState:
    """A GeoFormer with random weights from ``seed`` on ``device`` and its
    optimizer at step 0."""
    model = weights.random_init(GeoFormer(model_cfg), seed).to(device)
    return TrainState(model, make_optimizer(tcfg.optim, model.parameters()))


def make_train_step(tcfg: TrainConfig):
    """Returns train_step(state, batch, lr, sample_idx=None,
    generator=None) -> scalars.

    batch: image0/image1 [B, H, W, 1], H_0to1/H_1to0 [B, 3, 3] and optional
    mask0/mask1 [B, H/8, W/8], on the model's device. RANSAC samples are
    ``sample_idx`` [B, ransac_iters, 4] when given, else drawn from
    ``generator``. The scalars are the JAX step's: loss, loss_c, loss_d,
    loss_f, num_inliers, num_matches, grad_norm (before clipping), lr, as
    0-d f32 tensors on the device."""
    H, W = tcfg.image_hw

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: float, sample_idx: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        model, opt = state.model, state.optimizer
        cfg = model.config
        wc = W // cfg.coarse_scale
        mask0, mask1 = batch.get("mask0"), batch.get("mask1")
        opt.zero_grad(set_to_none=True)
        out = model(batch["image0"], batch["image1"], mask0, mask1,
                    sample_idx=sample_idx, generator=generator, train=True,
                    return_feats=True)
        with torch.no_grad():
            gt_j, gt_valid = spvs_coarse_homography_sparse(
                batch["H_0to1"], batch["H_1to0"], (H, W), cfg.coarse_scale,
                mask0, mask1)
            fine_gt = spvs_fine_homography(
                out.matches, batch["H_0to1"], wc, wc, cfg.coarse_scale,
                cfg.fine_scale, cfg.fine_match.window_size)
        loss, scalars = geo_loss_streaming(
            out.feats, gt_j, gt_valid, out.fine.fine_conf, fine_gt,
            out.matches.valid, tcfg.loss, cfg.match.dsmax_temperature,
            mask0, mask1, sp_axis=cfg.seq_axis)
        loss.backward()
        params = list(model.parameters())
        for p in params:
            # optax updates (and decays) every parameter, used or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if tcfg.optim.gradient_clipping > 0:
            clip_by_global_norm_(grads, tcfg.optim.gradient_clipping, norm)
        for group in opt.param_groups:
            group["lr"] = float(lr)
        opt.step()
        state.step += 1
        scalars = {k: v.detach().float() for k, v in scalars.items()}
        scalars["num_inliers"] = out.geo.num_inliers.float().mean()
        scalars["num_matches"] = out.matches.valid.sum(-1).float().mean()
        scalars["grad_norm"] = norm.detach()
        scalars["lr"] = torch.tensor(float(lr), device=norm.device)
        return scalars

    return train_step
