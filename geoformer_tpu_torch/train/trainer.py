"""Training state, the homography and the depth-supervised train steps.

Counterpart of init_state, make_train_step, make_val_step,
make_depth_train_step, make_depth_val_step and TrainState in
geoformer_tpu/train/trainer.py. One step: the train-mode forward
(BatchNorm on batch statistics over the 2B images, updating the running
ones; the force-one-match rule), sparse coarse GT and fine labels from the
pair's homography, the streaming GeoLoss, the backward (through the GAM
kernels' backwards K3-K5 on the card), optax's global-norm clip, and AdamW
at the step's LR. The validation step: the same losses from the
inference-mode forward, and a RANSAC fit on each pair's fine matches scored
by its corner error. The depth steps take their GT from depth maps and
relative poses (train/supervision.py's depth branch) and their validation
returns the matches at original resolution with their epipolar errors.
Data parallelism (shard_train_step) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from geoformer_tpu_torch import weights
from geoformer_tpu_torch.config import GeoFormerConfig, TrainConfig
from geoformer_tpu_torch.geometry.depth import (
    essential_from_pose,
    symmetric_epipolar_distance,
)
from geoformer_tpu_torch.geometry.homography import corner_error
from geoformer_tpu_torch.geometry.ransac import ransac_homography
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.train.loss import geo_loss_streaming
from geoformer_tpu_torch.train.optim import (
    clip_by_global_norm_,
    global_norm,
    make_optimizer,
)
from geoformer_tpu_torch.train.supervision import (
    spvs_coarse_depth_sparse,
    spvs_coarse_homography_sparse,
    spvs_fine_depth,
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
        model = state.model
        cfg = model.config
        wc = W // cfg.coarse_scale
        mask0, mask1 = batch.get("mask0"), batch.get("mask1")
        state.optimizer.zero_grad(set_to_none=True)
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
        scalars = {k: v.detach().float() for k, v in scalars.items()}
        scalars["num_inliers"] = out.geo.num_inliers.float().mean()
        scalars["num_matches"] = out.matches.valid.sum(-1).float().mean()
        return _update(state, tcfg, loss, lr, scalars)

    return train_step


def _update(state: TrainState, tcfg: TrainConfig, loss: torch.Tensor,
            lr: float, scalars: dict) -> dict:
    """Backward, global-norm clip and AdamW at ``lr``; adds grad_norm
    (before clipping) and lr to ``scalars``."""
    loss.backward()
    params = list(state.model.parameters())
    for p in params:
        # optax updates (and decays) every parameter, used or not
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    if tcfg.optim.gradient_clipping > 0:
        clip_by_global_norm_(grads, tcfg.optim.gradient_clipping, norm)
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    state.optimizer.step()
    state.step += 1
    scalars["grad_norm"] = norm.detach()
    scalars["lr"] = torch.tensor(float(lr), device=norm.device)
    return scalars


def jnp_median(x: torch.Tensor) -> torch.Tensor:
    """The median as jnp.median takes it: the middle sorted value for an odd
    count, the mean of the two middle ones for an even count (so that one
    inf among them gives inf), nan if any value is nan. (torch.median
    returns the lower middle value; torch.quantile gives nan for inf.)"""
    v = torch.sort(x.reshape(-1)).values
    k = v.numel()
    mid = v[k // 2] if k % 2 else (v[k // 2 - 1] + v[k // 2]) / 2
    return torch.where(torch.isnan(v).any(), torch.full_like(mid, torch.nan),
                       mid)


def make_val_step(tcfg: TrainConfig):
    """Returns val_step(state, batch, sample_idx=None, fit_idx=None,
    generator=None) -> scalars.

    The inference-mode forward (BatchNorm on the running statistics), the
    train step's losses renamed val_* (no update), then per pair a RANSAC
    fit of the fine matches (thr 3, 256 hypotheses, 2 refinement rounds)
    scored by its corner error against H_0to1, a failed fit counting as
    inf: val_corner_err_median (jnp_median), val_fit_rate, and
    val_num_matches (fine matches per pair). The GAM's RANSAC samples are
    ``sample_idx`` [B, ransac_iters, 4] and the fit's ``fit_idx``
    [B, 256, 4] when given, else both are drawn from ``generator`` (the
    GAM's first). The scalars are 0-d f32 tensors on the device."""
    H, W = tcfg.image_hw

    @torch.no_grad()
    def val_step(state: TrainState, batch: Dict[str, torch.Tensor],
                 sample_idx: Optional[torch.Tensor] = None,
                 fit_idx: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        model = state.model
        cfg = model.config
        wc = W // cfg.coarse_scale
        mask0, mask1 = batch.get("mask0"), batch.get("mask1")
        out = model(batch["image0"], batch["image1"], mask0, mask1,
                    sample_idx=sample_idx, generator=generator, train=False,
                    return_feats=True)
        gt_j, gt_valid = spvs_coarse_homography_sparse(
            batch["H_0to1"], batch["H_1to0"], (H, W), cfg.coarse_scale,
            mask0, mask1)
        fine_gt = spvs_fine_homography(
            out.matches, batch["H_0to1"], wc, wc, cfg.coarse_scale,
            cfg.fine_scale, cfg.fine_match.window_size)
        _, scalars = geo_loss_streaming(
            out.feats, gt_j, gt_valid, out.fine.fine_conf, fine_gt,
            out.matches.valid, tcfg.loss, cfg.match.dsmax_temperature,
            mask0, mask1, sp_axis=cfg.seq_axis)
        val = {f"val_{k}": v.float() for k, v in scalars.items()}
        fit = ransac_homography(out.fine.mkpts0, out.fine.mkpts1,
                                out.fine.valid, thr=3.0, iters=256,
                                refine_iters=2, sample_idx=fit_idx,
                                generator=generator)
        errs = corner_error(fit["H"], batch["H_0to1"], (H, W))
        errs = torch.where(fit["ok"], errs, torch.full_like(errs, torch.inf))
        val["val_corner_err_median"] = jnp_median(errs)
        val["val_fit_rate"] = fit["ok"].float().mean()
        val["val_num_matches"] = out.fine.valid.sum(-1).float().mean()
        return val

    return val_step


def _depth_losses(out, batch, tcfg: TrainConfig, cfg: GeoFormerConfig):
    """The streaming GeoLoss of a forward's output on a posed-RGBD batch,
    its GT from the depths and poses at original resolution."""
    H, W = tcfg.image_hw
    wc = W // cfg.coarse_scale
    mask0, mask1 = batch.get("mask0"), batch.get("mask1")
    s0, s1 = batch.get("scale0"), batch.get("scale1")
    with torch.no_grad():
        gt_j, gt_valid = spvs_coarse_depth_sparse(
            batch["depth0"], batch["depth1"], batch["T_0to1"],
            batch["T_1to0"], batch["K0"], batch["K1"], (H, W),
            cfg.coarse_scale, mask0, mask1, s0, s1)
        fine_gt = spvs_fine_depth(
            out.matches, batch["depth0"], batch["depth1"], batch["T_0to1"],
            batch["K0"], batch["K1"], wc, wc, cfg.coarse_scale,
            cfg.fine_scale, cfg.fine_match.window_size, scale0=s0,
            scale1=s1)
    return geo_loss_streaming(
        out.feats, gt_j, gt_valid, out.fine.fine_conf, fine_gt,
        out.matches.valid, tcfg.loss, cfg.match.dsmax_temperature,
        mask0, mask1, sp_axis=cfg.seq_axis)


def make_depth_train_step(tcfg: TrainConfig):
    """Returns train_step(state, batch, lr, sample_idx=None,
    generator=None) -> scalars, the depth-supervised step.

    batch: image0/image1 [B, H, W, 1], depth0/depth1 [B, Hd, Wd],
    T_0to1/T_1to0 [B, 4, 4], K0/K1 [B, 3, 3], scale0/scale1 [B, 2] and
    mask0/mask1 [B, H/8, W/8], on the model's device. The masks go through
    the forward, the GT and the loss. The scalars are the JAX step's:
    loss, loss_c, loss_d, loss_f, num_matches, grad_norm, lr."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: float, sample_idx: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        out = model(batch["image0"], batch["image1"], batch.get("mask0"),
                    batch.get("mask1"), sample_idx=sample_idx,
                    generator=generator, train=True, return_feats=True)
        loss, scalars = _depth_losses(out, batch, tcfg, model.config)
        scalars = {k: v.detach().float() for k, v in scalars.items()}
        scalars["num_matches"] = out.matches.valid.sum(-1).float().mean()
        return _update(state, tcfg, loss, lr, scalars)

    return train_step


def make_depth_val_step(tcfg: TrainConfig):
    """Returns val_step(state, batch, sample_idx=None, generator=None) ->
    (scalars, pair_data), the depth-supervised validation step.

    The inference-mode forward, the train step's losses renamed val_* and
    val_num_matches (fine matches per pair); pair_data holds mkpts0/mkpts1
    [B, M, 2] at ORIGINAL resolution (times scale0/scale1), valid [B, M],
    mconf [B, M] and epi_errs [B, M], the squared symmetric epipolar
    distance of each match under the GT pose. Pose recovery is the
    caller's (train/depth_loop.py)."""

    @torch.no_grad()
    def val_step(state: TrainState, batch: Dict[str, torch.Tensor],
                 sample_idx: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        model = state.model
        out = model(batch["image0"], batch["image1"], batch.get("mask0"),
                    batch.get("mask1"), sample_idx=sample_idx,
                    generator=generator, train=False, return_feats=True)
        _, scalars = _depth_losses(out, batch, tcfg, model.config)
        scalars = {f"val_{k}": v.float() for k, v in scalars.items()}
        scalars["val_num_matches"] = out.fine.valid.sum(-1).float().mean()
        b = batch["image0"].shape[0]
        ones = torch.ones((b, 2), device=out.fine.mkpts0.device)
        s0 = batch.get("scale0", ones)
        s1 = batch.get("scale1", ones)
        mk0 = out.fine.mkpts0 * s0[:, None, :]
        mk1 = out.fine.mkpts1 * s1[:, None, :]
        epi = symmetric_epipolar_distance(
            mk0, mk1, essential_from_pose(batch["T_0to1"]), batch["K0"],
            batch["K1"])
        return scalars, {"mkpts0": mk0, "mkpts1": mk1,
                         "valid": out.fine.valid, "mconf": out.fine.mconf,
                         "epi_errs": epi}

    return val_step
