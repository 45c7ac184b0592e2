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

Data parallelism (the JAX package's shard_train_step: state replicated,
batch sharded, GSPMD's gradient sum). In a process group of several ranks
(core/mesh.py) each train step computes on this rank's shard of the
global batch as that batch's step would: BatchNorm takes the global
batch's statistics (models/layers.py), every loss mean divides this rank's
sum by the global count (train/loss.py), the RANSAC uniforms are drawn for
the global batch from the shared generator and sliced, and after the
backward one all-reduce sums the gradient and the scalars over the ranks
before the clip and AdamW, so every rank takes the same update.
shard_train_step wraps a step for a caller that holds the global batch.

Sequence parallelism (``seq_axis`` under core/mesh.seq_groups; the JAX
steps' ``sp_axis=cfg.seq_axis``): the ranks of a seq group take the same
pairs, each its band of rows (models/geoformer.py). The convention of the
gradient is the data-parallel one above, and it holds the count:

- each rank's loss is its share of the global loss, and the shares add up
  to it: a coarse term's sums are the rank's rows', its counts every
  rank's; the fine term, every rank's alike, divides by a count summed
  over every rank, which counts each of the seq group's copies, so it
  enters the sum once;
- every collective's backward sums the ranks' cotangents (core/spmd.py),
  so a band's gradient gathers what every rank's share took from it;
- after the backward the one all-reduce sums the gradients and the
  scalars over every rank (the data and the seq ranks alike).

The RANSAC uniforms are drawn for the global batch and sliced by data
rank, so a seq group's ranks draw alike. The validation steps return the
global values on every rank (the losses' sums and counts summed over the
seq group).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from geoformer_tpu_torch import weights
from geoformer_tpu_torch.config import GeoFormerConfig, TrainConfig
from geoformer_tpu_torch.core import mesh
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
from geoformer_tpu_torch.utils.spans import span


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
        with span("train.step"):
            model = state.model
            cfg = model.config
            wc = W // cfg.coarse_scale
            mask0, mask1 = batch.get("mask0"), batch.get("mask1")
            state.optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                out = model(batch["image0"], batch["image1"], mask0, mask1,
                            sample_idx=sample_idx, generator=generator,
                            train=True, return_feats=True,
                            ransac_noise=_global_noise(cfg, batch,
                                                       sample_idx, generator))
            with span("train.supervision"), torch.no_grad():
                gt_j, gt_valid = spvs_coarse_homography_sparse(
                    batch["H_0to1"], batch["H_1to0"], (H, W),
                    cfg.coarse_scale, mask0, mask1)
                fine_gt = spvs_fine_homography(
                    out.matches, batch["H_0to1"], wc, wc, cfg.coarse_scale,
                    cfg.fine_scale, cfg.fine_match.window_size)
            with span("train.loss"):
                loss, scalars = geo_loss_streaming(
                    out.feats, gt_j, gt_valid, out.fine.fine_conf, fine_gt,
                    out.matches.valid, tcfg.loss,
                    cfg.match.dsmax_temperature, mask0, mask1,
                    sp_axis=cfg.seq_axis, global_counts=mesh.world() > 1)
                scalars = {k: v.detach().float() for k, v in scalars.items()}
                scalars["num_inliers"] = _batch_mean(out.geo.num_inliers)
                scalars["num_matches"] = _batch_mean(
                    out.matches.valid.sum(-1))
            return _update(state, tcfg, loss, lr, scalars)

    return train_step


def _global_noise(cfg: GeoFormerConfig, batch, sample_idx, generator):
    """In a group of several ranks with no injected samples: the GAM's
    RANSAC uniforms [B, ransac_iters, capacity] drawn for the global batch
    from ``generator`` (which every rank seeds alike) as the one-process
    step draws them, and this rank's rows of them (its data rank's); else
    None (the model draws)."""
    if mesh.world() == 1 or sample_idx is not None:
        return None
    b, h, w, _ = batch["image0"].shape
    cells = (h // cfg.coarse_scale) * (w // cfg.coarse_scale)
    cap = cfg.match.max_matches
    n = cells if cap <= 0 or cap >= cells else cap
    total = b * mesh.data_world()
    u = torch.rand((total, cfg.geo.ransac_iters, n), generator=generator,
                   device=batch["image0"].device)
    return u[mesh.local_shard_slice(total)]


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of per-pair values over the global batch; in a group of
    several ranks, this rank's share of it (its sum over the global batch
    size, times the seq group's size: the group's ranks hold the same
    pairs), which _update sums over the ranks."""
    x = x.float()
    if mesh.world() == 1:
        return x.mean()
    return x.sum() / (x.shape[0] * mesh.world())


def _update(state: TrainState, tcfg: TrainConfig, loss: torch.Tensor,
            lr: float, scalars: dict) -> dict:
    """Backward, global-norm clip and AdamW at ``lr``; adds grad_norm
    (before clipping) and lr to ``scalars``. In a group of several ranks
    the gradients and the scalars (each rank's share) are summed over the
    ranks in one all-reduce first."""
    with span("train.backward"):
        loss.backward()
    with span("train.clip"):
        params = list(state.model.parameters())
        for p in params:
            # optax updates (and decays) every parameter, used or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if mesh.world() > 1:
            keys = list(scalars)
            summed = mesh.all_sum_flat(
                grads + [torch.stack([scalars[k] for k in keys])])
            for g, s in zip(grads, summed):
                g.copy_(s)
            scalars = dict(zip(keys, summed[-1].unbind()))
        norm = global_norm(grads)
        if tcfg.optim.gradient_clipping > 0:
            clip_by_global_norm_(grads, tcfg.optim.gradient_clipping, norm)
    with span("train.optimizer"):
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


def _depth_losses(out, batch, tcfg: TrainConfig, cfg: GeoFormerConfig,
                  global_counts: bool = False):
    """The streaming GeoLoss of a forward's output on a posed-RGBD batch,
    its GT from the depths and poses at original resolution (the spans
    depth.coarse_gt and depth.fine_gt inside train.supervision)."""
    H, W = tcfg.image_hw
    wc = W // cfg.coarse_scale
    mask0, mask1 = batch.get("mask0"), batch.get("mask1")
    s0, s1 = batch.get("scale0"), batch.get("scale1")
    with span("train.supervision"), torch.no_grad():
        with span("depth.coarse_gt"):
            gt_j, gt_valid = spvs_coarse_depth_sparse(
                batch["depth0"], batch["depth1"], batch["T_0to1"],
                batch["T_1to0"], batch["K0"], batch["K1"], (H, W),
                cfg.coarse_scale, mask0, mask1, s0, s1)
        with span("depth.fine_gt"):
            fine_gt = spvs_fine_depth(
                out.matches, batch["depth0"], batch["depth1"],
                batch["T_0to1"], batch["K0"], batch["K1"], wc, wc,
                cfg.coarse_scale, cfg.fine_scale,
                cfg.fine_match.window_size, scale0=s0, scale1=s1)
    with span("train.loss"):
        return geo_loss_streaming(
            out.feats, gt_j, gt_valid, out.fine.fine_conf, fine_gt,
            out.matches.valid, tcfg.loss, cfg.match.dsmax_temperature,
            mask0, mask1, sp_axis=cfg.seq_axis, global_counts=global_counts)


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
        with span("train.step"):
            model = state.model
            state.optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                out = model(batch["image0"], batch["image1"],
                            batch.get("mask0"), batch.get("mask1"),
                            sample_idx=sample_idx, generator=generator,
                            train=True, return_feats=True,
                            ransac_noise=_global_noise(
                                model.config, batch, sample_idx, generator))
            loss, scalars = _depth_losses(out, batch, tcfg, model.config,
                                          global_counts=mesh.world() > 1)
            scalars = {k: v.detach().float() for k, v in scalars.items()}
            scalars["num_matches"] = _batch_mean(out.matches.valid.sum(-1))
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


def shard_train_step(train_step):
    """Counterpart of shard_train_step for a caller that holds the global
    batch: returns step(state, batch, lr, sample_idx=None, generator=None)
    taking the global batch (and global RANSAC samples, when injected)
    and running ``train_step`` on this rank's local_shard_slice of them.
    The scalars and the update are the global batch's step's on every rank
    (see the module docstring). World size 1: ``train_step`` itself."""
    if mesh.world() == 1:
        return train_step

    def step(state, batch, lr, sample_idx=None, generator=None):
        sl = mesh.local_shard_slice(batch["image0"].shape[0])
        return train_step(state, mesh.shard_batch(batch), lr,
                          sample_idx=None if sample_idx is None
                          else sample_idx[sl], generator=generator)

    return step
