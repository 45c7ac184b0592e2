"""GeoLoss: focal coarse loss (two passes) and BCE fine loss.

Counterpart of geoformer_tpu/train/loss.py (coarse_loss, fine_loss, the
dense geo_loss over [B, L, S] confidences, geo_loss_streaming, and the
plain LoFTR family's fine_loss_l2_std), with masked means instead of
boolean indexing so every shape stays fixed.

``global_counts`` (the data-parallel train steps, train/trainer.py): each
mean is the JAX package's over the global batch, so its denominator (the
count of the mask) is summed over the ranks without gradient while the
numerator stays this rank's. The terms of the ranks then add up to the
global loss, and so do their gradients; a mean of per-rank means would be
wrong wherever the ranks' counts differ.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from geoformer_tpu_torch.config import LossConfig
from geoformer_tpu_torch.core import mesh
from geoformer_tpu_torch.ops.fused_loss import streaming_coarse_loss


def _count(mask, dtype, global_counts: bool):
    """The number of set entries of ``mask``, over every rank when
    ``global_counts``."""
    cnt = mask.to(dtype).sum()
    return mesh.all_sum(cnt) if global_counts else cnt


def _masked_mean(x, mask, global_counts: bool = False):
    w = mask.to(x.dtype)
    return (x * w).sum() / torch.clamp(_count(mask, x.dtype, global_counts),
                                       min=1.0)


def coarse_loss(conf, conf_gt, cfg: LossConfig, weight=None,
                global_counts: bool = False):
    """Focal (or CE) loss on a dense dual-softmax confidence [B, L, S];
    with sparse_spvs only the positive cells are supervised."""
    conf = torch.clamp(conf, 1e-6, 1 - 1e-6)
    pos = conf_gt == 1.0
    neg = conf_gt == 0.0
    if weight is not None:
        pos = pos & (weight > 0)
        neg = neg & (weight > 0)
    gc = global_counts
    if cfg.coarse_type == "cross_entropy":
        return (cfg.pos_weight * _masked_mean(-torch.log(conf), pos, gc)
                + cfg.neg_weight * _masked_mean(-torch.log(1 - conf), neg,
                                                gc))
    a, g = cfg.focal_alpha, cfg.focal_gamma
    lp = -a * (1 - conf) ** g * torch.log(conf)
    if cfg.sparse_spvs:
        return cfg.pos_weight * _masked_mean(lp, pos, gc)
    ln = -a * conf ** g * torch.log(1 - conf)
    return (cfg.pos_weight * _masked_mean(lp, pos, gc)
            + cfg.neg_weight * _masked_mean(ln, neg, gc))


def fine_loss(fine_conf, label, valid, cfg: LossConfig,
              global_counts: bool = False):
    """Element-wise BCE on the fine window confidence [B, M, WW, WW],
    restricted to valid match slots; a half with no element (over every
    rank when ``global_counts``) adds 0."""
    conf = torch.clamp(fine_conf, 1e-6, 1 - 1e-6)
    v = valid[:, :, None, None].bool()
    terms = []
    for half, x in (((label == 1.0) & v, -torch.log(conf)),
                    ((label == 0.0) & v, -torch.log(1 - conf))):
        cnt = _count(half, x.dtype, global_counts)
        mean = (x * half.to(x.dtype)).sum() / torch.clamp(cnt, min=1.0)
        terms.append(torch.where(cnt > 0, mean, torch.zeros_like(mean)))
    return cfg.pos_weight * terms[0] + cfg.neg_weight * terms[1]


def fine_loss_l2_std(expec_f, expec_f_gt, valid, correct_thr: float = 1.0,
                     global_counts: bool = False):
    """The soft-argmax (plain LoFTR) fine loss: l2 on the normalized
    offsets weighted by the inverse std (normalized by its mean over the
    valid slots, of every rank when ``global_counts``; no gradient through
    the weight), over the correct slots.
    expec_f [B, M, 3] (x, y, std); expec_f_gt [B, M, 2]; valid [B, M]."""
    valid = valid.bool()
    correct = (expec_f_gt.abs().amax(-1) < correct_thr) & valid
    inv_std = 1.0 / torch.clamp(expec_f[..., 2], min=1e-10)
    norm = (inv_std * valid.to(inv_std.dtype)).sum()
    if global_counts:
        norm = mesh.all_sum(norm)
    norm = norm / torch.clamp(_count(valid, inv_std.dtype, global_counts),
                              min=1.0)
    weight = (inv_std / torch.clamp(norm, min=1e-10)).detach()
    l2 = ((expec_f_gt - expec_f[..., :2]) ** 2).sum(-1)
    return _masked_mean(l2 * weight, correct, global_counts)


def geo_loss(conf, dect_conf, conf_gt, fine_conf, fine_gt, fine_valid,
             cfg: LossConfig, mask0: Optional[torch.Tensor] = None,
             mask1: Optional[torch.Tensor] = None,
             global_counts: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss = (focal(conf) + focal(dect_conf)) * w_c + bce(fine) * w_f
    from the dense confidences [B, L, S] (second and first pass) and a
    dense GT [B, L, S]; padded cells (mask0 x mask1) are not supervised."""
    weight = None
    if mask0 is not None and mask1 is not None:
        b = conf.shape[0]
        weight = mask0.reshape(b, -1, 1) * mask1.reshape(b, 1, -1)
    lc = coarse_loss(conf, conf_gt, cfg, weight, global_counts)
    ld = coarse_loss(dect_conf, conf_gt, cfg, weight, global_counts)
    lf = fine_loss(fine_conf, fine_gt, fine_valid, cfg, global_counts)
    total = (lc + ld) * cfg.coarse_weight + lf * cfg.fine_weight
    return total, {"loss_c": lc, "loss_d": ld, "loss_f": lf, "loss": total}


def geo_loss_streaming(feats, gt_j, gt_valid, fine_conf, fine_gt, fine_valid,
                       cfg: LossConfig, temperature: float = 0.1,
                       mask0: Optional[torch.Tensor] = None,
                       mask1: Optional[torch.Tensor] = None,
                       sp_axis: Optional[str] = None,
                       global_counts: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss = (focal(g0, g1) + focal(f0, f1)) * w_c + bce(fine) * w_f
    from the coarse features (f0, f1, g0, g1) and sparse GT, never building
    a [B, L, S] matrix. sp_axis (sequence parallelism) is not ported yet."""
    if sp_axis is not None:
        raise NotImplementedError(
            "sequence-parallel training loss is not ported yet (ROADMAP "
            "queue 1 item 3, --seq-shard)")
    f0, f1, g0, g1 = feats
    lc = streaming_coarse_loss(g0, g1, gt_j, gt_valid, cfg, temperature,
                               mask0, mask1, global_counts=global_counts)
    ld = streaming_coarse_loss(f0, f1, gt_j, gt_valid, cfg, temperature,
                               mask0, mask1, global_counts=global_counts)
    lf = fine_loss(fine_conf, fine_gt, fine_valid, cfg, global_counts)
    total = (lc + ld) * cfg.coarse_weight + lf * cfg.fine_weight
    return total, {"loss_c": lc, "loss_d": ld, "loss_f": lf, "loss": total}
