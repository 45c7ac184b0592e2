"""GeoLoss: focal coarse loss (two passes) and BCE fine loss.

Counterpart of geoformer_tpu/train/loss.py (coarse_loss, fine_loss, the
dense geo_loss over [B, L, S] confidences, geo_loss_streaming, and the
plain LoFTR family's fine_loss_l2_std), with masked means instead of
boolean indexing so every shape stays fixed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from geoformer_tpu_torch.config import LossConfig
from geoformer_tpu_torch.ops.fused_loss import streaming_coarse_loss


def _masked_mean(x, mask):
    w = mask.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def coarse_loss(conf, conf_gt, cfg: LossConfig, weight=None):
    """Focal (or CE) loss on a dense dual-softmax confidence [B, L, S];
    with sparse_spvs only the positive cells are supervised."""
    conf = torch.clamp(conf, 1e-6, 1 - 1e-6)
    pos = conf_gt == 1.0
    neg = conf_gt == 0.0
    if weight is not None:
        pos = pos & (weight > 0)
        neg = neg & (weight > 0)
    if cfg.coarse_type == "cross_entropy":
        return (cfg.pos_weight * _masked_mean(-torch.log(conf), pos)
                + cfg.neg_weight * _masked_mean(-torch.log(1 - conf), neg))
    a, g = cfg.focal_alpha, cfg.focal_gamma
    lp = -a * (1 - conf) ** g * torch.log(conf)
    if cfg.sparse_spvs:
        return cfg.pos_weight * _masked_mean(lp, pos)
    ln = -a * conf ** g * torch.log(1 - conf)
    return (cfg.pos_weight * _masked_mean(lp, pos)
            + cfg.neg_weight * _masked_mean(ln, neg))


def fine_loss(fine_conf, label, valid, cfg: LossConfig):
    """Element-wise BCE on the fine window confidence [B, M, WW, WW],
    restricted to valid match slots; a half with no element adds 0."""
    conf = torch.clamp(fine_conf, 1e-6, 1 - 1e-6)
    v = valid[:, :, None, None].bool()
    pos = (label == 1.0) & v
    neg = (label == 0.0) & v
    lp = _masked_mean(-torch.log(conf), pos)
    ln = _masked_mean(-torch.log(1 - conf), neg)
    zero = torch.zeros((), dtype=lp.dtype, device=lp.device)
    return (cfg.pos_weight * torch.where(pos.any(), lp, zero)
            + cfg.neg_weight * torch.where(neg.any(), ln, zero))


def fine_loss_l2_std(expec_f, expec_f_gt, valid, correct_thr: float = 1.0):
    """The soft-argmax (plain LoFTR) fine loss: l2 on the normalized
    offsets weighted by the inverse std (normalized by its mean over the
    valid slots, no gradient through the weight), over the correct slots.
    expec_f [B, M, 3] (x, y, std); expec_f_gt [B, M, 2]; valid [B, M]."""
    valid = valid.bool()
    correct = (expec_f_gt.abs().amax(-1) < correct_thr) & valid
    inv_std = 1.0 / torch.clamp(expec_f[..., 2], min=1e-10)
    weight = (inv_std / torch.clamp(_masked_mean(inv_std, valid),
                                    min=1e-10)).detach()
    l2 = ((expec_f_gt - expec_f[..., :2]) ** 2).sum(-1)
    return _masked_mean(l2 * weight, correct)


def geo_loss(conf, dect_conf, conf_gt, fine_conf, fine_gt, fine_valid,
             cfg: LossConfig, mask0: Optional[torch.Tensor] = None,
             mask1: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss = (focal(conf) + focal(dect_conf)) * w_c + bce(fine) * w_f
    from the dense confidences [B, L, S] (second and first pass) and a
    dense GT [B, L, S]; padded cells (mask0 x mask1) are not supervised."""
    weight = None
    if mask0 is not None and mask1 is not None:
        b = conf.shape[0]
        weight = mask0.reshape(b, -1, 1) * mask1.reshape(b, 1, -1)
    lc = coarse_loss(conf, conf_gt, cfg, weight)
    ld = coarse_loss(dect_conf, conf_gt, cfg, weight)
    lf = fine_loss(fine_conf, fine_gt, fine_valid, cfg)
    total = (lc + ld) * cfg.coarse_weight + lf * cfg.fine_weight
    return total, {"loss_c": lc, "loss_d": ld, "loss_f": lf, "loss": total}


def geo_loss_streaming(feats, gt_j, gt_valid, fine_conf, fine_gt, fine_valid,
                       cfg: LossConfig, temperature: float = 0.1,
                       mask0: Optional[torch.Tensor] = None,
                       mask1: Optional[torch.Tensor] = None,
                       sp_axis: Optional[str] = None
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
                               mask0, mask1)
    ld = streaming_coarse_loss(f0, f1, gt_j, gt_valid, cfg, temperature,
                               mask0, mask1)
    lf = fine_loss(fine_conf, fine_gt, fine_valid, cfg)
    total = (lc + ld) * cfg.coarse_weight + lf * cfg.fine_weight
    return total, {"loss_c": lc, "loss_d": ld, "loss_f": lf, "loss": total}
