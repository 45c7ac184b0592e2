"""Streaming (chunked) dual-softmax coarse loss.

Counterpart of streaming_coarse_loss in geoformer_tpu/ops/fused_loss.py:
GeoLoss's coarse focal/CE terms computed from the transformer features
without the [B, L, S] confidence matrix. With sim_ij = <f0_i, f1_j> / (C T),

    conf_ij = exp(2 sim_ij - r_i - c_j),  r = row LSE, c = col LSE,

so the positive term needs the two LSE vectors (ops/streaming_match.sim_lse)
and one gathered dot product per row, and the negative term (dense
supervision) a second streamed pass over [B, chunk, S] tiles. Every chunk
runs under ``torch.utils.checkpoint``, as JAX runs it under
``jax.checkpoint``: the backward recomputes the chunk's tile, so peak memory
holds one tile, not L / chunk of them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from geoformer_tpu_torch.config import LossConfig
from geoformer_tpu_torch.core import mesh
from geoformer_tpu_torch.ops.streaming_match import (
    _NEG_INF,
    _prep,
    _tile,
    sim_lse,
)


def _focal_pos(p, alpha: float, gamma: float):
    return -alpha * (1 - p) ** gamma * torch.log(p)


def _focal_neg(p, alpha: float, gamma: float):
    return -alpha * p ** gamma * torch.log(1 - p)


def _neg_chunk(f0c, f1, rv, col_valid, inv: float, r_c, c, gj, gv,
               cfg: LossConfig):
    """Negative-term sum and count over one [B, chunk, S] tile."""
    t = _tile(f0c, f1, rv, col_valid, inv)
    p = torch.clamp(torch.exp(2.0 * t - r_c[:, :, None] - c[:, None, :]),
                    1e-6, 1 - 1e-6)
    cols = torch.arange(t.shape[2], device=t.device)
    is_gt = gv[:, :, None] & (gj[:, :, None] == cols[None, None, :])
    wmask = rv[:, :, None]
    if col_valid is not None:
        wmask = wmask & col_valid[:, None, :]
    nmask = (wmask & ~is_gt).float()
    ln = (_focal_neg(p, cfg.focal_alpha, cfg.focal_gamma)
          if cfg.coarse_type != "cross_entropy" else -torch.log(1 - p))
    return (ln * nmask).sum(), nmask.sum()


def streaming_coarse_loss(feat0, feat1, gt_j, gt_valid, cfg: LossConfig,
                          temperature: float = 0.1,
                          mask0: Optional[torch.Tensor] = None,
                          mask1: Optional[torch.Tensor] = None,
                          chunk: int = 600,
                          axis_name: Optional[str] = None,
                          global_counts: bool = False) -> torch.Tensor:
    """Coarse GeoLoss term from features and sparse GT, streamed.

    Equal in value and gradient to coarse_loss(dual_softmax(feat0, feat1, T,
    m0, m1), one_hot(gt)) with O(B chunk S) peak memory.

    Args:
        feat0/feat1: [B, L, C] / [B, S, C] coarse features.
        gt_j: [B, L] GT column per image0 cell; gt_valid: [B, L] rows that
            carry a GT match.
        axis_name: sequence parallelism, not ported yet (raises).
        global_counts: data parallelism: the positive and negative counts
            are summed over the ranks (no gradient), the sums stay this
            rank's, so the ranks' terms add up to the global batch's loss.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "sequence-parallel streaming loss is not ported yet (ROADMAP "
            "queue 1 item 3, --seq-shard)")
    b, l, cdim = feat0.shape
    s = feat1.shape[1]
    chunk = max(1, min(chunk, l))
    r, c = sim_lse(feat0, feat1, temperature, mask0, mask1, chunk)
    row_valid, col_valid, inv = _prep(feat0, mask0, mask1, temperature)
    col_ok = (torch.ones((b, s), dtype=torch.bool, device=feat0.device)
              if col_valid is None else col_valid)

    # ---- positive term: gathered dot products, no tiles needed
    gt_j = gt_j.long()
    f1_gt = torch.gather(feat1.float(), 1,
                         gt_j[..., None].expand(-1, -1, cdim))
    sim_pos = (feat0.float() * f1_gt).sum(-1) * inv
    cell_ok = row_valid & torch.gather(col_ok, 1, gt_j)
    sim_pos = torch.where(cell_ok, sim_pos, _NEG_INF)
    logp = 2.0 * sim_pos - r - torch.gather(c, 1, gt_j)
    p_pos = torch.clamp(torch.exp(logp), 1e-6, 1 - 1e-6)
    w = (gt_valid.bool() & cell_ok).float()
    lp = (-torch.log(p_pos) if cfg.coarse_type == "cross_entropy"
          else _focal_pos(p_pos, cfg.focal_alpha, cfg.focal_gamma))
    pos_cnt = mesh.all_sum(w.sum()) if global_counts else w.sum()
    pos_loss = (lp * w).sum() / torch.clamp(pos_cnt, min=1.0)
    if cfg.coarse_type == "focal" and cfg.sparse_spvs:
        return cfg.pos_weight * pos_loss

    # ---- negative term: a second streamed pass over tiles
    ln_sum = torch.zeros((), dtype=torch.float32, device=feat0.device)
    ln_cnt = torch.zeros((), dtype=torch.float32, device=feat0.device)
    gv_all = gt_valid.bool()
    for start in range(0, l, chunk):
        sl = slice(start, start + chunk)
        part, cnt = checkpoint(
            _neg_chunk, feat0[:, sl], feat1, row_valid[:, sl], col_valid,
            inv, r[:, sl], c, gt_j[:, sl], gv_all[:, sl], cfg,
            use_reentrant=False)
        ln_sum = ln_sum + part
        ln_cnt = ln_cnt + cnt
    if global_counts:
        ln_cnt = mesh.all_sum(ln_cnt)
    neg_loss = ln_sum / torch.clamp(ln_cnt, min=1.0)
    return cfg.pos_weight * pos_loss + cfg.neg_weight * neg_loss
