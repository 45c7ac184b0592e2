"""Coarse dual-softmax matching with fixed-capacity match extraction.

Counterpart of geoformer_tpu/models/coarse_matching.py, streaming branch:
the [B, L0, L1] confidence matrix is never built (ops/streaming_match.py),
and mutuality is checked on argmax indices. Every image0 cell keeps a slot;
a top-k pass then compacts the slots to the configured capacity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoformer_tpu_torch.core.capacity import topk_select
from geoformer_tpu_torch.ops.streaming_match import streaming_match_extract


class CoarseMatches(NamedTuple):
    """Fixed-shape coarse match set: i_ids/j_ids [B, M] cell indices into
    the image0/image1 grids, valid [B, M], mconf [B, M]. ``conf`` is the
    [B, 0, 0] placeholder of the streamed path."""

    conf: torch.Tensor
    i_ids: torch.Tensor
    j_ids: torch.Tensor
    valid: torch.Tensor
    mconf: torch.Tensor


def _finalize_ids(row_best, j_ids, mutual, conf00, l1: int, thr: float,
                  capacity: int, force_one: bool, mask0, mask1):
    """Thresholding, padding-mask gating, the force-one rule and top-k
    compaction (shared tail of match extraction)."""
    b, l0 = row_best.shape
    valid = (row_best > thr) & mutual
    if mask0 is not None:
        valid = valid & (mask0.reshape(b, l0) > 0)
    if mask1 is not None:
        valid = valid & (torch.gather(mask1.reshape(b, l1), 1, j_ids) > 0)
    zero = torch.zeros((), dtype=row_best.dtype, device=row_best.device)
    mconf = torch.where(valid, row_best, zero)
    if force_one:
        none = ~valid.any(dim=1)
        first = torch.arange(l0, device=row_best.device) == 0
        forced = none[:, None] & first[None, :]
        valid = valid | forced
        j_ids = torch.where(forced, torch.zeros_like(j_ids), j_ids)
        mconf = torch.where(valid, torch.where(forced, conf00[:, None],
                                               row_best), zero)
    if capacity <= 0 or capacity >= l0:
        i_ids = torch.arange(l0, device=row_best.device).expand(b, l0)
        return i_ids, j_ids, valid, mconf
    idx, ok = topk_select(mconf, valid, capacity)
    return (idx, torch.gather(j_ids, 1, idx), ok,
            torch.gather(mconf, 1, idx) * ok)


def coarse_match(feat_c0, feat_c1, thr: float, temperature: float = 0.1,
                 capacity: int = -1, mask0: Optional[torch.Tensor] = None,
                 mask1: Optional[torch.Tensor] = None,
                 force_one: bool = False,
                 streaming: bool = True) -> CoarseMatches:
    """Dual-softmax coarse matching and fixed-capacity extraction, streamed.
    The dense path (streaming=False, the loss's conf matrix) waits for the
    training slice."""
    if not streaming:
        raise NotImplementedError(
            "dense coarse matching (return_conf) is not ported yet")
    b, l0, _ = feat_c0.shape
    row_best, j_ids, col_arg, conf00 = streaming_match_extract(
        feat_c0, feat_c1, temperature, mask0, mask1)
    mutual = torch.gather(col_arg, 1, j_ids) == \
        torch.arange(l0, device=feat_c0.device)[None, :]
    ids = _finalize_ids(row_best, j_ids, mutual, conf00, feat_c1.shape[1],
                        thr, capacity, force_one, mask0, mask1)
    empty = torch.zeros((b, 0, 0), dtype=feat_c0.dtype,
                        device=feat_c0.device)
    return CoarseMatches(empty, *ids)


def match_coords(ids: torch.Tensor, grid_w: int, scale: int) -> torch.Tensor:
    """Cell indices -> pixel coords (x, y) = (i % w, i // w) * scale, f32."""
    x = (ids % grid_w) * scale
    y = (ids // grid_w) * scale
    return torch.stack([x, y], dim=-1).float()
