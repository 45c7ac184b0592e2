"""Fine-level window matching.

Counterpart of geoformer_tpu/models/fine.py: gather the 5x5 fine-resolution
window around each matched coarse cell, fuse the coarse context
(FinePreprocess), and decode the window-to-window confidence by its global
argmax, gated by the threshold (fine_matching).

Under sequence parallelism (``seq``, core/spmd.py) the fine maps and the
coarse features are this rank's bands of rows and the matches every
rank's alike: each rank fills the windows (and coarse features) of the
matched cells whose rows it holds, reading a halo of window // 2 fine rows
across its band's edges, and one sum over the seq group completes them.
The fine map itself is never gathered; the stage after it is replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from geoformer_tpu_torch.core import mesh, spmd
from geoformer_tpu_torch.models.coarse_matching import (
    CoarseMatches,
    match_coords,
)
from geoformer_tpu_torch.models.geo_module import take_tokens
from geoformer_tpu_torch.models.layers import Dense


class FineMatches(NamedTuple):
    """Final match set in resized-image pixels: fine_conf [B, M, WW, WW],
    mkpts0/mkpts1 [B, M, 2], mconf [B, M], valid [B, M]."""

    fine_conf: torch.Tensor
    mkpts0: torch.Tensor
    mkpts1: torch.Tensor
    mconf: torch.Tensor
    valid: torch.Tensor


def gather_windows(feat_f, ids, grid_w_c: int, stride: int, window: int,
                   seq: bool = False):
    """[B, M, W*W, C] fine-feature windows at coarse cells ``ids`` [B, M]
    (F.unfold with padding W//2, indexed at the cells). feat_f: [B, hf, wf,
    C]; with ``seq`` this rank's band of rows of it, the windows every
    rank's alike."""
    b, hf, wf, c = feat_f.shape
    r = window // 2
    if seq:    # the band's rows and window // 2 of each neighbour's
        padded = F.pad(spmd.halo_rows(feat_f, r, r, dim=1), (0, 0, r, r))
    else:
        padded = F.pad(feat_f, (0, 0, r, r, r, r))  # [B, hf+2r, wf+2r, C]
    wp = wf + 2 * r
    rows = (ids // grid_w_c) * stride                    # top-left in padded
    cols = (ids % grid_w_c) * stride
    if seq:    # this band's rows of the padded map start at row0
        row0 = mesh.seq_rank() * hf
        own = (rows >= row0) & (rows < row0 + hf)
        rows = torch.where(own, rows - row0, torch.zeros_like(rows))
    d = torch.arange(window, device=ids.device)
    lin = ((rows[..., None, None] + d[:, None]) * wp
           + cols[..., None, None] + d[None, :])         # [B, M, W, W]
    flat = padded.reshape(b, -1, c)
    win = torch.gather(flat, 1, lin.reshape(b, -1, 1).expand(-1, -1, c))
    win = win.reshape(b, ids.shape[1], window * window, c)
    if not seq:
        return win
    return spmd.seq_sum(torch.where(own[..., None, None], win,
                                    torch.zeros_like(win)))


class FinePreprocess(nn.Module):
    """Window gather + coarse-context fusion (down_proj, merge_feat)."""

    def __init__(self, d_model_f: int, d_model_c: int, window: int = 5,
                 concat_coarse: bool = True, dtype=torch.float32,
                 d_feat_f: int = 0):
        """d_feat_f: channels of the fine feature map (d_model_f if 0)."""
        super().__init__()
        self.window = window
        self.concat_coarse = concat_coarse
        if concat_coarse:
            self.down_proj = Dense(d_model_c, d_model_f, bias=True,
                                   dtype=dtype)
            self.merge_feat = Dense((d_feat_f or d_model_f) + d_model_f,
                                    d_model_f, bias=True, dtype=dtype)

    def forward(self, feat_f0, feat_f1, feat_c0, feat_c1,
                matches: CoarseMatches, stride: int, grid_w0: int,
                grid_w1: int, seq: bool = False):
        w0 = gather_windows(feat_f0, matches.i_ids, grid_w0, stride,
                            self.window, seq)
        w1 = gather_windows(feat_f1, matches.j_ids, grid_w1, stride,
                            self.window, seq)
        if self.concat_coarse:
            ww = self.window * self.window
            outs = []
            for w, fc, ids in ((w0, feat_c0, matches.i_ids),
                               (w1, feat_c1, matches.j_ids)):
                cc = self.down_proj(take_tokens(fc, ids, seq))
                cat = torch.cat([w.to(cc.dtype),
                                 cc[:, :, None, :].expand(-1, -1, ww, -1)],
                                dim=-1)
                outs.append(self.merge_feat(cat))
            w0, w1 = outs
        return w0, w1


def fine_matching(fine_conf, matches: CoarseMatches, grid_w0: int,
                  grid_w1: int, coarse_scale: int, fine_scale: int,
                  window: int, thr: float) -> FineMatches:
    """Decode fine matches from the window-window confidence [B, M, WW, WW]:
    the global argmax cell, kept when it clears the threshold."""
    b, m, ww, _ = fine_conf.shape
    r = window // 2
    best, am = fine_conf.reshape(b, m, ww * ww).max(dim=-1)
    i_win = am // ww
    j_win = am % ww
    gate = best > thr
    centers0 = match_coords(matches.i_ids, grid_w0, coarse_scale)
    centers1 = match_coords(matches.j_ids, grid_w1, coarse_scale)
    off0 = torch.stack([i_win % window - r, i_win // window - r], -1)
    off1 = torch.stack([j_win % window - r, j_win // window - r], -1)
    mkpts0 = centers0 + off0.float() * fine_scale
    mkpts1 = centers1 + off1.float() * fine_scale
    valid = matches.valid & gate
    mconf = torch.where(valid, best, torch.zeros_like(best))
    return FineMatches(fine_conf, mkpts0, mkpts1, mconf, valid)
