"""Plain LoFTR: the reference pipeline without the GAM.

Counterpart of geoformer_tpu/models/loftr.py: backbone -> sine PE ->
coarse transformer -> one dense coarse matching pass -> fine window gather
-> fine transformer -> soft-argmax fine decode (the spatial expectation of
the centre token's heatmap over its window, with a per-match std). As in
the JAX model, it computes in f32, and only the backbone follows the int8
flag.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from geoformer_tpu_torch.config import GeoFormerConfig
from geoformer_tpu_torch.models.backbone import build_backbone, fine_channels
from geoformer_tpu_torch.models.coarse_matching import (
    CoarseMatches,
    coarse_match,
    match_coords,
)
from geoformer_tpu_torch.models.fine import FinePreprocess
from geoformer_tpu_torch.models.position import add_position_encoding
from geoformer_tpu_torch.models.transformer import LocalFeatureTransformer


class LoFTROutput(NamedTuple):
    conf: torch.Tensor         # [B, L0, L1] coarse confidence
    matches: CoarseMatches
    expec_f: torch.Tensor      # [B, M, 3] normalized offset + std
    mkpts0: torch.Tensor       # [B, M, 2]
    mkpts1: torch.Tensor       # [B, M, 2]
    valid: torch.Tensor        # [B, M]


def soft_argmax_match(feat_w0: torch.Tensor, feat_w1: torch.Tensor,
                      window: int):
    """Centre-against-window spatial expectation. feat_w0/1: [N, WW, C]
    window tokens. Returns (coords [N, 2] in [-1, 1] (x, y), std [N])."""
    n, ww, c = feat_w0.shape
    center = feat_w0[:, ww // 2, :]
    sim = torch.einsum("mc,mrc->mr", center, feat_w1) / math.sqrt(c)
    heat = torch.softmax(sim, dim=1)                          # [N, WW]
    ax = torch.linspace(-1.0, 1.0, window, device=feat_w0.device)
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)  # [WW, 2]
    coords = heat @ grid
    var = heat @ grid ** 2 - coords ** 2
    std = torch.sqrt(torch.clamp(var, min=1e-10)).sum(-1)
    return coords, std


class LoFTR(nn.Module):
    """Reference-shaped LoFTR (no GAM, one coarse pass, soft-argmax fine)."""

    def __init__(self, config: GeoFormerConfig = GeoFormerConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.backbone = build_backbone(cfg.backbone)
        self.loftr_coarse = LocalFeatureTransformer(
            cfg.coarse.d_model, cfg.coarse.nhead, cfg.coarse.layer_names,
            cfg.coarse.attention)
        self.fine_preprocess = FinePreprocess(
            cfg.fine.d_model, cfg.coarse.d_model, cfg.fine_match.window_size,
            cfg.fine_match.concat_coarse_feat,
            d_feat_f=fine_channels(cfg.backbone))
        self.loftr_fine = LocalFeatureTransformer(
            cfg.fine.d_model, cfg.fine.nhead, cfg.fine.layer_names,
            cfg.fine.attention)

    def forward(self, image0, image1, mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None,
                train: bool = False) -> LoFTROutput:
        """image0/1: [B, H, W, 1] in [0, 1], one shape; mask0/1 [B, H/s,
        W/s] coarse validity masks."""
        cfg = self.config
        b, H, W, _ = image0.shape
        hc, wc = H // cfg.coarse_scale, W // cfg.coarse_scale
        feats_c, feats_f = self.backbone(torch.cat([image0, image1]), train)
        f0 = add_position_encoding(feats_c[:b]).reshape(b, hc * wc, -1)
        f1 = add_position_encoding(feats_c[b:]).reshape(b, hc * wc, -1)
        m0 = mask0.reshape(b, -1) if mask0 is not None else None
        m1 = mask1.reshape(b, -1) if mask1 is not None else None
        f0, f1 = self.loftr_coarse(f0, f1, m0, m1)
        matches = coarse_match(
            f0, f1, cfg.match.thr, cfg.match.dsmax_temperature,
            cfg.match.max_matches, m0, m1,
            force_one=cfg.match.force_one_match or train, streaming=False)

        stride = cfg.coarse_scale // cfg.fine_scale
        w0, w1 = self.fine_preprocess(feats_f[:b], feats_f[b:], f0, f1,
                                      matches, stride, wc, wc)
        m = w0.shape[1]
        ww = cfg.fine_match.window_size ** 2
        t0, t1 = self.loftr_fine(w0.reshape(b * m, ww, -1),
                                 w1.reshape(b * m, ww, -1))
        coords, std = soft_argmax_match(t0, t1, cfg.fine_match.window_size)
        coords = coords.reshape(b, m, 2)
        expec_f = torch.cat([coords, std.reshape(b, m, 1)], -1)
        # mkpts1 = coarse centre + coords * (W // 2) * fine_scale
        centers0 = match_coords(matches.i_ids, wc, cfg.coarse_scale)
        centers1 = match_coords(matches.j_ids, wc, cfg.coarse_scale)
        r = cfg.fine_match.window_size // 2
        mkpts1 = centers1 + coords * r * cfg.fine_scale
        return LoFTROutput(matches.conf, matches, expec_f, centers0, mkpts1,
                           matches.valid)
