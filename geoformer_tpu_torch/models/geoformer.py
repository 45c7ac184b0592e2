"""Full GeoFormer model, inference and training forward.

Counterpart of geoformer_tpu/models/geoformer.py:

    backbone -> sine PE -> coarse LoFTR -> coarse match (pass 1)
    -> GAM (RANSAC + geometry-restricted attention, kernels K1 and K2)
    -> coarse match (pass 2) -> fine window gather -> fine LoFTR
    -> fine dual-softmax decode

Both images share one static shape. The forward runs with the streamed
dual-softmax matcher and is differentiable (the caller of inference wraps
it in ``torch.no_grad``); the dense confidence output, the sinkhorn
matcher, sequence parallelism and the int8 paths raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from geoformer_tpu_torch.config import GeoFormerConfig
from geoformer_tpu_torch.models.backbone import build_backbone
from geoformer_tpu_torch.models.coarse_matching import (
    CoarseMatches,
    coarse_match,
)
from geoformer_tpu_torch.models.fine import (
    FineMatches,
    FinePreprocess,
    fine_matching,
)
from geoformer_tpu_torch.models.geo_module import GeoModule, GeoState
from geoformer_tpu_torch.models.position import add_position_encoding
from geoformer_tpu_torch.models.transformer import LocalFeatureTransformer
from geoformer_tpu_torch.ops.matching import dual_softmax


class MatchOutput(NamedTuple):
    matches: CoarseMatches      # second-pass coarse matches
    fine: FineMatches           # final matches + fine confidence
    geo: GeoState               # RANSAC state (H, inlier stats)
    matches1: CoarseMatches     # first-pass coarse matches (RANSAC input)
    # (f0, f1, g0, g1): coarse features before/after the GAM, for the
    # streaming loss; empty unless return_feats=True.
    feats: Tuple[torch.Tensor, ...] = ()


class GeoFormer(nn.Module):
    def __init__(self, config: GeoFormerConfig = GeoFormerConfig()):
        super().__init__()
        cfg = config
        if cfg.match.match_type != "dual_softmax":
            raise NotImplementedError(
                f"match_type {cfg.match.match_type!r} is not ported yet")
        if cfg.seq_axis is not None:
            raise NotImplementedError("sequence parallelism is not ported yet")
        if cfg.coarse.int8 or cfg.fine.int8:
            raise NotImplementedError("int8 transformers are not ported yet")
        if tuple(cfg.backbone.resolution) != (cfg.coarse_scale,
                                              cfg.fine_scale):
            raise ValueError((cfg.backbone.resolution, cfg.coarse_scale,
                              cfg.fine_scale))
        self.config = cfg
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        self.backbone = build_backbone(cfg.backbone, dtype=dtype)
        self.loftr_coarse = LocalFeatureTransformer(
            cfg.coarse.d_model, cfg.coarse.nhead, cfg.coarse.layer_names,
            cfg.coarse.attention, dtype=dtype)
        self.geo_module = GeoModule(cfg.geo, cfg.coarse.d_model, dtype=dtype)
        self.fine_preprocess = FinePreprocess(
            cfg.fine.d_model, cfg.coarse.d_model, cfg.fine_match.window_size,
            cfg.fine_match.concat_coarse_feat, dtype=dtype,
            d_feat_f=cfg.backbone.block_dims[0])
        self.loftr_fine = LocalFeatureTransformer(
            cfg.fine.d_model, cfg.fine.nhead, cfg.fine.layer_names,
            cfg.fine.attention, dtype=dtype)

    def forward(self, image0, image1, mask0=None, mask1=None,
                sample_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False,
                return_feats: bool = False,
                ransac_noise: Optional[torch.Tensor] = None) -> MatchOutput:
        """
        Args:
            image0/1: [B, H, W, 1] grayscale in [0, 1], one shape.
            mask0/1: [B, H/8, W/8] coarse validity masks (padding).
            sample_idx: optional [B, ransac_iters, 4] RANSAC samples.
            generator: torch.Generator for the RANSAC samples otherwise.
            ransac_noise: or the uniforms of their Gumbel draw,
                [B, ransac_iters, max_matches] in [0, 1).
            train: BatchNorm on batch statistics (updating the running
                ones) and the force-one-match rule, as in the JAX model.
            return_feats: also return (f0, f1, g0, g1) in ``feats``.
        """
        cfg = self.config
        b, H, W, _ = image0.shape
        hc, wc = H // cfg.coarse_scale, W // cfg.coarse_scale
        m0 = mask0.reshape(b, -1) if mask0 is not None else None
        m1 = mask1.reshape(b, -1) if mask1 is not None else None

        force_one = cfg.match.force_one_match or train

        def matcher(a, c):
            # match ids carry no gradient; no graph is kept for the tiles
            with torch.no_grad():
                return coarse_match(a, c, cfg.match.thr,
                                    cfg.match.dsmax_temperature,
                                    cfg.match.max_matches, m0, m1,
                                    force_one=force_one,
                                    streaming=cfg.match.streaming_extract)

        # named ranges: the stages a profiler trace is read by
        with record_function("backbone"):
            feats_c, feats_f = self.backbone(torch.cat([image0, image1]),
                                             train)
            cnn_c0, cnn_c1 = feats_c[:b], feats_c[b:]
            feat_f0, feat_f1 = feats_f[:b], feats_f[b:]
        with record_function("coarse_transformer"):
            f0 = add_position_encoding(cnn_c0).reshape(b, hc * wc, -1)
            f1 = add_position_encoding(cnn_c1).reshape(b, hc * wc, -1)
            f0, f1 = self.loftr_coarse(f0, f1, m0, m1)
        with record_function("coarse_match_1"):
            matches1 = matcher(f0, f1)
        with record_function("gam"):
            g0, g1, geo_state = self.geo_module(cnn_c0, cnn_c1, matches1,
                                                cfg.coarse_scale, sample_idx,
                                                generator, ransac_noise)
        with record_function("coarse_match_2"):
            matches2 = matcher(g0, g1)
        with record_function("fine"):
            stride = cfg.coarse_scale // cfg.fine_scale
            w0, w1 = self.fine_preprocess(feat_f0, feat_f1, g0, g1, matches2,
                                          stride, wc, wc)
            m = w0.shape[1]
            ww = cfg.fine_match.window_size ** 2
            t0, t1 = self.loftr_fine(w0.reshape(b * m, ww, -1),
                                     w1.reshape(b * m, ww, -1))
            fine_conf = dual_softmax(t0, t1, cfg.fine_match.temperature)
            fine = fine_matching(fine_conf.reshape(b, m, ww, ww), matches2,
                                 wc, wc, cfg.coarse_scale, cfg.fine_scale,
                                 cfg.fine_match.window_size,
                                 cfg.fine_match.thr)
        feats = (f0, f1, g0, g1) if return_feats else ()
        return MatchOutput(matches2, fine, geo_state, matches1, feats)
