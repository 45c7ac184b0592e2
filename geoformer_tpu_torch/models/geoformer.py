"""Full GeoFormer model, inference and training forward.

Counterpart of geoformer_tpu/models/geoformer.py:

    backbone -> sine PE -> coarse LoFTR -> coarse match (pass 1)
    -> GAM (RANSAC + geometry-restricted attention, kernels K1 and K2)
    -> coarse match (pass 2) -> fine window gather -> fine LoFTR
    -> fine dual-softmax decode

Both images share one static shape. The forward is differentiable (the
caller of inference wraps it in ``torch.no_grad``). The coarse matcher is
the streamed dual softmax, the dense one (``return_conf``, or
``streaming_extract`` off: the [B, L0, L1] confidences are then returned in
``matches.conf`` and ``matches1.conf``), or log-domain Sinkhorn with a
learned dustbin score (``match_type='sinkhorn'``, dense). The int8 flags
of the config (eval-only) put Int8Conv/Int8Dense in the backbone, the
coarse and fine stacks and the GAM.

Sequence parallelism (``cfg.seq_axis`` under a seq split of the ranks,
core/mesh.seq_groups; the counterpart of the JAX model under a mesh with
that axis): every rank takes the whole pair and keeps its band of image
rows, a whole number of coarse rows (core/spmd.py). The backbone, the
coarse transformer and the GAM's layers run on the band's rows and
tokens, the streamed extraction on the band's rows with exact merges;
RANSAC, the fine stage and the matches are every rank's alike. ``feats``
then holds the bands' tokens (``gather_feats`` joins them). It takes the
streamed dual-softmax matcher alone, as in the JAX package, and the float
paths alone (an int8 path's per-tensor scales would read every band).
Without a split, ``seq_axis`` changes nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from geoformer_tpu_torch.config import GeoFormerConfig
from geoformer_tpu_torch.core import spmd
from geoformer_tpu_torch.models.backbone import build_backbone, fine_channels
from geoformer_tpu_torch.models.coarse_matching import (
    CoarseMatches,
    coarse_match,
    extract_matches,
)
from geoformer_tpu_torch.models.fine import (
    FineMatches,
    FinePreprocess,
    fine_matching,
)
from geoformer_tpu_torch.models.geo_module import GeoModule, GeoState
from geoformer_tpu_torch.models.layers import no_grad
from geoformer_tpu_torch.models.position import add_position_encoding
from geoformer_tpu_torch.models.transformer import LocalFeatureTransformer
from geoformer_tpu_torch.ops.matching import dual_softmax
from geoformer_tpu_torch.ops.sinkhorn import log_optimal_transport
from geoformer_tpu_torch.utils.spans import span


class MatchOutput(NamedTuple):
    matches: CoarseMatches      # second-pass coarse matches
    fine: FineMatches           # final matches + fine confidence
    geo: GeoState               # RANSAC state (H, inlier stats)
    matches1: CoarseMatches     # first-pass coarse matches (RANSAC input)
    # (f0, f1, g0, g1): coarse features before/after the GAM, for the
    # streaming loss; empty unless return_feats=True.
    feats: Tuple[torch.Tensor, ...] = ()


def gather_feats(feats) -> Tuple[torch.Tensor, ...]:
    """A sequence-parallel forward's ``feats`` with every band's tokens,
    in token order (the feats themselves without a seq split)."""
    with torch.no_grad():
        return tuple(spmd.gather(f) for f in feats)


class GeoFormer(nn.Module):
    def __init__(self, config: GeoFormerConfig = GeoFormerConfig()):
        super().__init__()
        cfg = config
        if tuple(cfg.backbone.resolution) != (cfg.coarse_scale,
                                              cfg.fine_scale):
            raise ValueError((cfg.backbone.resolution, cfg.coarse_scale,
                              cfg.fine_scale))
        self.config = cfg
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        self.int8 = (cfg.backbone.int8 or cfg.coarse.int8 or cfg.fine.int8
                     or cfg.geo.int8)
        self.backbone = build_backbone(cfg.backbone, dtype=dtype)
        self.loftr_coarse = LocalFeatureTransformer(
            cfg.coarse.d_model, cfg.coarse.nhead, cfg.coarse.layer_names,
            cfg.coarse.attention, dtype=dtype, int8=cfg.coarse.int8)
        self.geo_module = GeoModule(cfg.geo, cfg.coarse.d_model, dtype=dtype)
        self.fine_preprocess = FinePreprocess(
            cfg.fine.d_model, cfg.coarse.d_model, cfg.fine_match.window_size,
            cfg.fine_match.concat_coarse_feat, dtype=dtype,
            d_feat_f=fine_channels(cfg.backbone))
        self.loftr_fine = LocalFeatureTransformer(
            cfg.fine.d_model, cfg.fine.nhead, cfg.fine.layer_names,
            cfg.fine.attention, dtype=dtype, int8=cfg.fine.int8)
        if cfg.match.match_type == "sinkhorn":
            self.bin_score = nn.Parameter(
                torch.tensor(float(cfg.match.skh_init_bin_score)))

    def _sinkhorn(self, a, c, m0, m1, force_one: bool) -> CoarseMatches:
        """Sinkhorn coarse matching (dense): similarity in the features'
        dtype, padding filled with -1e9, conf = exp(Z) without the
        dustbins."""
        cfg = self.config.match
        d = a.shape[-1] ** 0.5
        sim = torch.einsum("blc,bsc->bls", a / d, c / d) \
            / cfg.dsmax_temperature
        if m0 is not None and m1 is not None:
            vm = m0[:, :, None].bool() & m1[:, None, :].bool()
            sim = sim.masked_fill(~vm, -1e9)
        Z = log_optimal_transport(sim, self.bin_score, cfg.skh_iters)
        conf = torch.exp(Z)[:, :-1, :-1]
        return extract_matches(conf, cfg.thr, cfg.max_matches, force_one,
                               m0, m1)

    def forward(self, image0, image1, mask0=None, mask1=None,
                sample_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False,
                return_feats: bool = False,
                ransac_noise: Optional[torch.Tensor] = None,
                return_conf: bool = False) -> MatchOutput:
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
            return_conf: match through the dense confidences and return
                them in ``matches.conf`` (second pass) and
                ``matches1.conf`` (first pass), with their gradients.
        """
        cfg = self.config
        b, H, W, _ = image0.shape
        hc, wc = H // cfg.coarse_scale, W // cfg.coarse_scale
        m0 = mask0.reshape(b, -1) if mask0 is not None else None
        m1 = mask1.reshape(b, -1) if mask1 is not None else None

        if train and self.int8:
            raise ValueError("the int8 paths are eval-only (round() has no "
                             "gradient)")
        force_one = cfg.match.force_one_match or train
        streaming = cfg.match.streaming_extract and not return_conf
        if cfg.seq_axis is not None and not (
                streaming and cfg.match.match_type != "sinkhorn"):
            raise ValueError("seq_axis requires streaming extraction (no "
                             "dense [L, L] matrices exist to shard)")
        seq = cfg.seq_axis is not None and spmd.active()
        if seq and self.int8:
            raise ValueError("the int8 paths run replicated: their "
                             "per-tensor scales read the whole tensor, "
                             "not a band of it")
        band = spmd.row_band(hc, "coarse rows") if seq else slice(0, hc)
        tokens = slice(band.start * wc, band.stop * wc)
        rows = slice(band.start * cfg.coarse_scale,
                     band.stop * cfg.coarse_scale) if seq else slice(None)
        # the band's masks (the transformer); the matcher takes the whole
        b0 = None if m0 is None else m0[:, tokens]
        b1 = None if m1 is None else m1[:, tokens]

        def matcher(a, c):
            if cfg.match.match_type == "sinkhorn":
                return self._sinkhorn(a, c, m0, m1, force_one)
            if not streaming:
                return coarse_match(a, c, cfg.match.thr,
                                    cfg.match.dsmax_temperature,
                                    cfg.match.max_matches, m0, m1,
                                    force_one=force_one, streaming=False)
            # match ids carry no gradient; no graph is kept for the tiles
            with no_grad():
                return coarse_match(a, c, cfg.match.thr,
                                    cfg.match.dsmax_temperature,
                                    cfg.match.max_matches, m0, m1,
                                    force_one=force_one, seq=seq)

        # the stages, as spans: a profiler trace is read by their names
        with span("backbone"):
            feats_c, feats_f = self.backbone(
                torch.cat([image0[:, rows], image1[:, rows]]), train, seq)
            cnn_c0, cnn_c1 = feats_c[:b], feats_c[b:]
            feat_f0, feat_f1 = feats_f[:b], feats_f[b:]
        with span("coarse_transformer"):
            lb = tokens.stop - tokens.start
            f0 = add_position_encoding(cnn_c0, row0=band.start).reshape(
                b, lb, -1)
            f1 = add_position_encoding(cnn_c1, row0=band.start).reshape(
                b, lb, -1)
            f0, f1 = self.loftr_coarse(f0, f1, b0, b1, seq=seq)
        with span("coarse_match_1"):
            matches1 = matcher(f0, f1)
        with span("gam"):
            g0, g1, geo_state = self.geo_module(cnn_c0, cnn_c1, matches1,
                                                cfg.coarse_scale, sample_idx,
                                                generator, ransac_noise, seq)
        with span("coarse_match_2"):
            matches2 = matcher(g0, g1)
        with span("fine"):
            stride = cfg.coarse_scale // cfg.fine_scale
            w0, w1 = self.fine_preprocess(feat_f0, feat_f1, g0, g1, matches2,
                                          stride, wc, wc, seq)
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
