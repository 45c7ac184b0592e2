"""Geometrized Attention Module (GAM).

Counterpart of geoformer_tpu/models/geo_module.py:

1. batched RANSAC over the first-pass coarse matches (geometry/ransac.py),
2. self layers: full attention over a fixed-capacity KV set of the
   RANSAC-inlier tokens under a column mask (kernel K2 when enabled),
3. cross layers: each coarse cell attends to the 5x5 window of cells
   around its homography-warped position in the other image, either through
   the gather-free box-window kernel K1 (``use_pallas``) or by gathering
   the windows (the plain path, which the JAX package takes off the TPU).

Samples without a usable homography keep their features through the cross
layers; empty KV sets leave features untouched. With ``cfg.int8`` the
layers' projections and MLPs are Int8Dense. On the box path a cross
layer then quantizes k_proj's input over the whole source token set (as
the JAX package's box_window_call), on the gather path over the gathered
windows (as its window_call): the two paths' scales differ where the
largest source token lies in no window.

Under sequence parallelism (``seq``, core/spmd.py) the features are this
rank's bands of rows and the matches every rank's alike. RANSAC runs on
every rank and the first rank's GeoState is broadcast (eigh on two
processes or cards is not promised to give the same bits, and every later
decision reads has_H, H and the inlier maps). A self layer's inlier KV
set is filled by the ranks that hold its rows and completed by one sum
(capacity-bounded, never [B, L, C]); a cross layer gathers the other
image's pre-layer features and runs the band's queries at their global
cells. Unlike the JAX package, which leaves its single-device box kernel
under sequence parallelism, the port keeps K1 there (``use_pallas``): it
takes any subset of queries with their centres.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from geoformer_tpu_torch.config import GeoModuleConfig
from geoformer_tpu_torch.core import mesh, spmd
from geoformer_tpu_torch.core.capacity import masked_select_capacity
from geoformer_tpu_torch.geometry.homography import warp_points
from geoformer_tpu_torch.geometry.ransac import ransac_homography
from geoformer_tpu_torch.models.coarse_matching import (
    CoarseMatches,
    match_coords,
)
from geoformer_tpu_torch.models.layers import no_grad
from geoformer_tpu_torch.models.position import add_position_encoding
from geoformer_tpu_torch.models.transformer import EncoderLayer
from geoformer_tpu_torch.utils.spans import span


class GeoState(NamedTuple):
    H: torch.Tensor            # [B, 3, 3] image0 -> image1 homography
    has_H: torch.Tensor        # [B] fit succeeded with > min_matches inputs
    map0: torch.Tensor         # [B, L0] inlier membership over image0 cells
    map1: torch.Tensor         # [B, L1]
    num_inliers: torch.Tensor  # [B]


def _build_geo_state(matches: CoarseMatches, hw0_c, hw1_c, scale: int,
                     cfg: GeoModuleConfig,
                     sample_idx: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> GeoState:
    """RANSAC on the first-pass matches + inlier membership maps."""
    b = matches.i_ids.shape[0]
    l0 = hw0_c[0] * hw0_c[1]
    l1 = hw1_c[0] * hw1_c[1]
    pts0 = match_coords(matches.i_ids, hw0_c[1], scale)
    pts1 = match_coords(matches.j_ids, hw1_c[1], scale)
    valid = matches.valid
    with span("ransac"):
        fit = ransac_homography(pts0, pts1, valid, thr=cfg.ransac_thr,
                                iters=cfg.ransac_iters,
                                refine_iters=cfg.refine_iters,
                                sample_idx=sample_idx, generator=generator,
                                noise=noise)
    has_H = fit["ok"] & (valid.sum(-1) > cfg.min_matches)
    # membership: RANSAC inliers when H exists, else all matches
    member = torch.where(has_H[:, None], fit["inliers"] & valid, valid)
    maps = []
    for cells, n in ((matches.i_ids, l0), (matches.j_ids, l1)):
        drop = torch.where(member, cells, torch.full_like(cells, n))
        m = torch.zeros((b, n + 1), dtype=torch.bool, device=cells.device)
        m.scatter_(1, drop, True)
        maps.append(m[:, :n])
    return GeoState(fit["H"], has_H, maps[0], maps[1], fit["num_inliers"])


def _window_cells(H, hw_src_c, hw_dst_c, scale: int, window_size: int):
    """Warp the source coarse grid through H and build the window of
    destination cells around each warped point. Returns (cells [B, Ls, W*W]
    linear destination ids, in-bounds mask [B, Ls, W*W])."""
    hs, ws = hw_src_c
    hd, wd = hw_dst_c
    r = window_size // 2
    dev = H.device
    grid = match_coords(torch.arange(hs * ws, device=dev), ws, scale)
    warped = warp_points(grid[None], H)                      # [B, Ls, 2]
    ax = torch.arange(-r, r + 1, dtype=torch.float32, device=dev) * scale
    oy, ox = torch.meshgrid(ax, ax, indexing="ij")
    off = torch.stack([ox, oy], dim=-1).reshape(-1, 2)       # (x, y)
    kp = warped[:, :, None, :] + off[None, None]             # [B, Ls, WW, 2]
    in_b = ((kp[..., 0] >= 0) & (kp[..., 0] < wd * scale)
            & (kp[..., 1] >= 0) & (kp[..., 1] < hd * scale))
    kp = torch.where(in_b[..., None], kp, torch.zeros_like(kp))
    cx = torch.floor(kp[..., 0] / scale).long().clamp(0, wd - 1)
    cy = torch.floor(kp[..., 1] / scale).long().clamp(0, hd - 1)
    return cy * wd + cx, in_b


def _box_centers(H, hw_src, scale: int) -> torch.Tensor:
    """Warped source-cell centres in destination cells, int32 [B, Ls, 2]."""
    hs, ws = hw_src
    grid = match_coords(torch.arange(hs * ws, device=H.device), ws, scale)
    warped = warp_points(grid[None], H)
    return torch.floor(warped.clamp(-1e6, 1e6) / scale).to(torch.int32)


def _take(feat, idx):
    """feat [B, N, C], idx [B, ...] -> [B, ..., C]."""
    b = feat.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(feat, 1, flat[..., None].expand(-1, -1, feat.shape[-1]))
    return out.reshape(*idx.shape, feat.shape[-1])


def take_tokens(feat, idx, seq: bool):
    """_take of global token ids ``idx`` [B, K] from ``feat``, this rank's
    band of the tokens with ``seq``: each rank fills the entries whose
    tokens it holds, zeros elsewhere, and one differentiable sum over the
    seq group completes them (every rank's alike)."""
    if not seq:
        return _take(feat, idx)
    lb = feat.shape[1]
    start = mesh.seq_rank() * lb
    own = (idx >= start) & (idx < start + lb)
    part = _take(feat, (idx - start).clamp(0, lb - 1))
    return spmd.seq_sum(torch.where(own[..., None], part,
                                    torch.zeros_like(part)))


class GeoModule(nn.Module):
    def __init__(self, cfg: GeoModuleConfig, d_model: int,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        for li, name in enumerate(cfg.layer_names):
            if name not in ("self", "cross"):
                raise KeyError(name)
            self.add_module(f"layer_{li}", EncoderLayer(
                d_model, cfg.nhead, attention="full", mlp_act="tanh",
                dtype=dtype, use_kernel=cfg.use_pallas and cfg.use_pallas_self,
                int8=cfg.int8))

    def forward(self, cnn_feat0, cnn_feat1, matches: CoarseMatches,
                scale: int, sample_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ransac_noise: Optional[torch.Tensor] = None,
                seq: bool = False):
        """cnn_feat0/1: [B, h, w, C] coarse CNN features (before the coarse
        transformer; with ``seq`` this rank's bands of rows). RANSAC takes
        sample_idx, else the uniforms of ransac_noise [B, ransac_iters,
        max_matches], else draws from generator. Returns (feat0 [B, L0, C],
        feat1 [B, L1, C], GeoState); with ``seq`` the features are the
        bands' tokens.
        """
        cfg = self.cfg
        b, hb0, w0, c = cnn_feat0.shape
        _, hb1, w1, _ = cnn_feat1.shape
        n = mesh.seq_world() if seq else 1
        h0, h1 = hb0 * n, hb1 * n
        tok0 = spmd.row_band(h0) if seq else slice(0, h0)
        tok1 = spmd.row_band(h1) if seq else slice(0, h1)
        tok0 = slice(tok0.start * w0, tok0.stop * w0)   # rows -> tokens
        tok1 = slice(tok1.start * w1, tok1.stop * w1)
        # the geometric fit is a hard decision: no gradient flows through
        # it (stop_gradient in the JAX package)
        with no_grad():
            state = _build_geo_state(matches, (h0, w0), (h1, w1), scale,
                                     cfg, sample_idx, generator,
                                     ransac_noise)
            if seq:
                state = GeoState(*spmd.broadcast_from_first(state))
        feat0 = add_position_encoding(cnn_feat0, row0=tok0.start // w0
                                      ).reshape(b, hb0 * w0, c)
        feat1 = add_position_encoding(cnn_feat1, row0=tok1.start // w1
                                      ).reshape(b, hb1 * w1, c)

        idx0, kv_ok0 = masked_select_capacity(state.map0, cfg.max_inliers)
        idx1, kv_ok1 = masked_select_capacity(state.map1, cfg.max_inliers)
        any0 = state.map0.any(dim=1)[:, None, None]
        any1 = state.map1.any(dim=1)[:, None, None]

        eye = torch.eye(3, dtype=state.H.dtype, device=state.H.device)
        H = torch.where(state.has_H[:, None, None], state.H, eye)
        Hinv = torch.linalg.inv_ex(H)[0]
        r = cfg.window_size // 2
        # the band's queries at their global cells
        if cfg.use_pallas:     # K1 takes contiguous centres
            centers1 = _box_centers(H, (h0, w0), scale)[:, tok0].contiguous()
            centers0 = _box_centers(Hinv, (h1, w1), scale)[:, tok1] \
                .contiguous()
        else:
            cells1, wmask1 = (x[:, tok0] for x in _window_cells(
                H, (h0, w0), (h1, w1), scale, cfg.window_size))
            cells0, wmask0 = (x[:, tok1] for x in _window_cells(
                Hinv, (h1, w1), (h0, w0), scale, cfg.window_size))
        sel = state.has_H[:, None, None]
        for li, name in enumerate(cfg.layer_names):
            layer = getattr(self, f"layer_{li}")
            if name == "self":
                out0 = layer(feat0, take_tokens(feat0, idx0, seq), None,
                             kv_ok0, mask_fill=-1e8)
                out1 = layer(feat1, take_tokens(feat1, idx1, seq), None,
                             kv_ok1, mask_fill=-1e8)
                feat0 = torch.where(any0, out0, feat0)
                feat1 = torch.where(any1, out1, feat1)
                continue
            # both directions read the features from before the layer
            src1, src0 = (spmd.gather(feat1), spmd.gather(feat0)) if seq \
                else (feat1, feat0)
            if cfg.use_pallas:
                out0 = layer.box_window_call(feat0, src1, centers1,
                                             (h1, w1), r)
                out1 = layer.box_window_call(feat1, src0, centers0,
                                             (h0, w0), r)
            else:
                out0 = layer.window_call(feat0, _take(src1, cells1), wmask1)
                out1 = layer.window_call(feat1, _take(src0, cells0), wmask0)
            feat0 = torch.where(sel, out0, feat0)
            feat1 = torch.where(sel, out1, feat1)
        return feat0, feat1, state
