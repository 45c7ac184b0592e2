"""LoFTR encoder layers and interleaved self/cross stacks.

Counterpart of geoformer_tpu/models/transformer.py: bias-free QKV/merge
projections, linear or full attention, LayerNorm after merge, a concat-MLP
(Dense 2d->2d, act, Dense 2d->d, bias-free), a second LayerNorm and a
residual add. LayerNorms compute in f32 whatever the compute dtype, so, as in
the JAX package, the residual sum is f32 after the first layer.

``EncoderLayer`` has three call paths over the same parameters: token-set
attention (``forward``), gathered per-query windows (``window_call``) and
the gather-free box window (``box_window_call``, kernel K1).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from geoformer_tpu_torch.models.layers import Dense
from geoformer_tpu_torch.ops import gam_kernels
from geoformer_tpu_torch.ops.attention import (
    full_attention,
    linear_attention,
    linear_attention_flat,
    window_cross_attention,
)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, attention: str = "linear",
                 mlp_act: str = "relu", dtype=torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        if attention not in ("linear", "linear_flat", "full"):
            raise ValueError(f"unknown attention {attention!r}")
        self.d_model = d_model
        self.nhead = nhead
        self.attention = attention
        self.act = F.relu if mlp_act == "relu" else torch.tanh
        self.use_kernel = use_kernel  # K2 for masked-KV full attention
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.merge = Dense(d_model, d_model, dtype=dtype)
        self.mlp0 = Dense(2 * d_model, 2 * d_model, dtype=dtype)
        self.mlp1 = Dense(2 * d_model, d_model, dtype=dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.nhead, self.d_model // self.nhead)

    def _finish(self, x, message):
        b, l = x.shape[0], x.shape[1]
        message = self.merge(message.reshape(b, l, self.d_model))
        message = self.norm1(message.float())
        y = torch.cat([x, message.to(x.dtype)], dim=-1)
        y = self.norm2(self.mlp1(self.act(self.mlp0(y))).float())
        return x + y

    def forward(self, x, source, x_mask=None, source_mask=None,
                zero_empty_rows: bool = False, mask_fill: float = -1e9):
        """x: [B, L, C] queries; source: [B, S, C] keys/values."""
        if self.attention == "linear_flat":
            message = linear_attention_flat(
                self.q_proj(x), self.k_proj(source), self.v_proj(source),
                self.nhead, x_mask, source_mask)
            return self._finish(x, message)
        q = self._heads(self.q_proj(x))
        k = self._heads(self.k_proj(source))
        v = self._heads(self.v_proj(source))
        if self.attention == "linear":
            message = linear_attention(q, k, v, x_mask, source_mask)
        elif (self.use_kernel and x_mask is None and source_mask is not None
              and not zero_empty_rows):
            message = gam_kernels.masked_kv_attention(q, k, v, source_mask,
                                                      mask_fill=mask_fill)
        else:
            message = full_attention(q, k, v, x_mask, source_mask,
                                     mask_fill=mask_fill,
                                     zero_empty_rows=zero_empty_rows)
        return self._finish(x, message)

    def box_window_call(self, x, source, centers, grid_hw, radius: int,
                        mask_fill: float = -1e8):
        """Each query attends to the (2r+1)^2 box of destination cells
        around its warped centre, over the full projected token set (K1)."""
        q = self._heads(self.q_proj(x))
        k = self._heads(self.k_proj(source))
        v = self._heads(self.v_proj(source))
        message, _ = gam_kernels.box_window_attention_fwd(
            q, k, v, centers, grid_hw, radius, mask_fill)
        return self._finish(x, message)

    def window_call(self, x, window_kv, window_mask=None,
                    mask_fill: float = -1e8):
        """Per-query attention over gathered windows [B, L, W, C];
        window_mask [B, L, W] (all-invalid rows get a zero message)."""
        q = self._heads(self.q_proj(x))
        k = self._heads(self.k_proj(window_kv))
        v = self._heads(self.v_proj(window_kv))
        message = window_cross_attention(q, k, v, window_mask,
                                         mask_fill=mask_fill)
        return self._finish(x, message)


class LocalFeatureTransformer(nn.Module):
    """Interleaved self/cross encoder stack over two token sets."""

    def __init__(self, d_model: int, nhead: int, layer_names: Sequence[str],
                 attention: str = "linear", dtype=torch.float32):
        super().__init__()
        self.layer_names = tuple(layer_names)
        for i, name in enumerate(self.layer_names):
            if name not in ("self", "cross"):
                raise KeyError(name)
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, nhead, attention, dtype=dtype))

    def forward(self, feat0, feat1, mask0=None, mask1=None):
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer_{i}")
            if name == "self":
                feat0 = layer(feat0, feat0, mask0, mask0)
                feat1 = layer(feat1, feat1, mask1, mask1)
            else:
                # sequential, as in the reference: feat1 attends to the
                # already-updated feat0
                feat0 = layer(feat0, feat1, mask0, mask1)
                feat1 = layer(feat1, feat0, mask1, mask0)
        return feat0, feat1
