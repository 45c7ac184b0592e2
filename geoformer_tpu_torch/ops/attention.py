"""Attention primitives for the coarse, fine and geo transformers.

Counterpart of geoformer_tpu/ops/attention.py, in plain PyTorch:
- linear_attention (elu+1 feature map, O(N) KV aggregation, /v_length guard),
- linear_attention_flat (the same math on [B, L, C] layouts; the fine
  stack's default),
- full_attention with padding-mask fill and optional zeroed empty rows,
- window_cross_attention, where each query owns a small gathered KV set.

Shapes are [B, L, H, D] (batch, tokens, heads, head_dim), as in the JAX
package. No function here is a kernel: they are einsums and matmuls.

With ``seq`` (sequence parallelism, core/spmd.py) the linear attentions
take this rank's band of the queries and of the sources: the KV and Ksum
aggregates are sums over the source tokens, so each rank sums its own and
one differentiable sum over the seq group completes both, and the overflow
guard divides by the global source length, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from geoformer_tpu_torch.core import mesh, spmd


def _elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def _source_sums(kv, ksum, seq: bool):
    """(KV, Ksum) summed over the seq group with ``seq``, in one
    all-reduce."""
    if not seq:
        return kv, ksum
    flat = spmd.seq_sum(torch.cat([kv.flatten(1), ksum.flatten(1)], 1))
    n = kv[0].numel()
    return flat[:, :n].view_as(kv), flat[:, n:].view_as(ksum)


def _source_len(s: int, seq: bool) -> int:
    return s * mesh.seq_world() if seq else s


def linear_attention(q, k, v, q_mask=None, kv_mask=None, eps: float = 1e-6,
                     seq: bool = False):
    """O(N) linear attention. q: [B, L, H, D]; k, v: [B, S, H, D];
    q_mask: [B, L]; kv_mask: [B, S]. Returns [B, L, H, D]."""
    Q = _elu_feature_map(q)
    K = _elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        kvm = kv_mask[:, :, None, None].to(K.dtype)
        K = K * kvm
        v = v * kvm
    s = _source_len(v.shape[1], seq)
    v_scaled = v / s  # overflow guard, as in the reference
    KV, Ksum = _source_sums(torch.einsum("bshd,bshv->bhdv", K, v_scaled),
                            K.sum(dim=1), seq)             # Ksum [B, H, D]
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Q, Ksum) + eps)
    return torch.einsum("blhd,bhdv->blhv", Q, KV) * Z[..., None] * s


def linear_attention_flat(q, k, v, nhead: int, q_mask=None, kv_mask=None,
                          eps: float = 1e-6, seq: bool = False):
    """linear_attention on [B, L, C] layouts: one [C, C] aggregate whose
    off-diagonal head blocks are zeroed. q: [B, L, C]; k, v: [B, S, C]."""
    c = q.shape[-1]
    s = _source_len(k.shape[1], seq)
    d = c // nhead
    Q = _elu_feature_map(q)
    K = _elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None].to(Q.dtype)
    if kv_mask is not None:
        kvm = kv_mask[:, :, None].to(K.dtype)
        K = K * kvm
        v = v * kvm
    v_scaled = v / s
    kv, ksum = _source_sums(torch.einsum("bsc,bse->bce", K, v_scaled),
                            K.sum(dim=1), seq)              # ksum [B, C]
    blk = torch.arange(c, device=q.device) // d
    same = (blk[:, None] == blk[None, :]).to(kv.dtype)
    out = torch.einsum("blc,bce->ble", Q, kv * same)
    onehot = F.one_hot(blk, nhead).to(K.dtype).T            # [H, C]
    z = 1.0 / (torch.einsum("blc,bhc->blh", Q,
                            ksum[:, None, :] * onehot[None]) + eps)
    return out * torch.repeat_interleave(z, d, dim=-1) * s


def full_attention(q, k, v, q_mask=None, kv_mask=None,
                   mask_fill: float = -1e9, zero_empty_rows: bool = False):
    """Softmax attention with optional padding masks; masked logits are set
    to ``mask_fill`` before scaling. ``zero_empty_rows`` zeroes the output
    of batch rows whose whole kv_mask is false."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("blhd,bshd->blsh", q, k)
    if q_mask is not None or kv_mask is not None:
        m = None
        if q_mask is not None:
            m = q_mask[:, :, None, None].bool()
        if kv_mask is not None:
            km = kv_mask[:, None, :, None].bool()
            m = km if m is None else (m & km)
        logits = logits.masked_fill(~m, mask_fill)
    attn = torch.softmax(scale * logits, dim=2)
    out = torch.einsum("blsh,bshd->blhd", attn, v)
    if zero_empty_rows and kv_mask is not None:
        empty = kv_mask.int().sum(-1) == 0                  # [B]
        out = torch.where(empty[:, None, None, None], 0.0, out)
    return out


def window_cross_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                           mask_fill: float = -1e8):
    """Per-query windowed attention. q: [B, L, H, D]; k, v: [B, L, W, H, D];
    kv_mask: [B, L, W]. Queries whose window is all invalid get zeros."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("blhd,blwhd->blwh", q, k)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[..., None].bool(), mask_fill)
    attn = torch.softmax(scale * logits, dim=2)
    out = torch.einsum("blwh,blwhd->blhd", attn, v)
    if kv_mask is not None:
        empty = kv_mask.int().sum(-1) == 0                  # [B, L]
        out = torch.where(empty[:, :, None, None], 0.0, out)
    return out
