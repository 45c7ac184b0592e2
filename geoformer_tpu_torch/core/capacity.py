"""Fixed-capacity selection, batched over the leading axis.

Counterpart of geoformer_tpu/core/capacity.py: the port keeps the JAX
package's fixed capacities, so every shape on the main path is static.
"""

from __future__ import annotations

import torch


def masked_select_capacity(mask: torch.Tensor, capacity: int):
    """Compact the True positions of ``mask`` [B, N] into [B, capacity].

    Keeps the first ``capacity`` True positions in index order. Returns
    (idx [B, capacity] int64, 0 in padding slots; valid [B, capacity])."""
    b, n = mask.shape
    m = mask.long()
    pos = torch.cumsum(m, dim=1) - 1
    take = (m > 0) & (pos < capacity)
    slots = torch.where(take, pos, torch.full_like(pos, capacity))
    src = torch.arange(n, device=mask.device).expand(b, n)
    idx = torch.zeros((b, capacity + 1), dtype=torch.long, device=mask.device)
    idx.scatter_(1, slots, src)  # untaken entries all land in slot capacity
    count = torch.clamp(m.sum(dim=1), max=capacity)
    valid = torch.arange(capacity, device=mask.device)[None] < count[:, None]
    return idx[:, :capacity], valid


def topk_select(score: torch.Tensor, valid: torch.Tensor, capacity: int):
    """Indices of the ``capacity`` highest-scoring valid entries per row of
    score/valid [B, N]; ties go to the lower index (as lax.top_k).
    Returns (idx [B, capacity] int64, out_valid [B, capacity])."""
    neg = torch.finfo(score.dtype).min
    masked = torch.where(valid, score, torch.full_like(score, neg))
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    idx = order[:, :capacity]
    return idx, torch.gather(valid, 1, idx)


def scatter_onehot_2d(shape, rows: torch.Tensor, cols: torch.Tensor,
                      valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A dense [H, W] map with ones at the flat cells rows[k] * W + cols[k]
    of the valid k; a flat index in [-H*W, 0) counts from the end, one
    outside [-H*W, H*W) is dropped (JAX's scatter with mode="drop")."""
    n = shape[0] * shape[1]
    lin = rows.long() * shape[1] + cols.long()
    lin = torch.where(lin < 0, lin + n, lin)
    lin = torch.where(valid & (lin >= 0) & (lin < n), lin,
                      torch.full_like(lin, n))
    flat = torch.zeros(n + 1, dtype=dtype, device=rows.device)
    flat[lin] = 1
    return flat[:n].reshape(shape)
