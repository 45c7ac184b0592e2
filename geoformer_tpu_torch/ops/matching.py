"""Dual-softmax matching confidence.

Counterpart of geoformer_tpu/ops/matching.py:dual_softmax: features divided
by sqrt(C), similarity divided by a temperature, padding filled with -inf,
confidence = softmax over rows times softmax over columns.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def dual_softmax(feat0: torch.Tensor, feat1: torch.Tensor,
                 temperature: float = 0.1,
                 mask0: Optional[torch.Tensor] = None,
                 mask1: Optional[torch.Tensor] = None,
                 inf: float = 1e9) -> torch.Tensor:
    """feat0: [B, L, C]; feat1: [B, S, C]; masks [B, L], [B, S] (1 valid).
    Returns conf [B, L, S]."""
    norm = 1.0 / math.sqrt(feat0.shape[-1])
    sim = torch.einsum("blc,bsc->bls", feat0 * norm, feat1 * norm) \
        / temperature
    if mask0 is not None and mask1 is not None:
        valid = mask0[:, :, None].bool() & mask1[:, None, :].bool()
        sim = sim.masked_fill(~valid, -inf)
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)
