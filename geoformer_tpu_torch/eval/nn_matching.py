"""Mutual nearest-neighbour descriptor matching (a baseline matcher).

Counterpart of geoformer_tpu/eval/nn_matching.py: cosine similarity of
L2-normalized descriptors, the mutual-NN check and an optional minimum
similarity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def mutual_nn_match(desc0: torch.Tensor, desc1: torch.Tensor,
                    threshold: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """desc0 [N0, D], desc1 [N1, D] -> (idx0 [N0] int32: each desc0's best
    desc1, valid [N0]: mutual (and above ``threshold``), sim [N0]: its
    cosine similarity)."""
    d0 = desc0 / torch.clamp(desc0.norm(dim=-1, keepdim=True), min=1e-8)
    d1 = desc1 / torch.clamp(desc1.norm(dim=-1, keepdim=True), min=1e-8)
    sim = d0 @ d1.T
    best, nn01 = sim.max(dim=1)
    nn10 = sim.argmax(dim=0)
    valid = nn10[nn01] == torch.arange(desc0.shape[0], device=desc0.device)
    if threshold is not None:
        valid = valid & (best > threshold)
    return nn01.to(torch.int32), valid, best
