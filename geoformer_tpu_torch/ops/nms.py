"""Non-maximum suppression on score maps.

Counterpart of geoformer_tpu/ops/nms.py: keep the local maxima of each
(2r+1)^2 window (a same-size max pool, the border padded with -inf), and
top-k keypoints of a score map.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _maxpool(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Same-shape max pool over (2r+1)^2 windows. x: [..., H, W]."""
    k = 2 * radius + 1
    y = F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), k, stride=1,
                     padding=radius)
    return y.reshape(x.shape)


def simple_nms(scores: torch.Tensor, radius: int,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero the scores that are not the maximum of their window. Ties in a
    window are broken by a uniform perturbation / 10 (the reference's
    rand/10), drawn from ``generator`` or given as ``noise`` (uniforms in
    [0, 1) of the scores' shape); with neither, every tied maximum stays."""
    is_max = scores == _maxpool(scores, radius)
    if noise is None and generator is not None:
        noise = torch.rand(scores.shape, generator=generator,
                           device=generator.device).to(scores.device)
    if noise is None:
        keep = is_max
    else:
        noise = torch.where(is_max, noise / 10.0, torch.zeros_like(noise))
        keep = (noise == _maxpool(noise, radius)) & (noise > 0)
    return torch.where(keep, scores, torch.zeros_like(scores))


def top_k_keypoints(scores: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened top-k of a [H, W] score map -> ((x, y) [k, 2], scores
    [k]), highest first."""
    w = scores.shape[1]
    vals, idx = torch.topk(scores.reshape(-1), k)
    return torch.stack([idx % w, idx // w], dim=-1), vals
