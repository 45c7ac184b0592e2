"""Metric aggregation across processes.

Counterpart of geoformer_tpu/core/dist.py: fixed-shape metric arrays are
gathered from every rank of the torch.distributed group (core/mesh.py) and
concatenated on the leading axis; with one process they pass through
unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from geoformer_tpu_torch.core import mesh


def _gather(x) -> np.ndarray:
    """[world, *x.shape]: ``x`` from every rank, in rank order."""
    a = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(a.view(np.uint8) if a.dtype == bool else a)
    t = t.to(mesh.comm_device())
    parts = [torch.empty_like(t) for _ in range(mesh.world())]
    dist.all_gather(parts, t)
    out = torch.stack(parts).cpu().numpy()
    return out.view(bool) if a.dtype == bool else out


def all_gather_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Per-process metric arrays gathered from every process, concatenated
    on the leading axis (a scalar becomes [world]); one process: identity.
    Every rank passes the same keys with the same shapes."""
    if mesh.world() == 1:
        return metrics
    return {k: _gather(x).reshape(-1, *np.shape(x)[1:])
            for k, x in metrics.items()}


def host_mean(value) -> float:
    """Mean of a scalar across processes."""
    if mesh.world() == 1:
        return float(value)
    return float(np.mean(_gather(np.asarray(value, np.float32))))
