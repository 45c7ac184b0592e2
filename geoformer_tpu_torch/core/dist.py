"""Metric aggregation across processes.

Counterpart of geoformer_tpu/core/dist.py for one process: the metric
arrays pass through unchanged. Gathering them over a torch.distributed
process group of several ranks belongs to the data-parallel slice
(ROADMAP queue 1, item 6) and raises until then.
"""

from __future__ import annotations

from typing import Any, Dict

import torch.distributed as dist


def all_gather_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Per-process metric arrays gathered from every process, concatenated
    on the leading axis; one process: identity."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "gathering metrics over several processes is not ported yet "
            "(ROADMAP queue 1 item 2, data parallelism)")
    return metrics
