"""2-D sinusoidal position encoding.

Counterpart of geoformer_tpu/models/position.py, including the released
checkpoints' frequency schedule: with temp_bug_fix=False the reference
computes ``exp(arange(0, d//2, 2) * ((-log(1e4) / d) // 2))`` (Python
floor division), which for d=256 is ``exp(-2i)``. The released weights
depend on it, so it is kept. Positions are 1-indexed. A band of rows
(sequence parallelism) takes its rows' global positions (``row0``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _pe_table(d_model: int, h: int, w: int, temp_bug_fix: bool,
              row0: int = 0) -> np.ndarray:
    """[h, w, d_model] float32 position encoding (channels last) of rows
    row0 .. row0 + h - 1."""
    freq_idx = np.arange(0, d_model // 2, 2, dtype=np.float64)  # len d//4
    if temp_bug_fix:
        div_term = np.exp(freq_idx * (-math.log(10000.0) / (d_model // 2)))
    else:
        # the reference's operator-precedence bug, kept on purpose
        div_term = np.exp(freq_idx * (-math.log(10000.0) / d_model // 2))
    div = div_term[None, None, :]
    y = np.arange(row0 + 1, row0 + h + 1, dtype=np.float64)[:, None, None]
    x = np.arange(1, w + 1, dtype=np.float64)[None, :, None]
    pe = np.zeros((h, w, d_model), np.float32)
    pe[:, :, 0::4] = np.sin(x * div)
    pe[:, :, 1::4] = np.cos(x * div)
    pe[:, :, 2::4] = np.sin(y * div)
    pe[:, :, 3::4] = np.cos(y * div)
    return pe


def add_position_encoding(feat: torch.Tensor, temp_bug_fix: bool = False,
                          row0: int = 0) -> torch.Tensor:
    """feat: [B, H, W, C], rows row0 .. row0 + H - 1 of the map -> feat +
    PE (broadcast over the batch)."""
    _, h, w, c = feat.shape
    pe = torch.from_numpy(_pe_table(c, h, w, temp_bug_fix, row0))
    return feat + pe.to(device=feat.device, dtype=feat.dtype)
