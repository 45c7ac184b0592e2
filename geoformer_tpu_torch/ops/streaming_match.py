"""Streamed dual-softmax match statistics.

Counterpart of sim_lse and streaming_match_extract in
geoformer_tpu/ops/fused_loss.py. With sim_ij = <f0_i, f1_j> / (C * T),

    conf_ij = softmax_row(sim)_ij * softmax_col(sim)_ij
            = exp(2 sim_ij - r_i - c_j),  r = row LSE, c = col LSE,

so match extraction needs the two LSE vectors (one streamed pass over row
chunks) and the row/col arg-maxes of 2 sim - c and 2 sim - r (a second
pass). The [B, L, S] matrix is never built: peak memory is one
[B, chunk, S] tile. The row chunk is 600, as in the JAX package. The LSE
pass is differentiable (the streaming loss, ops/fused_loss.py): each chunk
runs under ``torch.utils.checkpoint``, as JAX runs it under
``jax.checkpoint``, so the backward recomputes a chunk's tile instead of
keeping L / chunk of them.

With ``seq`` (sequence parallelism, core/spmd.py) feat0 and mask0 are this
rank's band of rows and feat1 and mask1 its band of columns; the columns
are gathered, each rank streams its own rows, and the column statistics
merge exactly over the seq group: the LSE as an online logsumexp (a max of
the running maxima, then a sum of acc * exp(m - max)), the column argmax
by the serial first-wins rule (the global max, then the smallest global
row index among the rows that reach it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from geoformer_tpu_torch.core import mesh, spmd

_NEG_INF = -1e9  # the dense dual softmax's mask fill


def _prep(feat0, mask0, mask1, temperature: float):
    b, l, c = feat0.shape
    inv = 1.0 / (float(c) * temperature)
    row_valid = (torch.ones((b, l), dtype=torch.bool, device=feat0.device)
                 if mask0 is None else mask0.reshape(b, l) > 0)
    col_valid = None if mask1 is None else mask1.reshape(b, -1) > 0
    return row_valid, col_valid, inv


def _tile(f0c, f1, rv, col_valid, inv):
    """One [B, chunk, S] masked similarity tile, accumulated in f32."""
    t = torch.einsum("blc,bsc->bls", f0c, f1).float() * inv
    valid = rv[:, :, None]
    if col_valid is not None:
        valid = valid & col_valid[:, None, :]
    return t.masked_fill(~valid, _NEG_INF)


def _lse_chunk(f0c, f1, rv, col_valid, inv: float, m, acc):
    """One row chunk of the streamed LSEs: (row LSE [B, chunk], the column
    statistics m and acc updated)."""
    t = _tile(f0c, f1, rv, col_valid, inv)
    m_new = torch.maximum(m, t.amax(dim=1))
    acc = acc * torch.exp(m - m_new) + torch.exp(
        t - m_new[:, None, :]).sum(dim=1)
    return torch.logsumexp(t, dim=2), m_new, acc


def gather_columns(feat1, mask1, seq: bool):
    """(feat1, mask1) of every column: the bands gathered with ``seq``
    (feat1 differentiably), as given without."""
    if not seq:
        return feat1, mask1
    b = feat1.shape[0]
    return spmd.gather(feat1), (None if mask1 is None else spmd.gather(
        mask1.reshape(b, -1)))


def sim_lse(feat0, feat1, temperature: float, mask0=None, mask1=None,
            chunk: int = 600, seq: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row/col logsumexp of the masked similarity matrix, streamed over row
    chunks, each checkpointed. Returns (r [B, L], c [B, S]) in f32. With
    ``seq``, feat0/mask0 are this rank's rows and feat1/mask1 all columns;
    r covers this rank's rows, c is merged over the seq group (the max
    shift detached: it cancels in c)."""
    b, l, _ = feat0.shape
    s = feat1.shape[1]
    row_valid, col_valid, inv = _prep(feat0, mask0, mask1, temperature)
    m = torch.full((b, s), _NEG_INF, dtype=torch.float32, device=feat0.device)
    acc = torch.zeros((b, s), dtype=torch.float32, device=feat0.device)
    rows = []
    for start in range(0, l, chunk):
        r_c, m, acc = checkpoint(
            _lse_chunk, feat0[:, start:start + chunk], feat1,
            row_valid[:, start:start + chunk], col_valid, inv, m, acc,
            use_reentrant=False)
        rows.append(r_c)
    if seq:
        gm = spmd.seq_max(m.detach())
        acc = spmd.seq_sum(acc * torch.exp(m - gm))
        m = gm
    c = m + torch.log(torch.clamp(acc, min=1e-30))
    return torch.cat(rows, dim=1), c


def streaming_match_extract(feat0, feat1, temperature: float,
                            mask0: Optional[torch.Tensor] = None,
                            mask1: Optional[torch.Tensor] = None,
                            chunk: int = 600, seq: bool = False):
    """Row/col nearest-neighbour statistics of the dual-softmax confidence.

    Returns:
        row_best: [B, L] f32 best confidence per image0 cell.
        j_ids:    [B, L] int64 argmax column per row.
        col_arg:  [B, S] int64 argmax row per column (first row on ties).
        conf00:   [B] f32 confidence at cell pair (0, 0).

    With ``seq`` the inputs are this rank's bands: row_best and j_ids come
    back for its rows (j_ids global columns), col_arg (global rows) and
    conf00 (the first rank's) are every rank's alike.
    """
    b, l, _ = feat0.shape
    feat1, mask1 = gather_columns(feat1, mask1, seq)
    s = feat1.shape[1]
    chunk = max(1, min(chunk, l))
    row_off = mesh.seq_rank() * l if seq else 0
    r, c = sim_lse(feat0, feat1, temperature, mask0, mask1, chunk, seq)
    row_valid, col_valid, inv = _prep(feat0, mask0, mask1, temperature)
    col_m = torch.full((b, s), float("-inf"), device=feat0.device)
    col_arg = torch.zeros((b, s), dtype=torch.long, device=feat0.device)
    best, args = [], []
    for start in range(0, l, chunk):
        t = _tile(feat0[:, start:start + chunk], feat1,
                  row_valid[:, start:start + chunk], col_valid, inv)
        r_c = r[:, start:start + chunk]
        m, a = (2.0 * t - c[:, None, :]).max(dim=2)
        best.append(torch.exp(m - r_c))
        args.append(a)
        cm, ca = (2.0 * t - r_c[:, :, None]).max(dim=1)
        better = cm > col_m          # strict: earlier chunks win ties
        col_m = torch.where(better, cm, col_m)
        col_arg = torch.where(better, ca + start + row_off, col_arg)
    if seq:
        gm = spmd.seq_max(col_m)
        cand = torch.where(col_m >= gm, col_arg,
                           torch.full_like(col_arg, torch.iinfo(
                               torch.int64).max))
        col_arg = spmd.seq_min(cand)
    sim00 = (feat0[:, 0].float() * feat1[:, 0].float()).sum(-1) * inv
    if mask0 is not None or mask1 is not None:
        ok00 = row_valid[:, 0]
        if col_valid is not None:
            ok00 = ok00 & col_valid[:, 0]
        sim00 = torch.where(ok00, sim00, _NEG_INF)
    conf00 = torch.exp(2.0 * sim00 - r[:, 0] - c[:, 0])
    if seq:     # only the first rank holds global row 0
        conf00 = spmd.seq_sum(torch.where(
            torch.tensor(mesh.seq_rank() == 0, device=conf00.device),
            conf00, torch.zeros_like(conf00)))
    return torch.cat(best, dim=1), torch.cat(args, dim=1), col_arg, conf00
