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

On the card (a CUDA tensor, no gradient) the two passes are the
hand-written kernel K6 (``csrc/streaming_match.cu``): two
``torch.library`` custom ops, ``torch.ops.geoformer.streaming_match_lse``
and ``streaming_match_argmax``, two launches each (a pass, then a merge of
its partials), which never write a similarity tile to device memory. Their
CPU implementations are the chunked loop below, which is the plain version:
``streaming_match_extract`` runs it for a CPU tensor. A CUDA tensor
launches the kernels or raises (with a gradient to keep: the kernels have
no backward; the matcher calls the extraction under no_grad). The
sequence-parallel merges stay in Python around the two ops. Each CUDA call
of ``streaming_match_extract`` adds one to
``gam_kernels.LAUNCHES["streaming_match_extract"]``. ``sim_lse`` with a
gradient (the streaming loss) stays on the chunked loop on both devices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from geoformer_tpu_torch.core import mesh, spmd
from geoformer_tpu_torch.ops.cuda_lib import load_library
from geoformer_tpu_torch.ops.gam_kernels import LAUNCHES, _cdiv

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


def _lse_pass(feat0, feat1, row_valid, col_valid, inv: float, chunk: int):
    """The LSE pass of the chunked loop, each chunk checkpointed: (row LSE
    r [B, L], the columns' running max m and sum of exp acc [B, S])."""
    b, l, _ = feat0.shape
    s = feat1.shape[1]
    m = torch.full((b, s), _NEG_INF, dtype=torch.float32, device=feat0.device)
    acc = torch.zeros((b, s), dtype=torch.float32, device=feat0.device)
    rows = []
    for start in range(0, l, chunk):
        r_c, m, acc = checkpoint(
            _lse_chunk, feat0[:, start:start + chunk], feat1,
            row_valid[:, start:start + chunk], col_valid, inv, m, acc,
            use_reentrant=False)
        rows.append(r_c)
    return torch.cat(rows, dim=1), m, acc


def _col_lse(m, acc, seq: bool):
    """The column LSE c from the columns' max and sum of exp, merged over
    the seq group with ``seq`` (the max shift detached: it cancels)."""
    if seq:
        gm = spmd.seq_max(m.detach())
        acc = spmd.seq_sum(acc * torch.exp(m - gm))
        m = gm
    return m + torch.log(torch.clamp(acc, min=1e-30))


def sim_lse(feat0, feat1, temperature: float, mask0=None, mask1=None,
            chunk: int = 600, seq: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row/col logsumexp of the masked similarity matrix, streamed over row
    chunks, each checkpointed. Returns (r [B, L], c [B, S]) in f32. With
    ``seq``, feat0/mask0 are this rank's rows and feat1/mask1 all columns;
    r covers this rank's rows, c is merged over the seq group (the max
    shift detached: it cancels in c)."""
    row_valid, col_valid, inv = _prep(feat0, mask0, mask1, temperature)
    r, m, acc = _lse_pass(feat0, feat1, row_valid, col_valid, inv, chunk)
    return r, _col_lse(m, acc, seq)


def _argmax_pass(feat0, feat1, row_valid, col_valid, inv: float, r, c,
                 chunk: int, row_off: int):
    """The arg-max pass of the chunked loop: (row_best, j_ids [B, L], the
    columns' max of 2 sim - r and its first row + row_off [B, S])."""
    b, l, _ = feat0.shape
    s = feat1.shape[1]
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
    return torch.cat(best, dim=1), torch.cat(args, dim=1), col_m, col_arg


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
    conf00 (the first rank's) are every rank's alike. A CUDA tensor runs
    kernel K6 (f32 features; ``chunk`` is the plain loop's and is not read
    there) and raises if a gradient could flow to the features.
    """
    b, l, _ = feat0.shape
    feat1, mask1 = gather_columns(feat1, mask1, seq)
    chunk = max(1, min(chunk, l))
    row_off = mesh.seq_rank() * l if seq else 0
    row_valid, col_valid, inv = _prep(feat0, mask0, mask1, temperature)
    if feat0.is_cuda:
        if torch.is_grad_enabled() and (feat0.requires_grad
                                        or feat1.requires_grad):
            raise RuntimeError(
                "streaming_match_extract: kernel K6 has no backward; call it "
                "under torch.no_grad() on the card")
        # the kernel reads [rows, C] rows (the seq path's bands come
        # channel-major)
        feat0, feat1 = feat0.contiguous(), feat1.contiguous()
        m0 = None if mask0 is None else row_valid
        r, m, acc = extract_lse(feat0, feat1, m0, col_valid, inv)
        c = _col_lse(m, acc, seq)
        row_best, j_ids, col_m, col_arg = extract_argmax(
            feat0, feat1, m0, col_valid, r, c, inv, row_off)
    else:
        r, m, acc = _lse_pass(feat0, feat1, row_valid, col_valid, inv, chunk)
        c = _col_lse(m, acc, seq)
        row_best, j_ids, col_m, col_arg = _argmax_pass(
            feat0, feat1, row_valid, col_valid, inv, r, c, chunk, row_off)
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
    return row_best, j_ids, col_arg, conf00


# ---------------------------------------------------------------- K6 -------

# A block of K6 takes EXTRACT_ROWS rows against tiles of EXTRACT_COLS
# columns (csrc/streaming_match.cu: kBM, kBN); it keeps up to EXTRACT_MAX_C
# channels of its rows in shared memory.
EXTRACT_ROWS = 128
EXTRACT_COLS = 64
EXTRACT_MAX_C = 256
_PLAIN_CHUNK = 600  # the plain loop's row chunk, as in the JAX package


def extract_splits(batch: int, len0: int, len1: int, sms: int) -> int:
    """K6's column splits: the blocks are (row block, column split, pair);
    a split is taken where it fills the last wave of blocks over the SMs by
    5 % more than one split fewer. Returns the number of splits that have
    a tile (at most 8)."""
    n_blk, n_tiles = _cdiv(len0, EXTRACT_ROWS), _cdiv(len1, EXTRACT_COLS)
    best, best_fill = 1, 0.0
    for want in range(1, min(8, n_tiles) + 1):
        n = _cdiv(n_tiles, _cdiv(n_tiles, want))
        blocks = n_blk * batch * n
        fill = blocks / (_cdiv(blocks, sms) * sms)
        if fill > best_fill + 0.05:
            best, best_fill = n, fill
    return best


def _check_extract(name, feat0, feat1, mask0, mask1, vecs=()):
    """What K6 takes: f32 [B, L, C] and [B, S, C] features on one CUDA
    device, contiguous and 16-byte aligned, C a multiple of 4 up to 256;
    bool masks [B, L], [B, S] (or None) and f32 vectors, contiguous."""
    for t in (feat0, feat1):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: features must be float32, not "
                            f"{t.dtype}")
    b, l, ch = feat0.shape
    s = feat1.shape[1]
    if (feat1.dim() != 3 or feat1.shape[0] != b or feat1.shape[2] != ch
            or l == 0 or s == 0 or ch % 4 or not 0 < ch <= EXTRACT_MAX_C):
        raise ValueError(
            f"{name}: features {tuple(feat0.shape)} and {tuple(feat1.shape)} "
            f"(same B and C, C a multiple of 4 up to {EXTRACT_MAX_C}, L and "
            f"S > 0)")
    for t in (feat0, feat1, *(x for x in (mask0, mask1) if x is not None),
              *vecs):
        if t.device != feat0.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{feat0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in (feat0, feat1):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: features must be 16-byte aligned")
    for t, shape in ((mask0, (b, l)), (mask1, (b, s))):
        if t is not None and (t.dtype != torch.bool
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: masks must be bool {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _extract_scratch(feat0, feat1):
    """(column partials [B, ceil(L / 128), S, 2], row partials [B, n, L, 2]
    f32, n the column splits): one per call, the LSE pass's freed before
    the arg-max pass takes its own."""
    b, l, _ = feat0.shape
    s = feat1.shape[1]
    sms = torch.cuda.get_device_properties(
        feat0.device).multi_processor_count
    n_split = extract_splits(b, l, s, sms)
    f32 = dict(dtype=torch.float32, device=feat0.device)
    return (torch.empty((b, _cdiv(l, EXTRACT_ROWS), s, 2), **f32),
            torch.empty((b, n_split, l, 2), **f32), n_split)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _run(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch error {err}")


def _row_valid(feat0, mask0):
    return (torch.ones(feat0.shape[:2], dtype=torch.bool, device=feat0.device)
            if mask0 is None else mask0)


def extract_lse_plain(feat0, feat1, mask0, mask1, inv: float):
    """K6's LSE op, plain: the chunked loop's LSE pass. Takes the op's
    arguments (bool masks or None) and gives its outputs: (r [B, L], the
    columns' max and sum of exp [B, S]) in f32."""
    return _lse_pass(feat0, feat1, _row_valid(feat0, mask0), mask1, inv,
                     _PLAIN_CHUNK)


def extract_argmax_plain(feat0, feat1, mask0, mask1, r, c, inv: float,
                         row_off: int):
    """K6's arg-max op, plain: the chunked loop's arg-max pass (row_best,
    j_ids [B, L], the columns' max of 2 sim - r and its row + row_off
    [B, S])."""
    return _argmax_pass(feat0, feat1, _row_valid(feat0, mask0), mask1, inv,
                        r, c, min(_PLAIN_CHUNK, feat0.shape[1]), row_off)


@torch.library.custom_op("geoformer::streaming_match_lse", mutates_args=(),
                         device_types="cpu")
def _lse_op(feat0: torch.Tensor, feat1: torch.Tensor,
            mask0: Optional[torch.Tensor], mask1: Optional[torch.Tensor],
            inv: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return extract_lse_plain(feat0, feat1, mask0, mask1, inv)


@_lse_op.register_kernel("cuda")
def _lse_cuda(feat0, feat1, mask0, mask1, inv):
    _check_extract("streaming_match_lse", feat0, feat1, mask0, mask1)
    b, l, ch = feat0.shape
    s = feat1.shape[1]
    col_part, row_part, n_split = _extract_scratch(feat0, feat1)
    f32 = dict(dtype=torch.float32, device=feat0.device)
    r = torch.empty((b, l), **f32)
    m = torch.empty((b, s), **f32)
    acc = torch.empty((b, s), **f32)
    with torch.cuda.device(feat0.device):
        _run("streaming_match_lse", load_library().gam_streaming_match_lse,
             feat0.data_ptr(), feat1.data_ptr(), _ptr(mask0), _ptr(mask1),
             col_part.data_ptr(), row_part.data_ptr(), m.data_ptr(),
             acc.data_ptr(), r.data_ptr(), b, l, s, ch, n_split, inv,
             torch.cuda.current_stream(feat0.device).cuda_stream)
    return r, m, acc


@_lse_op.register_fake
def _lse_fake(feat0, feat1, mask0, mask1, inv):
    b, l, _ = feat0.shape
    s = feat1.shape[1]
    return (feat0.new_empty((b, l), dtype=torch.float32),
            feat0.new_empty((b, s), dtype=torch.float32),
            feat0.new_empty((b, s), dtype=torch.float32))


@torch.library.custom_op("geoformer::streaming_match_argmax",
                         mutates_args=(), device_types="cpu")
def _argmax_op(feat0: torch.Tensor, feat1: torch.Tensor,
               mask0: Optional[torch.Tensor], mask1: Optional[torch.Tensor],
               r: torch.Tensor, c: torch.Tensor, inv: float, row_off: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    return extract_argmax_plain(feat0, feat1, mask0, mask1, r, c, inv,
                                row_off)


@_argmax_op.register_kernel("cuda")
def _argmax_cuda(feat0, feat1, mask0, mask1, r, c, inv, row_off):
    _check_extract("streaming_match_argmax", feat0, feat1, mask0, mask1,
                   (r, c))
    b, l, ch = feat0.shape
    s = feat1.shape[1]
    if (r.dtype != torch.float32 or c.dtype != torch.float32
            or tuple(r.shape) != (b, l) or tuple(c.shape) != (b, s)):
        raise ValueError(f"streaming_match_argmax: r and c must be f32 "
                         f"({b}, {l}) and ({b}, {s})")
    col_part, row_part, n_split = _extract_scratch(feat0, feat1)
    dev = feat0.device
    row_best = torch.empty((b, l), dtype=torch.float32, device=dev)
    j_ids = torch.empty((b, l), dtype=torch.int64, device=dev)
    col_m = torch.empty((b, s), dtype=torch.float32, device=dev)
    col_arg = torch.empty((b, s), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _run("streaming_match_argmax",
             load_library().gam_streaming_match_argmax, feat0.data_ptr(),
             feat1.data_ptr(), _ptr(mask0), _ptr(mask1), r.data_ptr(),
             c.data_ptr(), col_part.data_ptr(), row_part.data_ptr(),
             col_m.data_ptr(), col_arg.data_ptr(), row_best.data_ptr(),
             j_ids.data_ptr(), b, l, s, ch, n_split, inv, row_off,
             torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["streaming_match_extract"] += 1
    return row_best, j_ids, col_m, col_arg


@_argmax_op.register_fake
def _argmax_fake(feat0, feat1, mask0, mask1, r, c, inv, row_off):
    b, l, _ = feat0.shape
    s = feat1.shape[1]
    return (feat0.new_empty((b, l), dtype=torch.float32),
            feat0.new_empty((b, l), dtype=torch.int64),
            feat0.new_empty((b, s), dtype=torch.float32),
            feat0.new_empty((b, s), dtype=torch.int64))


def extract_lse(feat0, feat1, mask0, mask1, inv: float):
    """K6, first op (two launches: the pass, the merge of its partials
    over the row blocks and the column splits): (r [B, L], the columns' max
    and sum of exp [B, S]) of t = feat0 feat1^T * inv with masked entries
    at the fill -1e9. mask0 [B, L], mask1 [B, S] bool or None."""
    return torch.ops.geoformer.streaming_match_lse(feat0, feat1, mask0, mask1,
                                                   inv)


def extract_argmax(feat0, feat1, mask0, mask1, r, c, inv: float,
                   row_off: int = 0):
    """K6, second op (two launches): from r and the column LSE c, (row_best
    = exp(max_j (2t - c_j) - r), j_ids its first column [B, L]; the
    columns' max of 2t - r and its first row + row_off [B, S]). One count
    in LAUNCHES["streaming_match_extract"] a call on the card."""
    return torch.ops.geoformer.streaming_match_argmax(
        feat0, feat1, mask0, mask1, r, c, inv, row_off)
