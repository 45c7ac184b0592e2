"""The GAM's attention kernels: CUDA on the card, plain torch beside them.

Counterpart of geoformer_tpu/ops/pallas_attention.py:

* K1 ``box_window_attention_fwd`` replaces ``_box_forward`` and its Pallas
  kernels ``_box_fwd_tiled_kernel`` (the default) and ``_box_fwd_kernel``
  (whole-KV, same out and LSE). Source: ``csrc/box_window_attention.cu``;
  K1 and K5 share the gather plan of ``csrc/box_plan.cuh``.
* K5 and K4 ``box_window_attention_bwd`` replace ``_box_bwd_pallas`` and
  its kernels ``_box_bwd_dq_kernel`` and ``_box_bwd_dkv_kernel``. Source:
  ``csrc/box_window_attention_bwd.cu``.
* K2 ``masked_kv_attention_fwd`` replaces ``_mka_forward`` and its Pallas
  kernel ``_mka_kernel``. Source: ``csrc/masked_kv_attention.cu``.
* K3 ``masked_kv_attention_bwd`` replaces ``_mka_bwd_pallas`` and its
  kernel ``_mka_bwd_kernel``. Source: ``csrc/masked_kv_attention_bwd.cu``.

Each kernel is a ``torch.library`` custom op in the ``geoformer``
namespace (``torch.ops.geoformer.<name>``, OPS below): its CPU
implementation is the plain version, its CUDA implementation launches the
kernel or raises (it never falls back), and a fake implementation gives the
output shapes and dtypes, so ``torch.export`` and ``torch.compile`` trace
through the kernels as single calls. The functions of this module are the
ops' Python wrappers. K1 and K2 carry their gradients
(``torch.library.register_autograd``, the counterparts of the two
``custom_vjp``s): K1's through K5 and K4 from the saved out and LSE, K2's
through K3 from the saved output and row statistics; the mask and the
centres get none. Importing this module registers the ops, and needs
nothing but torch.

Each call that launches a kernel adds one to ``LAUNCHES[name]`` (K1, K4 and
K5 launch a plan and then the pieces, one count a call), so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from geoformer_tpu_torch.ops.attention import full_attention
from geoformer_tpu_torch.ops.cuda_lib import load_library

# name -> number of kernel launches since the last reset_launch_counts()
LAUNCHES = {"box_window_attention": 0, "masked_kv_attention": 0,
            "masked_kv_attention_bwd": 0, "box_window_attention_bwd_dkv": 0,
            "box_window_attention_bwd_dq": 0}

_HEAD_DIM = 64  # the kernels' compiled head width (d_model 256 / 4 heads)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the custom ops, torch.ops.geoformer.<name>
OPS = ("box_window_attention_fwd", "box_window_attention_bwd_dq",
       "box_window_attention_bwd_dkv", "masked_kv_attention_fwd",
       "masked_kv_attention_bwd")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its accumulation type: f32 for f32 and bf16, f64 for f64."""
    return x.to(_acc_dtype(x.dtype))


def _check_cuda_inputs(name, floats, others):
    """Same device, contiguous, and (q, k, v) aligned for paired loads."""
    dev = floats[0].device
    for t in floats + others:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in floats:
        if t.dtype != floats[0].dtype:
            raise TypeError(f"{name}: q, k, v dtypes differ")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must be 16-byte aligned")
    if floats[0].dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {floats[0].dtype} not supported "
                        f"(float32 or bfloat16)")


def _contiguous(ts):
    """The ops' outputs are contiguous, as their fakes say (the plain
    versions' einsums may give other strides)."""
    return tuple(t.contiguous() for t in ts)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch error {err}")
    LAUNCHES[name] += 1


def _check_box_shapes(name, q, k, v, centers, grid_hw):
    b, l, h, d = q.shape
    s = k.shape[1]
    hd, wd = grid_hw
    if (d != _HEAD_DIM or k.shape != (b, s, h, d) or v.shape != k.shape
            or centers.shape != (b, l, 2) or s != hd * wd):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} centers {tuple(centers.shape)} grid {grid_hw} "
            f"(head dim must be {_HEAD_DIM}, S = grid_h * grid_w)")
    if centers.dtype != torch.int32:
        raise TypeError(f"{name}: centers must be int32")


def _check_mka_shapes(name, q, k, v, kv_mask):
    b, l, h, d = q.shape
    s = k.shape[1]
    if (d != _HEAD_DIM or s == 0 or k.shape != (b, s, h, d)
            or v.shape != k.shape or tuple(kv_mask.shape) != (b, s)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} mask {tuple(kv_mask.shape)} (head dim must "
            f"be {_HEAD_DIM}, S > 0)")


# ---------------------------------------------------------------- K1 -------

def _box_mask(centers, grid_hw, radius, s, device):
    """[B, L, S] box membership of every destination cell."""
    wd = grid_hw[1]
    sidx = torch.arange(s, device=device, dtype=torch.int32)
    return (((sidx % wd)[None, None, :] - centers[..., 0:1]).abs()
            <= radius) & (((sidx // wd)[None, None, :]
                           - centers[..., 1:2]).abs() <= radius)


def box_window_attention_plain(q, k, v, centers, grid_hw, radius: int = 2,
                               mask_fill: float = -1e8):
    """Box-window attention over the whole token set (materializes
    [B, L, S, H]); the counterpart of box_attention_reference, plus the LSE.

    Returns (out [B, L, H, D] in q.dtype, lse [B, L, H] in the accumulation
    type, f32 for f32 and bf16). Rows whose box misses the grid get out = 0
    and lse = scale * mask_fill + log(S)."""
    s = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    box = _box_mask(centers, grid_hw, radius, s, q.device)
    logits = torch.einsum("blhd,bshd->blsh", _acc(q), _acc(k))
    z = scale * logits.masked_fill(~box[..., None], mask_fill)
    lse = torch.logsumexp(z, dim=2)
    out = torch.einsum("blsh,bshd->blhd", torch.softmax(z, dim=2), _acc(v))
    row_ok = box.any(dim=2)
    out = torch.where(row_ok[..., None, None], out, 0.0)
    return out.to(q.dtype), lse


@torch.library.custom_op("geoformer::box_window_attention_fwd",
                         mutates_args=(), device_types="cpu")
def _box_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                centers: torch.Tensor, grid_hw: Sequence[int], radius: int,
                mask_fill: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _contiguous(box_window_attention_plain(
        q, k, v, centers, tuple(grid_hw), radius, mask_fill))


@_box_fwd_op.register_kernel("cuda")
def _box_fwd_cuda(q, k, v, centers, grid_hw, radius, mask_fill):
    grid_hw = tuple(grid_hw)
    _check_box_shapes("box_window_attention", q, k, v, centers, grid_hw)
    _check_gather_radius("box_window_attention", radius)
    _check_cuda_inputs("box_window_attention", (q, k, v), (centers,))
    b, l, h, d = q.shape
    s = k.shape[1]
    hd, wd = grid_hw
    lib = load_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, l, h), dtype=torch.float32, device=q.device)
    plan = _box_gather_scratch(b, l, grid_hw, radius, q.device)
    with torch.cuda.device(q.device):
        _launch("box_window_attention", lib.gam_box_window_attention,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), centers.data_ptr(),
                plan.data_ptr(), out.data_ptr(), lse.data_ptr(), b, l, s, h,
                hd, wd, radius, plan.numel(), 1.0 / math.sqrt(d), mask_fill,
                _DTYPES[q.dtype], _stream(q.device))
    return out, lse


@_box_fwd_op.register_fake
def _box_fwd_fake(q, k, v, centers, grid_hw, radius, mask_fill):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:3], dtype=_acc_dtype(q.dtype)))


def box_window_attention_fwd(q, k, v, centers, grid_hw, radius: int = 2,
                             mask_fill: float = -1e8
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1. Gather-free GAM cross attention: query l attends to the
    destination cells (sx, sy) with |sx - cx| <= r and |sy - cy| <= r
    around its centre. On the card one call is three launches (the two of
    the plan that box_gather_schedule mirrors, then the pieces) and one
    count in LAUNCHES; radius 1, 2 or 3 (the kernels are compiled for
    those box widths). Differentiable in q, k and v (backward K5/K4).

    Args:
        q: [B, L, H, D]; k, v: [B, S, H, D] with S = grid_hw[0] * grid_hw[1].
        centers: [B, L, 2] int32 (cx, cy) in destination cells; off-grid
            values are allowed.
    Returns:
        (out [B, L, H, D] in q.dtype, lse [B, L, H] f32; f64 for f64 on the
        CPU). The LSE gets no gradient.
    """
    return torch.ops.geoformer.box_window_attention_fwd(
        q, k, v, centers, list(grid_hw), radius, mask_fill)


# K1 and K5 sort their queries by the destination tile that holds their
# centre: tiles of BOX_TILE x BOX_TILE cells of the grid widened by r on each
# side. Each tile's list is cut into pieces of at most BOX_GATHER_PIECE
# queries; a block takes one piece and one head, with the tile's window of
# K/V rows (the tile widened by r again, <= (BOX_TILE + 2r)^2 cells) in
# shared memory (csrc/box_plan.cuh: kGatherTile, kGatherPiece). Both
# plans, K1/K5's and K4's, rank their queries in chunks of _BOX_CHUNK
# (kFillThreads).
BOX_TILE = 8
BOX_GATHER_PIECE = 128
_BOX_CHUNK = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def box_gather_tiles(grid_hw, radius: int = 2) -> Tuple[int, int]:
    """(tiles down, tiles across) of the grid widened by r on each side."""
    hg, wg = grid_hw
    return (_cdiv(hg + 2 * radius, BOX_TILE), _cdiv(wg + 2 * radius, BOX_TILE))


def box_gather_max_pieces(len_q: int, grid_hw, radius: int = 2) -> int:
    """Most pieces K1/K5 can make of one batch row, whatever the centres:
    sum_t ceil(n_t / Q) <= tiles + L / Q. It sizes their grids without
    reading the centres."""
    ty, tx = box_gather_tiles(grid_hw, radius)
    return ty * tx + _cdiv(len_q, BOX_GATHER_PIECE)


def box_gather_schedule(centers, grid_hw, radius: int = 2):
    """K1's and K5's split of the work, by torch ops on the centres' device.
    Per tile t (row-major over the widened grid's tiles): n_t, the queries
    whose centre lies in it (a query whose box misses the grid lies in
    none), and its pieces ceil(n_t / Q); and the exclusive scan of the
    pieces over each batch row's tiles, whose last column is the row's
    number of pieces. Returns (n [B, T], pieces [B, T], base [B, T + 1]),
    all int64."""
    hg, wg = grid_hw
    r = radius
    ty, tx = box_gather_tiles(grid_hw, r)
    ex = centers[..., 0].long() + r
    ey = centers[..., 1].long() + r
    ok = (ex >= 0) & (ex < wg + 2 * r) & (ey >= 0) & (ey < hg + 2 * r)
    tile = torch.where(ok, (ey // BOX_TILE) * tx + ex // BOX_TILE,
                       torch.zeros_like(ex))
    n = torch.zeros((centers.shape[0], ty * tx), dtype=torch.long,
                    device=centers.device)
    n.scatter_add_(1, tile, ok.long())
    pieces = _cdiv(n, BOX_GATHER_PIECE)
    base = torch.cat([torch.zeros_like(pieces[:, :1]), pieces.cumsum(1)], 1)
    return n, pieces, base


# the radii K1 and K5 are compiled for (box widths 3, 5, 7; the GAM's is 5)
_GATHER_RADII = (1, 2, 3)


def _check_gather_radius(name, radius):
    if radius not in _GATHER_RADII:
        raise ValueError(f"{name}: radius {radius} not compiled (the kernel "
                         f"takes {_GATHER_RADII})")


def _box_gather_scratch(b, l, grid_hw, radius, device) -> torch.Tensor:
    """int32 scratch of K1's and K5's plan, in the order the kernels carve
    it (csrc/box_plan.cuh: GatherPlan): the tiles' counts, then starts
    [B, T + 1], per-chunk tile counts [B, ceil(L / 256), T], each query's
    tile and the queries' order [B, L], piece_base [B, T + 1] and
    piece_tile [B, P], P = box_gather_max_pieces."""
    ty, tx = box_gather_tiles(grid_hw, radius)
    n_tiles = ty * tx
    n = b * (2 * (n_tiles + 1) + _cdiv(l, _BOX_CHUNK) * n_tiles + 2 * l
             + box_gather_max_pieces(l, grid_hw, radius))
    if n >= 2 ** 31:
        raise ValueError(f"box-window plan of {n} ints is too large")
    return torch.empty((n,), dtype=torch.int32, device=device)


# ------------------------------------------------------------- K4, K5 ------

def _box_bwd_dl(q, k, v, centers, lse, delta, g, grid_hw, radius):
    """(p, dl) [B, L, S, H] of K1's backward, in the accumulation type."""
    s = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, ga = _acc(q), _acc(k), _acc(v), _acc(g)
    box = _box_mask(centers, grid_hw, radius, s, q.device)[..., None]
    z = scale * torch.einsum("blhd,bshd->blsh", qa, ka) \
        - lse.to(qa.dtype)[:, :, None, :]
    p = torch.exp(z.masked_fill(~box, float("-inf")))
    dp = torch.einsum("blhd,bshd->blsh", ga, va)
    dl = p * (dp - delta.to(qa.dtype)[:, :, None, :]) * scale
    return p, dl


def box_window_attention_bwd_dq_plain(q, k, v, centers, lse, delta, g,
                                      grid_hw, radius: int = 2):
    """K5's plain version: dq = dl k (box_window_attention_bwd_plain), in
    the accumulation type."""
    _, dl = _box_bwd_dl(q, k, v, centers, lse, delta, g, grid_hw, radius)
    return torch.einsum("blsh,bshd->blhd", dl, _acc(k))


def box_window_attention_bwd_dkv_plain(q, k, v, centers, lse, delta, g,
                                       grid_hw, radius: int = 2):
    """K4's plain version: (dk, dv) = (dl^T q, p^T g), in the accumulation
    type."""
    p, dl = _box_bwd_dl(q, k, v, centers, lse, delta, g, grid_hw, radius)
    return (torch.einsum("blsh,blhd->bshd", dl, _acc(q)),
            torch.einsum("blsh,blhd->bshd", p, _acc(g)))


def _box_delta(out, g):
    """delta = rowsum(g * out) [B, L, H] in the accumulation type, a torch
    op beside the kernels, as in the JAX package."""
    return (_acc(g) * _acc(out)).sum(-1)


def box_window_attention_bwd_plain(q, k, v, centers, out, lse, g, grid_hw,
                                   radius: int = 2):
    """K1's backward by the explicit formulas of the TPU kernels K4/K5,
    from the forward's out and LSE (materializes [B, L, S, H]):

        p = exp(scale q.k - lse) on in-box cells of rows whose box meets the
        grid, 0 elsewhere; delta = rowsum(g * out);
        dl = p (g.v - delta) scale; dq = dl k; dk = dl^T q; dv = p^T g.

    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    delta = _box_delta(out, g)
    dq = box_window_attention_bwd_dq_plain(q, k, v, centers, lse, delta, g,
                                           grid_hw, radius)
    dk, dv = box_window_attention_bwd_dkv_plain(q, k, v, centers, lse, delta,
                                                g, grid_hw, radius)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _box_bwd_launch(name, fn, q, k, v, centers, gf, lse, delta, outs,
                    scratch, grid_hw, radius, ints=()):
    """Checks the inputs of K4/K5 and launches one of them; ints follow
    the radius in the kernel's arguments."""
    _check_box_shapes(name, q, k, v, centers, grid_hw)
    if gf.shape != q.shape or gf.dtype != torch.float32 or \
            lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"{name}: g must be f32 {tuple(q.shape)}, lse and "
                         f"delta f32 {tuple(q.shape[:3])}")
    _check_cuda_inputs(name, (q, k, v), (centers, gf, lse, delta))
    b, l, h, d = q.shape
    hd, wd = grid_hw
    with torch.cuda.device(q.device):
        _launch(name, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                gf.data_ptr(), centers.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), *(t.data_ptr() for t in scratch + outs),
                b, l, k.shape[1], h, hd, wd, radius, *ints,
                1.0 / math.sqrt(d),
                _DTYPES[q.dtype], _stream(q.device))


# K4 splits each key's list of contributions (the queries whose box covers
# it) into pieces of at most this many, one warp each
# (csrc/box_window_attention_bwd.cu: kPiece).
BOX_PIECE = 64


def box_dkv_max_pieces(len_q: int, len_kv: int, radius: int) -> int:
    """Most pieces K4 can make of one batch row, whatever the centres:
    sum_s max(1, ceil(n_s / C)) <= S + sum_s n_s / C <= S + (2r+1)^2 L / C.
    It sizes K4's grid and scratch without reading the centres."""
    return len_kv + _cdiv((2 * radius + 1) ** 2 * len_q, BOX_PIECE)


def box_dkv_schedule(centers, grid_hw, radius: int = 2):
    """K4's split of the work, by torch ops on the centres' device. Per key
    s: n_s, the number of queries whose box covers it, and its pieces
    P_s = max(1, ceil(n_s / C)); and the exclusive scan of P_s over each
    batch row's keys, whose last column is the row's number of pieces.
    Returns (n [B, S], pieces [B, S], base [B, S + 1]), all int64."""
    hg, wg = grid_hw
    r, w = radius, 2 * radius + 1
    b = centers.shape[0]
    ew, eh = wg + 2 * r, hg + 2 * r
    # bucket of each centre on the grid widened by r on each side
    ex = centers[..., 0].long() + r
    ey = centers[..., 1].long() + r
    ok = (ex >= 0) & (ex < ew) & (ey >= 0) & (ey < eh)
    bk = torch.where(ok, ey * ew + ex, torch.zeros_like(ex))
    counts = torch.zeros((b, eh * ew), dtype=torch.long,
                         device=centers.device)
    counts.scatter_add_(1, bk, ok.long())
    # key (sy, sx) sums the buckets of rows sy..sy+2r, columns sx..sx+2r
    cs = torch.zeros((b, eh + 1, ew + 1), dtype=torch.long,
                     device=centers.device)
    cs[:, 1:, 1:] = counts.view(b, eh, ew).cumsum(1).cumsum(2)
    n = (cs[:, w:, w:] - cs[:, :-w, w:] - cs[:, w:, :-w]
         + cs[:, :-w, :-w]).reshape(b, hg * wg)
    pieces = torch.clamp(_cdiv(n, BOX_PIECE), min=1)
    base = torch.cat([torch.zeros_like(pieces[:, :1]), pieces.cumsum(1)], 1)
    return n, pieces, base


@torch.library.custom_op("geoformer::box_window_attention_bwd_dq",
                         mutates_args=(), device_types="cpu")
def _box_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               centers: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
               g: torch.Tensor, grid_hw: Sequence[int],
               radius: int) -> torch.Tensor:
    return box_window_attention_bwd_dq_plain(
        q, k, v, centers, lse, delta, g, tuple(grid_hw), radius).contiguous()


@_box_dq_op.register_kernel("cuda")
def _box_dq_cuda(q, k, v, centers, lse, delta, g, grid_hw, radius):
    grid_hw = tuple(grid_hw)
    _check_gather_radius("box_window_attention_bwd_dq", radius)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    plan = _box_gather_scratch(q.shape[0], q.shape[1], grid_hw, radius,
                               q.device)
    _box_bwd_launch("box_window_attention_bwd_dq",
                    load_library().gam_box_window_attention_bwd_dq, q, k, v,
                    centers, g, lse, delta, [dq], [plan], grid_hw, radius,
                    ints=(plan.numel(),))
    return dq


@_box_dq_op.register_fake
def _box_dq_fake(q, k, v, centers, lse, delta, g, grid_hw, radius):
    return q.new_empty(q.shape, dtype=_acc_dtype(q.dtype))


def box_window_attention_bwd_dq(q, k, v, centers, lse, delta, gf, grid_hw,
                                radius: int = 2) -> torch.Tensor:
    """K5: dq [B, L, H, D] of box-window attention from the forward's LSE,
    delta = rowsum(g * out) and the output gradient gf, in the accumulation
    type (on the card: all f32 but q, k, v, contiguous). Three launches, as
    K1's: the plan of box_gather_schedule into its own int32 scratch, then
    the pieces."""
    return torch.ops.geoformer.box_window_attention_bwd_dq(
        q, k, v, centers, lse, delta, gf, list(grid_hw), radius)


@torch.library.custom_op("geoformer::box_window_attention_bwd_dkv",
                         mutates_args=(), device_types="cpu")
def _box_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                centers: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                g: torch.Tensor, grid_hw: Sequence[int],
                radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _contiguous(box_window_attention_bwd_dkv_plain(
        q, k, v, centers, lse, delta, g, tuple(grid_hw), radius))


@_box_dkv_op.register_kernel("cuda")
def _box_dkv_cuda(q, k, v, centers, lse, delta, g, grid_hw, radius):
    grid_hw = tuple(grid_hw)
    b, l = q.shape[:2]
    s, h = k.shape[1:3]
    hd, wd = grid_hw
    n_buckets = (hd + 2 * radius) * (wd + 2 * radius)
    pieces = box_dkv_max_pieces(l, s, radius)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    i32 = dict(dtype=torch.int32, device=q.device)
    scratch = [
        torch.empty((b, n_buckets + 1), **i32),
        torch.empty((b, _cdiv(l, _BOX_CHUNK), n_buckets), **i32),
        torch.empty((b, l), **i32), torch.empty((b, l), **i32),
        torch.empty((b, s + 1), **i32), torch.empty((b, pieces), **i32),
        torch.empty((b, pieces, h, 2, q.shape[3]), dtype=torch.float32,
                    device=q.device)]
    _box_bwd_launch("box_window_attention_bwd_dkv",
                    load_library().gam_box_window_attention_bwd_dkv, q, k, v,
                    centers, g, lse, delta, [dk, dv], scratch, grid_hw,
                    radius, ints=(pieces,))
    return dk, dv


@_box_dkv_op.register_fake
def _box_dkv_fake(q, k, v, centers, lse, delta, g, grid_hw, radius):
    dtype = _acc_dtype(q.dtype)
    return k.new_empty(k.shape, dtype=dtype), k.new_empty(k.shape,
                                                          dtype=dtype)


def box_window_attention_bwd_dkv(q, k, v, centers, lse, delta, gf, grid_hw,
                                 radius: int = 2):
    """K4: (dk, dv) [B, S, H, D] of box-window attention in the
    accumulation type, inputs as box_window_attention_bwd_dq. Scratch on
    the card, sized without reading the centres (P = box_dkv_max_pieces(L,
    S, r), n = (Hg + 2r)(Wg + 2r) buckets of centre cells): the plan of the
    work (int32 bucket starts [B, n + 1], per-chunk bucket counts [B,
    ceil(L / 256), n], each query's bucket and the queries' order [B, L],
    piece_base [B, S + 1], piece_key [B, P]) and the pieces' partial sums
    (f32 [B, P, H, 2, D])."""
    return torch.ops.geoformer.box_window_attention_bwd_dkv(
        q, k, v, centers, lse, delta, gf, list(grid_hw), radius)


def box_window_attention_bwd(q, k, v, centers, out, lse, g, grid_hw,
                             radius: int = 2):
    """K5 (dq) and K4 (dk/dv): the backward of box_window_attention_fwd
    from its out and LSE, with delta = rowsum(g * out) computed by torch.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    ga = _acc(g).contiguous()
    lse = lse.to(ga.dtype).contiguous()
    delta = _box_delta(out, g).contiguous()
    dq = box_window_attention_bwd_dq(q, k, v, centers, lse, delta, ga,
                                     grid_hw, radius)
    dk, dv = box_window_attention_bwd_dkv(q, k, v, centers, lse, delta, ga,
                                          grid_hw, radius)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _box_fwd_setup(ctx, inputs, output):
    q, k, v, centers, grid_hw, radius, _ = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, centers, out, lse)
    ctx.grid_hw, ctx.radius = tuple(grid_hw), radius
    ctx.mark_non_differentiable(lse)


def _box_fwd_backward(ctx, g, _g_lse):
    q, k, v, centers, out, lse = ctx.saved_tensors
    dq, dk, dv = box_window_attention_bwd(q, k, v, centers, out, lse, g,
                                          ctx.grid_hw, ctx.radius)
    return dq, dk, dv, None, None, None, None


# counterpart of the custom_vjp of box_window_attention
# (pallas_attention.py:499,613,686-704)
torch.library.register_autograd("geoformer::box_window_attention_fwd",
                                _box_fwd_backward,
                                setup_context=_box_fwd_setup)


# ---------------------------------------------------------------- K2 -------

# The kernels skip key tiles with no kept key, which is exact while a masked
# logit's weight exp(scale * mask_fill - m) underflows to 0 next to every
# row's largest kept logit m; this bound keeps that so for |q.k| < ~8e3.
_MAX_MKA_FILL = -1e4
_MKA_TILE = 64  # queries or keys a tile of K2/K3 (csrc/gam_mma.cuh: kTile)


def _check_fill(name, mask_fill):
    if mask_fill > _MAX_MKA_FILL:
        raise ValueError(f"{name}: mask_fill {mask_fill} > {_MAX_MKA_FILL}; "
                         f"the kernel skips masked key tiles, exact only "
                         f"where masked weights underflow to 0")


def _mka_logits(q, k, kv_mask, mask_fill):
    """(z [B, L, S, H], keep [B, 1, S, 1]): scale * q.k with masked keys set
    to mask_fill before scaling, in the accumulation type."""
    keep = kv_mask[:, None, :, None].to(torch.bool)
    z = torch.einsum("blhd,bshd->blsh", _acc(q), _acc(k)).masked_fill(
        ~keep, mask_fill)
    return (1.0 / math.sqrt(q.shape[-1])) * z, keep


def _mka_stats(q, k, kv_mask, mask_fill):
    """[2, B, L, H]: each row's max m of the masked, scaled logits and its
    log-denominator log(sum(exp(z - m))), in the accumulation type."""
    z, _ = _mka_logits(q, k, kv_mask, mask_fill)
    m = z.amax(dim=2)
    logd = torch.log(torch.exp(z - m[:, :, None]).sum(dim=2))
    return torch.stack([m, logd])


def masked_kv_attention_plain(q, k, v, kv_mask, mask_fill: float = -1e8,
                              return_stats: bool = False):
    """full_attention with a column mask, computed in f32 (f64 for f64) as
    the kernel contract has it (the TPU kernel accumulates in f32 and returns
    f32). With return_stats, also the rows' statistics ([2, B, L, H]: max
    and log-denominator of the masked logits) that the backward takes."""
    out = full_attention(_acc(q), _acc(k), _acc(v), kv_mask=kv_mask,
                         mask_fill=mask_fill)
    if not return_stats:
        return out
    return out, _mka_stats(q, k, kv_mask, mask_fill)


@torch.library.custom_op("geoformer::masked_kv_attention_fwd",
                         mutates_args=(), device_types="cpu")
def _mka_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_mask: torch.Tensor, mask_fill: float,
                return_stats: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if not return_stats:
        out = masked_kv_attention_plain(q, k, v, kv_mask, mask_fill)
        return out.contiguous(), out.new_empty((0,))
    return _contiguous(masked_kv_attention_plain(q, k, v, kv_mask, mask_fill,
                                                 True))


@_mka_fwd_op.register_kernel("cuda")
def _mka_fwd_cuda(q, k, v, kv_mask, mask_fill, return_stats):
    _check_mka_shapes("masked_kv_attention", q, k, v, kv_mask)
    _check_fill("masked_kv_attention", mask_fill)
    b, l, h, d = q.shape
    s = k.shape[1]
    mask = kv_mask.to(torch.bool).contiguous()
    _check_cuda_inputs("masked_kv_attention", (q, k, v), (mask,))
    lib = load_library()
    out = torch.empty((b, l, h, d), dtype=torch.float32, device=q.device)
    stats = torch.empty((2, b, l, h) if return_stats else (0,),
                        dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("masked_kv_attention", lib.gam_masked_kv_attention,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(),
                stats[0].data_ptr() if return_stats else None,
                stats[1].data_ptr() if return_stats else None,
                b, l, s, h, 1.0 / math.sqrt(d), mask_fill,
                _DTYPES[q.dtype], _stream(q.device))
    return out, stats


@_mka_fwd_op.register_fake
def _mka_fwd_fake(q, k, v, kv_mask, mask_fill, return_stats):
    dtype = _acc_dtype(q.dtype)
    stats = (2,) + tuple(q.shape[:3]) if return_stats else (0,)
    return q.new_empty(q.shape, dtype=dtype), q.new_empty(stats, dtype=dtype)


def masked_kv_attention_fwd(q, k, v, kv_mask, mask_fill: float = -1e8,
                            return_stats: bool = False):
    """K2. Masked-KV softmax attention. q: [B, L, H, D]; k, v: [B, S, H, D];
    kv_mask: [B, S] (true keeps the column). Returns f32 [B, L, H, D] (f64
    for f64 on the CPU); a batch row whose mask is all false gets the mean
    of its S value rows. With return_stats, returns (out, stats) where
    stats [2, B, L, H] f32 holds each row's max and log-denominator of the
    masked logits (for a row with no kept key, scale * mask_fill and log
    S). Differentiable in q, k and v (backward K3, from the statistics when
    the forward kept them)."""
    out, stats = torch.ops.geoformer.masked_kv_attention_fwd(
        q, k, v, kv_mask, mask_fill, return_stats)
    return (out, stats) if return_stats else out


# ---------------------------------------------------------------- K3 -------

def masked_kv_attention_bwd_plain(q, k, v, kv_mask, g,
                                  mask_fill: float = -1e8, out=None,
                                  stats=None):
    """The counterpart of _mka_bwd_jnp (pallas_attention.py:194-209),
    computed in f32 (f64 for f64) from the forward's output and row
    statistics (masked_kv_attention_plain's when not given), by the
    kernel's formulas: attn = exp((z - m) - logd), dot = rowsum(g * out).
    Materializes [B, L, S, H]. Returns (dq, dk, dv) in the dtypes of q, k,
    v."""
    if out is None or stats is None:
        out, stats = masked_kv_attention_plain(q, k, v, kv_mask, mask_fill,
                                               return_stats=True)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, ga = _acc(q), _acc(k), _acc(v), _acc(g)
    stats = stats.to(qa.dtype)
    z, keep = _mka_logits(q, k, kv_mask, mask_fill)
    attn = torch.exp((z - stats[0][:, :, None]) - stats[1][:, :, None])
    dv = torch.einsum("blsh,blhd->bshd", attn, ga)
    d_attn = torch.einsum("blhd,bshd->blsh", ga, va)
    dot = (ga * _acc(out).to(qa.dtype)).sum(-1)[:, :, None]
    dl = (attn * (d_attn - dot) * scale).masked_fill(~keep, 0.0)
    dq = torch.einsum("blsh,bshd->blhd", dl, ka)
    dk = torch.einsum("blsh,blhd->bshd", dl, qa)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op("geoformer::masked_kv_attention_bwd",
                         mutates_args=(), device_types="cpu")
def _mka_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_mask: torch.Tensor, g: torch.Tensor, mask_fill: float,
                out: torch.Tensor, stats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _contiguous(masked_kv_attention_bwd_plain(q, k, v, kv_mask, g,
                                                     mask_fill, out, stats))


@_mka_bwd_op.register_kernel("cuda")
def _mka_bwd_cuda(q, k, v, kv_mask, g, mask_fill, out, stats):
    _check_mka_shapes("masked_kv_attention_bwd", q, k, v, kv_mask)
    _check_fill("masked_kv_attention_bwd", mask_fill)
    b, l, h, d = q.shape
    s = k.shape[1]
    gf = g.float().contiguous()
    out = out.float().contiguous()
    stats = stats.float().contiguous()
    if gf.shape != q.shape or out.shape != q.shape or \
            stats.shape != (2, b, l, h):
        raise ValueError(f"masked_kv_attention_bwd: g and out must be "
                         f"{tuple(q.shape)}, stats (2, {b}, {l}, {h})")
    mask = kv_mask.to(torch.bool).contiguous()
    _check_cuda_inputs("masked_kv_attention_bwd", (q, k, v),
                       (mask, gf, out, stats))
    lib = load_library()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dot = torch.empty((b, l, h), dtype=torch.float32, device=q.device)
    # the dk/dv pass has one CTA per (batch, head, key tile, chunk of the
    # queries): enough chunks for ~4 CTAs per SM, summed in a fixed order
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_chunks = min(_cdiv(l, _MKA_TILE),
                   _cdiv(4 * sms, _cdiv(s, _MKA_TILE) * b * h))
    part = (torch.empty((n_chunks, 2) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if n_chunks > 1 else None)
    with torch.cuda.device(q.device):
        _launch("masked_kv_attention_bwd", lib.gam_masked_kv_attention_bwd,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                gf.data_ptr(), out.data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr(), dot.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(),
                part.data_ptr() if part is not None else None, n_chunks,
                b, l, s, h,
                1.0 / math.sqrt(d), mask_fill, _DTYPES[q.dtype],
                _stream(q.device))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@_mka_bwd_op.register_fake
def _mka_bwd_fake(q, k, v, kv_mask, g, mask_fill, out, stats):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def masked_kv_attention_bwd(q, k, v, kv_mask, g, mask_fill: float = -1e8,
                            out=None, stats=None):
    """K3: the backward of masked_kv_attention_fwd for the output gradient
    g [B, L, H, D], from the forward's output and row statistics
    (masked_kv_attention_fwd(..., return_stats=True)); without them it
    runs that forward first. Returns (dq, dk, dv) in the dtypes of q, k, v;
    a row whose mask is all false gets dv = colsum(g) / S and dq = dk = 0."""
    if out is None or stats is None:
        out, stats = masked_kv_attention_fwd(q, k, v, kv_mask, mask_fill,
                                             return_stats=True)
    return torch.ops.geoformer.masked_kv_attention_bwd(
        q, k, v, kv_mask, g, mask_fill, out, stats)


def _mka_fwd_setup(ctx, inputs, output):
    q, k, v, kv_mask, mask_fill, _ = inputs
    out, stats = output
    ctx.save_for_backward(q, k, v, kv_mask, out, stats)
    ctx.mask_fill = mask_fill
    ctx.mark_non_differentiable(stats)


def _mka_fwd_backward(ctx, g, _g_stats):
    q, k, v, kv_mask, out, stats = ctx.saved_tensors
    dq, dk, dv = masked_kv_attention_bwd(
        q, k, v, kv_mask, g, ctx.mask_fill, out,
        stats if stats.numel() else None)
    return dq, dk, dv, None, None, None


# counterpart of the custom_vjp of masked_kv_attention
# (pallas_attention.py:52,106,212-229)
torch.library.register_autograd("geoformer::masked_kv_attention_fwd",
                                _mka_fwd_backward,
                                setup_context=_mka_fwd_setup)


def masked_kv_attention(q, k, v, kv_mask, mask_fill: float = -1e8
                        ) -> torch.Tensor:
    """The GAM self layers' entry: masked_kv_attention_fwd (K2, backward
    K3), keeping the row statistics only when a gradient can flow."""
    need_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    out = masked_kv_attention_fwd(q, k, v, kv_mask, mask_fill,
                                  return_stats=need_grad)
    return out[0] if need_grad else out
