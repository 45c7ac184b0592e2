"""Sequence parallelism: one pair's image rows split over a group of ranks.

Counterpart of geoformer_tpu/core/spmd.py. The JAX package shards a
pair's rows and tokens over a mesh axis and lets GSPMD insert the halo
exchanges and the sums; the port runs one process per rank
(core/mesh.seq_groups) and writes each exchange here:

- each rank of a seq group holds a contiguous band of the image rows,
  a whole number of coarse rows (``row_band``), so its coarse tokens are a
  contiguous range of the row-major token order too;
- ``halo_rows`` gives a convolution its neighbours' rows at the band's
  edges (zeros at the image's true top and bottom);
- ``gather`` concatenates the bands (its backward sums the ranks'
  gradients of this rank's slice), ``seq_sum`` sums over the group (its
  backward sums the ranks' gradients), ``seq_max``/``seq_min`` reduce
  without gradient, and ``broadcast_from_first`` hands every rank the
  first rank's tensors.

The gradients follow the data-parallel convention of train/trainer.py:
each rank's loss is its share of the global loss, every collective's
backward sums the ranks' cotangents, and the parameters' gradients are
summed over the world once after the backward. Without a seq split every
function here is the identity.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from geoformer_tpu_torch.core import mesh


def active() -> bool:
    """True when a seq split of more than one rank is set up."""
    return mesh.seq_world() > 1


def row_band(total: int, what: str = "rows") -> slice:
    """This rank's contiguous band of ``total`` rows (all of them without a
    split); ValueError unless the seq group's size divides ``total``."""
    n = mesh.seq_world()
    if total % n:
        raise ValueError(f"{total} {what} do not split into {n} equal "
                         f"bands")
    per = total // n
    r = mesh.seq_rank()
    return slice(r * per, (r + 1) * per)


def _group():
    return mesh.layout().seq_group


def _all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` of every rank of the seq group, in seq-rank order, on x's
    device (through host memory under gloo, mesh.comm_device)."""
    t = x.detach().contiguous().to(mesh.comm_device())
    flat = t.view(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(flat) for _ in range(mesh.seq_world())]
    dist.all_gather(parts, flat, group=_group())
    if t.dtype == torch.bool:
        parts = [p.view(torch.bool) for p in parts]
    return [p.to(x.device) for p in parts]


def _all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the seq group, a new tensor on x's device (the
    reduction itself on mesh.comm_device)."""
    y = x.detach().to(mesh.comm_device(), copy=True).contiguous()
    dist.all_reduce(y, op=op, group=_group())
    return y.to(x.device)


class _Halo(torch.autograd.Function):
    """Rows ``above`` from the rank before, ``below`` from the rank after,
    zeros at the ends; backward returns each halo's gradient to the rank
    that owns its rows."""

    @staticmethod
    def forward(ctx, x, above: int, below: int, dim: int):
        n, r, h = mesh.seq_world(), mesh.seq_rank(), x.shape[dim]
        if above > h or below > h:
            raise ValueError(f"a halo of {above}/{below} rows is deeper "
                             f"than the band of {h}")
        ctx.args = (above, below, dim, h)
        edges = torch.cat([x.narrow(dim, 0, below),
                           x.narrow(dim, h - above, above)], dim)
        parts = _all_gather(edges)
        zeros = lambda k: x.new_zeros(  # noqa: E731
            x.shape[:dim] + (k,) + x.shape[dim + 1:])
        top = parts[r - 1].narrow(dim, below, above) if r > 0 \
            else zeros(above)
        bot = parts[r + 1].narrow(dim, 0, below) if r < n - 1 \
            else zeros(below)
        return torch.cat([top, x, bot], dim)

    @staticmethod
    def backward(ctx, g):
        above, below, dim, h = ctx.args
        n, r = mesh.seq_world(), mesh.seq_rank()
        parts = _all_gather(torch.cat([g.narrow(dim, 0, above),
                                       g.narrow(dim, above + h, below)], dim))
        gx = g.narrow(dim, above, h).clone()
        if r < n - 1:       # my last rows were the next rank's top halo
            gx.narrow(dim, h - above, above).add_(
                parts[r + 1].narrow(dim, 0, above))
        if r > 0:           # my first rows were the previous rank's bottom
            gx.narrow(dim, 0, below).add_(parts[r - 1].narrow(dim, above,
                                                              below))
        return gx, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int,
              dim: int = 2) -> torch.Tensor:
    """This rank's band of ``x`` (rows on ``dim``) widened by ``above``
    rows of the previous rank's band and ``below`` of the next rank's,
    zeros beyond the image; differentiable. Without a split: zero rows on
    both sides (the convolution's own padding)."""
    if not active():
        pad = [0, 0] * (x.dim() - 1 - dim) + [above, below]
        return torch.nn.functional.pad(x, pad)
    return _Halo.apply(x, above, below, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.args = (dim, x.shape[dim])
        return torch.cat(_all_gather(x), dim)

    @staticmethod
    def backward(ctx, g):
        dim, h = ctx.args
        return _all_reduce(g).narrow(dim, mesh.seq_rank() * h, h), None


def gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The seq group's bands of ``x`` concatenated on ``dim`` in rank
    order (all bands one size); differentiable, the backward summing the
    ranks' gradients of this rank's slice. ``x`` without a split."""
    return _Gather.apply(x, dim) if active() else x


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the seq group, differentiably (the backward sums
    the ranks' gradients); ``x`` without a split."""
    return _Sum.apply(x) if active() else x


def seq_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the seq group, without gradient."""
    return _all_reduce(x, dist.ReduceOp.MAX) if active() else x


def seq_min(x: torch.Tensor) -> torch.Tensor:
    """Elementwise min over the seq group, without gradient."""
    return _all_reduce(x, dist.ReduceOp.MIN) if active() else x


def broadcast_from_first(tensors: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """The seq group's first rank's ``tensors`` on every rank of it, on
    each tensor's device, without gradient (``tensors`` without a
    split)."""
    if not active():
        return list(tensors)
    first = mesh.data_rank() * mesh.seq_world()   # its global rank
    out = []
    for x in tensors:
        t = x.detach().contiguous().to(mesh.comm_device()).clone()
        flat = t.view(torch.uint8) if t.dtype == torch.bool else t
        dist.broadcast(flat, src=first, group=_group())
        out.append(t.to(x.device))
    return out
