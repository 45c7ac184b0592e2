"""Process-group helpers for data parallelism on torch.distributed.

Counterpart of geoformer_tpu/core/mesh.py. The JAX package lays a mesh over
its devices, shards the batch on it and lets GSPMD sum the gradients; the
port runs one process per rank and sums with collectives
(train/trainer.py). There is no mesh object: without a process group every
function here answers for world size 1, and a collective is the identity.

A group comes from torchrun's environment (``process_group_from_env``,
what ``cli train`` and ``cli train-depth`` use) or from ``launch``, which
spawns the ranks of one machine itself. The backend is stated, never
guessed: NCCL for CUDA devices, gloo for the CPU, or gloo on CUDA tensors
when the caller asks for it (two ranks on one card, which NCCL refuses).
gloo all-reduces CUDA tensors itself; what it gathers goes through host
memory (``comm_device``).

Sequence parallelism (core/spmd.py) splits the world into ``world / seq``
data replicas of ``seq`` ranks each, rank = data_rank * seq + seq_rank
(``seq_groups``): the ranks of a seq group share one pair's image rows, the
ranks of a data group hold the same rows of different pairs. Without that
split seq_world() is 1 and the data group is the world.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# how long a rank waits in a collective for its peers before it fails
TIMEOUT_S = 300


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


@dataclasses.dataclass(frozen=True)
class SeqLayout:
    """A (data x seq) split of the world: ``data`` replicas of ``seq``
    ranks; this rank's seq group and data group."""

    seq: int
    data: int
    seq_group: object
    data_group: object


_LAYOUT: Optional[SeqLayout] = None


def layout() -> Optional[SeqLayout]:
    """The split that seq_groups set up, or None."""
    return _LAYOUT


def seq_world() -> int:
    """Ranks that share one pair's rows (1 without a split)."""
    return _LAYOUT.seq if _LAYOUT is not None else 1


def seq_rank() -> int:
    return rank() % seq_world()


def data_world() -> int:
    """Data-parallel replicas: the world without a split."""
    return world() // seq_world()


def data_rank() -> int:
    return rank() // seq_world()


@contextlib.contextmanager
def seq_groups(seq: int):
    """Split the world into world / seq replicas of ``seq`` ranks (every
    rank of the group calls it: dist.new_group is collective) and yield
    the SeqLayout, which seq_world and the rest answer from until the end
    of the block. ValueError unless ``seq`` divides the world."""
    global _LAYOUT
    w = world()
    if seq < 1 or w % seq:
        raise ValueError(f"a seq split of {seq} ranks does not divide the "
                         f"world of {w}")
    if _LAYOUT is not None:
        raise RuntimeError("a seq split is already set up")
    groups = {}
    for d in range(w // seq):
        ranks = [d * seq + s for s in range(seq)]
        groups[("seq", d)] = dist.new_group(ranks) if w > 1 else None
    for s in range(seq):
        ranks = [d * seq + s for d in range(w // seq)]
        groups[("data", s)] = dist.new_group(ranks) if w > 1 else None
    _LAYOUT = SeqLayout(seq, w // seq, groups[("seq", rank() // seq)],
                        groups[("data", rank() % seq)])
    try:
        yield _LAYOUT
    finally:
        _LAYOUT = None
        for g in groups.values():
            if g is not None:
                dist.destroy_process_group(g)


def local_shard_slice(total: int) -> slice:
    """This rank's slice of a global batch of ``total``: the JAX package's
    per-process arithmetic (floor of total / data replicas), by data rank
    (by rank without a seq split)."""
    per = total // data_world()
    i = data_rank()
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's slice (local_shard_slice) of every array of a global
    batch, along the leading axis."""
    return {k: v[local_shard_slice(v.shape[0])] for k, v in batch.items()}


def comm_device() -> torch.device:
    """Where a gathered array travels: the host under gloo (which gathers
    host tensors), the rank's card under NCCL (which gathers only those)."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def process_group_from_env(device="cuda"):
    """Under torchrun (RANK, WORLD_SIZE, LOCAL_RANK and the rendezvous in
    the environment): start this rank's group, NCCL on ``cuda:LOCAL_RANK``
    or gloo for ``device="cpu"``, yield the rank's device and destroy the
    group at the end. Without those variables: yield ``device``, world
    size 1."""
    if "WORLD_SIZE" not in os.environ:
        yield torch.device(device)
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        dist.barrier()       # every rank is up (and NCCL's communicator)
        yield dev
    finally:
        dist.destroy_process_group()


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, without gradient (a new tensor; ``x``
    itself at world size 1)."""
    if world() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


class _AllSum(torch.autograd.Function):
    """Sum over the ranks whose backward is the sum over the ranks of the
    incoming gradients (d/dx_r of sum_r' L_r' with y = sum_r x_r)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably; ``x`` at world size 1."""
    return x if world() == 1 else _AllSum.apply(x)


def all_sum_flat(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, in one all-reduce of their
    concatenation (one dtype); new tensors, without gradient."""
    if world() == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _rank_main(fn, rank_, world_, init_file, backend, threads, args, out):
    torch.set_num_threads(threads)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank_)   # NCCL: one card a rank
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank_,
            world_size=world_,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out.put((rank_, True, fn(rank_, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank_, False, traceback.format_exc()))
        raise


def _stalled(procs, results, deadline, out):
    """After a wait with no result: None to wait on, a (rank, ok, value)
    that a rank sent just before it exited, or the failure's text (a rank
    exited without a result, or the time ran out)."""
    dead = {r: p.exitcode for r, p in enumerate(procs)
            if p.exitcode is not None and r not in results}
    if dead:
        try:      # its result may still be on its way through the pipe
            return out.get(timeout=5.0)
        except queue.Empty:
            return f"ranks exited without a result (rank: code): {dead}"
    if time.monotonic() > deadline:
        missing = sorted(set(range(len(procs))) - set(results))
        return f"no result from ranks {missing} in time"
    return None


def launch(fn: Callable, world_size: int, args: tuple = (),
           backend: str = "gloo", timeout: float = 600.0,
           threads: int = 1, init_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes of one
    group (``backend``; file rendezvous in a fresh directory under
    ``init_dir``, else the temporary directory), each on ``threads`` torch
    threads (under NCCL rank r on cuda:r), and return their results by
    rank. ``fn`` and its arguments and result are pickled: a module-level
    function, host data. A rank that raises, or a run longer than
    ``timeout`` seconds, stops every rank and raises RuntimeError with the
    failing rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=init_dir) as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, os.path.join(tmp, "rendezvous"), backend,
            threads, args, out)) for r in range(world_size)]
        for p in procs:
            p.start()
        results, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world_size:
                try:
                    msg = out.get(timeout=1.0)
                except queue.Empty:
                    msg = _stalled(procs, results, deadline, out)
                    if msg is None:
                        continue
                    if isinstance(msg, str):
                        failure = msg
                        break
                r, ok, value = msg
                if not ok:
                    failure = f"rank {r} failed:\n{value}"
                    break
                results[r] = value
        finally:
            for p in procs:
                if failure is None:
                    p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.terminate()
                    p.join()
        if failure is not None:
            raise RuntimeError(failure)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
    return [results[r] for r in range(world_size)]
