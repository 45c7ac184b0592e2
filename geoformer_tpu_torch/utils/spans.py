"""Named spans of the program's work, and its one counter: host syncs.

``span(name)`` brackets a part of the work. Where a torch profiler is
active it opens a ``torch.profiler.record_function`` range of that name,
so every profiler trace shows it; inside ``recording()`` it also keeps one
record in memory: the name, start and end on a monotonic clock, the
record of the innermost span open on the same thread (its parent), the
thread, and the id of the call or step it belongs to (the outermost span
open on the thread starts a new id; those within it share it). Outside a
recording and a profiler a span does nothing: it checks one flag and the
profiler's state, and allocates nothing.

``recording(syncs=False)`` turns the records on for its block and yields
a ``Recording``; ``count(name, n)`` adds to a counter under the innermost
open span. With ``syncs`` every host-device synchronisation that torch's
sync debug mode reports (``.cpu()``, ``.item()``, pageable copies,
``nonzero``, stream syncs; not an explicit ``torch.cuda.synchronize()``)
is counted as ``SYNC`` under the innermost span open where it happened.
A sync reaches the count through Python's warnings, on any thread that
raises it from Python: the caller's, and autograd's worker thread in the
backward of a Python ``autograd.Function`` (there, with no span open on
that thread, it goes under the innermost span of the thread that started
the recording). A sync inside a C++ autograd node on the worker thread
has no Python warning handler; torch prints it and it is not counted.

The records' times map onto the Unix-epoch nanoseconds of the profiler's
events (kineto's, host and device alike) through two anchor pairs of the
monotonic clock against ``time.time_ns()``, one at each end of the
recording (``Recording.unix_ns``).

    with spans.recording(syncs=True) as rec:
        model(...)
    rec.spans                    # [Span], in the order they opened
    rec.totals(spans.SYNC)       # {innermost span's name: syncs}
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

SYNC = "host_syncs"
# the message of torch's sync debug mode (c10/cuda/CUDAFunctions.h)
SYNC_WARNING = "called a synchronizing CUDA operation"

clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_active: Optional["Recording"] = None


class Span(NamedTuple):
    name: str
    start_ns: int          # on ``clock``
    end_ns: int
    parent: int            # index of the enclosing record, -1 for none
    thread: int            # threading.get_ident() of the thread
    group: int             # id of the call or step (the outermost span)


def _anchor():
    """(monotonic ns, Unix ns) taken together: the Unix reading between
    two monotonic ones."""
    a = clock()
    u = time.time_ns()
    return (a + clock()) // 2, u


class Recording:
    """The spans and counters of one ``recording()`` block."""

    def __init__(self):
        self._raw: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._local.stack = self._main = []
        self._groups = 0
        self.counts: Dict[tuple, int] = {}
        self.spans: List[Span] = []
        self._anchors = [_anchor()]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, t: int):
        stack = self._stack()
        with self._lock:
            if stack:
                parent = stack[-1]
                group = self._raw[parent][5]
            else:
                parent, group = -1, self._groups
                self._groups += 1
            idx = len(self._raw)
            self._raw.append([name, t, 0, parent, threading.get_ident(),
                              group])
        stack.append(idx)
        return idx

    def _close(self, idx: int, t: int) -> None:
        self._raw[idx][2] = t
        self._stack().pop()

    def add(self, name: str, n: int = 1) -> None:
        stack = self._stack() or self._main
        key = (name, stack[-1] if stack else -1)
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + n

    def _finish(self) -> None:
        self._anchors.append(_anchor())
        self.spans = [Span(*r) for r in self._raw]

    def unix_ns(self, t: int) -> float:
        """A time on ``clock`` in Unix-epoch ns (the profiler's axis)."""
        (a0, u0), (a1, u1) = self._anchors[0], self._anchors[-1]
        slope = (u1 - u0) / (a1 - a0) if a1 > a0 else 1.0
        return u0 + (t - a0) * slope

    def totals(self, name: str) -> Dict[Optional[str], int]:
        """The counter ``name`` by the name of the innermost span it was
        counted under (None: outside every span)."""
        out: Dict[Optional[str], int] = {}
        for (counter, idx), n in self.counts.items():
            if counter == name:
                key = self.spans[idx].name if idx >= 0 else None
                out[key] = out.get(key, 0) + n
        return out


class _Span:
    __slots__ = ("rec", "name", "idx", "rf")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name, self.rf = rec, name, None

    # each end is the midpoint of the clock read before and after the
    # range's own enter (exit), inside which the profiler stamps the range
    def __enter__(self):
        t = clock()
        if _profiling():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.idx = self.rec._open(self.name, (t + clock()) // 2)
        return self

    def __exit__(self, *exc):
        t = clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._close(self.idx, (t + clock()) // 2)
        return False


def span(name: str):
    """A context that brackets one part of the program's work (see the
    module's docstring)."""
    rec = _active
    if rec is not None:
        return _Span(rec, name)
    return record_function(name) if _profiling() else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` under the innermost open span,
    inside a recording; nothing otherwise."""
    rec = _active
    if rec is not None:
        rec.add(name, n)


@contextlib.contextmanager
def _counting_syncs():
    """Every sync that torch's sync debug mode reports, counted as SYNC,
    its warning not shown; the mode, the filters and the hook restored on
    exit."""
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                count(SYNC)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = hook
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def recording(syncs: bool = False):
    """Record spans (and, with ``syncs``, count host syncs) inside the
    block; yields the ``Recording``, whose ``spans`` are filled when the
    block ends. Recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already on")
    rec = Recording()
    _active = rec
    try:
        with _counting_syncs() if syncs else _NULL:
            yield rec
    finally:
        _active = None
        rec._finish()
