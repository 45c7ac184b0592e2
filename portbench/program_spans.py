"""The program's own spans (geoformer_tpu_torch/utils/spans.py) on the
profiler's clock: the light trace's idle time split by the span the host
was in, the full trace's device time split by the span each kernel was
launched under, and the host syncs counted by span.

``measure(plain, body)`` is ``portbench/trace.measure`` with the program's
span recording on in its light stretch (spans alone) and in its full
stretch (spans and host syncs); every key ``trace.measure`` gives is
computed as there, and the keys of ``span_keys`` are added. It is never
on in the untraced stretch. The readers in ``READERS`` give the per-layer
figures of a cell from those keys, and None where a key is missing (a
program without the spans).

    python3 portbench/program_spans.py --workload <cell> --seed <n> \\
        [--cost <pairs>]

runs a cell's traced run (as ``portbench/run.py --trace 1`` does, check
included) with this ``measure`` in place, and prints its result line with
a ``program_spans`` entry: the readers' figures, the by-span records
(``span_idle_ms``, ``span_device_ms``, ``span_host_ms``, ``host_syncs_by
_span``, all a batch), the ten longest idle gaps of the full trace
labelled by span, and, with ``--cost``, the recording's cost (``cost``:
ms a batch of the untraced and the light stretch with the recording on and
off, in ``--cost`` alternating pairs).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import sys
from typing import Dict, List, Sequence, Tuple

# the spans each figure sums (a piece counts where the innermost span open
# at it is one of these or lies inside one)
MATCHER_PREP = ("matcher.pad", "matcher.copy_in")
MATCHER_FORWARD = ("matcher.forward",)
MATCHER_READBACK = ("matcher.copy_out", "matcher.unpack")
MATCHER = ("matcher.call",)
LOSS = ("train.supervision", "train.loss")
BACKWARD = ("train.backward",)
OPTIMIZER = ("train.clip", "train.optimizer")
RUNTIME = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"      # the key of no span open


# ------------------------------------------------------- pure functions --

def segments(spans: Sequence[Tuple[float, float]]) -> List[tuple]:
    """The time between the first span's start and the last one's end, cut
    at every span's ends into pieces (t0, t1, i): i is the innermost span
    open over the piece (the latest started; of equal starts the later
    in the list), -1 where none is."""
    points = sorted({t for s in spans for t in s})
    starts = sorted(range(len(spans)), key=lambda i: (spans[i][0], i))
    out = []
    for t0, t1 in zip(points, points[1:]):
        inner = -1
        for i in starts:
            s0, s1 = spans[i]
            if s0 > t0:
                break
            if s1 >= t1:
                inner = i
        out.append((t0, t1, inner))
    return out


def split(intervals: Sequence[Tuple[float, float]],
          segs: Sequence[tuple]) -> Dict[int, float]:
    """The length of ``intervals`` by the span of the ``segments`` piece
    each part falls in (-1: none, or outside every piece). The parts add
    up to the intervals' length."""
    out: Dict[int, float] = {}

    def add(who, length):
        if length > 0:
            out[who] = out.get(who, 0.0) + length

    if not segs:
        for a, b in intervals:
            add(-1, b - a)
        return out
    lo, hi = segs[0][0], segs[-1][1]
    starts = [s[0] for s in segs]
    for a, b in intervals:
        add(-1, min(b, lo) - a)
        add(-1, b - max(a, hi))
        a, b = max(a, lo), min(b, hi)
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(segs) and segs[k][0] < b:
            add(segs[k][2], min(b, segs[k][1]) - max(a, segs[k][0]))
            k += 1
    return out


def at(times_weights: Sequence[Tuple[float, float]],
       segs: Sequence[tuple]) -> Dict[int, float]:
    """The weights of (time, weight) pairs by the span of the piece each
    time falls in (-1: none)."""
    out: Dict[int, float] = {}
    starts = [s[0] for s in segs]
    for t, w in times_weights:
        k = bisect.bisect_right(starts, t) - 1
        who = segs[k][2] if 0 <= k and t <= segs[k][1] else -1
        out[who] = out.get(who, 0.0) + w
    return out


def idle(busy: Sequence[Tuple[float, float]], w0: float,
         w1: float) -> List[Tuple[float, float]]:
    """The parts of [w0, w1] outside the merged intervals ``busy``."""
    out, t = [], w0
    for a, b in busy:
        if b <= t:
            continue
        if a > t:
            out.append((t, min(a, w1)))
        t = max(t, b)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(a, b) for a, b in out if b > a]


def chains(names: Sequence[str], parents: Sequence[int]) -> List[set]:
    """The names of each span and of every span that encloses it."""
    out: List[set] = []
    for i, p in enumerate(parents):
        out.append({names[i]} | (out[p] if p >= 0 else set()))
    return out


def rollup(by_index: Dict[int, float], names, parents) -> Tuple[dict, dict]:
    """(totals by the innermost span's name, with OUTSIDE for -1; a
    function of span names -> the total of the pieces under any of them)."""
    ch = chains(names, parents)
    by_name: Dict[str, float] = {}
    for i, v in by_index.items():
        key = names[i] if i >= 0 else OUTSIDE
        by_name[key] = by_name.get(key, 0.0) + v

    def under(group) -> float:
        return sum(v for i, v in by_index.items()
                   if i >= 0 and ch[i] & set(group))
    return by_name, under


# --------------------------------------------------- the profiler's side --

def _axis(rec, prof):
    """The recording's spans on the profiler's axis (us after the trace's
    start): (intervals, names, parents), and the map of a clock time."""
    start = prof.profiler.kineto_results.trace_start_ns()

    def us(t):
        return (rec.unix_ns(t) - start) / 1e3

    spans = rec.spans
    return ([(us(s.start_ns), us(s.end_ns)) for s in spans],
            [s.name for s in spans], [s.parent for s in spans], us)


def _device(prof, names) -> list:
    """The device's operations as trace.summarize counts them (range
    annotations left out, and any event named as a span)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    skip = set(names) | set(_trace().STAGES)
    return [e for e in prof.events() if e.device_type == cuda and not (
        getattr(e, "is_user_annotation", False) or e.name in skip
        or e.name.startswith(_trace().SPAN_PREFIX))]


def _launches(prof, device) -> Tuple[list, Dict[str, float]]:
    """(launch time, device us) of each device operation: the start of
    the runtime call with its correlation id; failing that, of the torch
    operation it is linked to; failing both, its own start. With the
    device us taken each way."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    runtime, ops = {}, {}
    for e in prof.events():
        if e.device_type != cpu:
            continue
        kind = getattr(e, "activity_type", None)
        if (kind in RUNTIME) if kind else e.name.startswith("cu"):
            runtime[e.id] = e.time_range.start
        elif not getattr(e, "linked_correlation_id", 0):
            ops.setdefault(e.id, e.time_range.start)
    out, how = [], {"runtime": 0.0, "op": 0.0, "none": 0.0}
    for e in device:
        d = e.time_range.end - e.time_range.start
        if e.id in runtime:
            t, k = runtime[e.id], "runtime"
        elif getattr(e, "linked_correlation_id", 0) in ops:
            t, k = ops[e.linked_correlation_id], "op"
        else:
            t, k = e.time_range.start, "none"
        out.append((t, d))
        how[k] += d
    return out, how


def _trace():
    from portbench import trace
    return trace


def light_keys(prof, rec, window) -> Dict:
    """The light stretch's idle time (its window [start, end] on the
    recording's clock) split by the innermost span open, in ms."""
    spans, names, parents, us = _axis(rec, prof)
    busy = _trace()._merge([(e.time_range.start, e.time_range.end)
                            for e in _device(prof, names)])
    gaps = idle(busy, us(window[0]), us(window[1]))
    by_index = split(gaps, segments(spans))
    by_name, under = rollup(by_index, names, parents)
    host: Dict[str, float] = {}
    for (a, b), n in zip(spans, names):
        host[n] = host.get(n, 0.0) + (b - a) / 1e3
    return {"idle_total_ms": sum(b - a for a, b in gaps) / 1e3,
            "idle_window_ms": (us(window[1]) - us(window[0])) / 1e3,
            "span_idle_ms": {k: v / 1e3 for k, v in by_name.items()},
            "matcher_prep_idle_ms": under(MATCHER_PREP) / 1e3,
            "forward_idle_ms": under(MATCHER_FORWARD) / 1e3,
            "matcher_readback_idle_ms": under(MATCHER_READBACK) / 1e3,
            "matcher_idle_ms": under(MATCHER) / 1e3,
            "span_host_ms": host}


def axis_check(prof, spans, names) -> Dict:
    """How far the recorded spans, put on the trace's axis, lie from the
    record_function ranges they opened in a full trace (the k-th span of
    a name against the k-th range of that name): the median and largest
    distance of their starts and of their ends, us."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    ranges: Dict[str, list] = {}
    for e in prof.events():
        if e.device_type == cpu and e.name in set(names):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    seen: Dict[str, int] = {}
    starts, ends = [], []
    for (a, b), n in zip(spans, names):
        k = seen.get(n, 0)
        seen[n] = k + 1
        mine = sorted(ranges.get(n, []))
        if k < len(mine):
            starts.append(abs(a - mine[k][0]))
            ends.append(abs(b - mine[k][1]))
    if not starts:
        return {}
    starts.sort()
    ends.sort()
    return {"n": len(starts), "start_p50": starts[len(starts) // 2],
            "start_max": starts[-1], "end_p50": ends[len(ends) // 2],
            "end_max": ends[-1]}


def full_keys(prof, rec) -> Dict:
    """The full stretch's device time by the span each operation was
    launched under, the syncs by span, and the ten longest idle gaps (as
    trace.summarize picks them) labelled with the innermost span."""
    from geoformer_tpu_torch.utils import spans as program

    spans, names, parents, _ = _axis(rec, prof)
    device = _device(prof, names)
    launches, how = _launches(prof, device)
    segs = segments(spans)
    by_name, under = rollup(at(launches, segs), names, parents)
    trace = _trace()
    merged = trace._merge([(e.time_range.start, e.time_range.end)
                           for e in device])
    gaps = sorted(((b - a, 0.5 * (a + b)) for (_, a), (b, _) in
                   zip(merged, merged[1:])), key=lambda g: -g[0])[:10]
    bench = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith(trace.SPAN_PREFIX)]
    labelled = []
    for us_, mid in gaps:
        who = next(iter(at([(mid, 0.0)], segs)))
        label = trace._label(mid, bench)
        if who >= 0:
            label += ":" + names[who]
        labelled.append([label, us_ / 1e6])
    syncs = rec.totals(program.SYNC)
    return {"axis_check_us": axis_check(prof, spans, names),
            "span_device_ms": {k: v / 1e3 for k, v in by_name.items()},
            "device_total_ms": sum(d for _, d in launches) / 1e3,
            "device_launch_ms": {k: v / 1e3 for k, v in how.items()},
            "train_forward_device_ms": under(("train.forward",)) / 1e3,
            "ransac_device_ms": under(("ransac",)) / 1e3,
            "loss_device_ms": under(LOSS) / 1e3,
            "backward_device_ms": under(BACKWARD) / 1e3,
            "optimizer_device_ms": under(OPTIMIZER) / 1e3,
            "host_syncs": float(sum(syncs.values())),
            "host_syncs_by_span": {k or OUTSIDE: v
                                   for k, v in syncs.items()},
            "idle_gaps_by_span": labelled}


def measure(plain, body, cost_pairs: int = 0) -> Dict:
    """trace.measure(plain, body), with the program's spans recorded in its
    light and full stretches and their keys added; with ``cost_pairs``,
    ``cost`` as well. Where the program has no spans, trace.measure's
    summary alone."""
    trace = _trace()
    try:
        from geoformer_tpu_torch.utils import spans as program
    except ImportError:
        return trace.measure(plain, body)
    marks = []

    def marked():
        marks.append(program.clock())
        plain()
        marks.append(program.clock())

    untraced_s = trace.timed(plain)
    with program.recording() as rec:
        _, prof, light_s = trace.traced(marked, light=True)
    light = trace.summarize(prof, light_s)
    extra = light_keys(prof, rec, marks[-2:])
    del prof
    with program.recording(syncs=True) as rec:
        _, prof, window_s = trace.traced(body)
    summary = trace.summarize(prof, window_s)
    extra.update(full_keys(prof, rec))
    del prof
    summary.update(untraced_s=untraced_s, full_busy_s=summary["busy_s"],
                   full_window_s=window_s)
    if light["busy_s"] > 0:
        summary.update(busy_s=light["busy_s"], window_s=light_s)
    summary.update(extra)
    if cost_pairs:
        summary["cost"] = recording_cost(plain, cost_pairs)
    return summary


def recording_cost(plain, pairs: int) -> Dict:
    """Seconds of plain() untraced and under the light trace, with the
    span recording off and on, in ``pairs`` pairs (off, on, then on, off
    alternately)."""
    from geoformer_tpu_torch.utils import spans as program

    trace = _trace()
    out = {"untraced_off": [], "untraced_on": [], "light_off": [],
           "light_on": []}

    def one(on: bool):
        with program.recording() if on else contextlib.nullcontext():
            u = trace.timed(plain)
        with program.recording() if on else contextlib.nullcontext():
            _, prof, s = trace.traced(plain, light=True)
        del prof
        tag = "on" if on else "off"
        out["untraced_" + tag].append(u)
        out["light_" + tag].append(s)

    for k in range(pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            one(on)
    out["span_us"] = span_cost_us()
    return out


def span_cost_us(n: int = 20000) -> Dict[str, float]:
    """Host us of one empty span outside any profiler, recording off and
    on (the best of five runs of ``n``)."""
    import timeit

    from geoformer_tpu_torch.utils import spans as program

    def one():
        with program.span("cost"):
            pass

    off = min(timeit.repeat(one, number=n, repeat=5)) / n
    with program.recording():
        on = min(timeit.repeat(one, number=n, repeat=5)) / n
    return {"off": 1e6 * off, "on": 1e6 * on}


# -------------------------------------------------------------- readers --

def _per_batch(key):
    def read(s):
        if s.get(key) is None or not s.get("batches"):
            return None
        return s[key] / s["batches"]
    return read


# the per-layer figures these keys give, by the names a benchmark entry
# would carry (a batch: a call of the matcher, a train step)
READERS = {
    "matcher_prep_idle_ms.match": _per_batch("matcher_prep_idle_ms"),
    "forward_idle_ms.match": _per_batch("forward_idle_ms"),
    "matcher_readback_idle_ms.match": _per_batch("matcher_readback_idle_ms"),
    "host_syncs.match": _per_batch("host_syncs"),
    "ransac_ms.match": _per_batch("ransac_device_ms"),
    "loss_ms.train": _per_batch("loss_device_ms"),
    "backward_ms.train": _per_batch("backward_device_ms"),
    "optimizer_ms.train": _per_batch("optimizer_device_ms"),
    "host_syncs.train": _per_batch("host_syncs"),
}


def span_keys(s: Dict, kind: str) -> Dict:
    """What the result line carries of the added keys: the figures of the
    readers whose names end in ``.<kind>`` (a cell's driver: match,
    train), and the records by span, a batch."""
    n = s.get("batches") or 1
    out = {k: r(s) for k, r in READERS.items() if k.endswith("." + kind)}

    def scaled(d):
        return {k: v / n for k, v in sorted(d.items())}
    for key in ("span_idle_ms", "span_device_ms", "span_host_ms",
                "host_syncs_by_span", "device_launch_ms"):
        if key in s:
            out[key] = scaled(s[key])
    for key in ("idle_total_ms", "idle_window_ms", "matcher_idle_ms",
                "device_total_ms", "train_forward_device_ms"):
        if key in s:
            out[key] = s[key] / n
    for key in ("idle_gaps_by_span", "axis_check_us"):
        if key in s:
            out[key] = s[key]
    if "cost" in s:
        out["cost_ms"] = {k: [1e3 * v / n for v in vals]
                          for k, vals in s["cost"].items() if k != "span_us"}
        if "span_us" in s["cost"]:
            out["span_cost_us"] = s["cost"]["span_us"]
    return out


# ------------------------------------------------------------- the tool --

def main(argv=None) -> int:
    import argparse
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path[0] = str(root)
    from portbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, default=0,
                    help="alternating pairs of the recording's cost")
    args = ap.parse_args(argv)
    cell, config, mix, bench = run.load_cell(args.workload)
    run._environment()
    import torch

    from portbench import trace

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA card", file=sys.stderr)
        return 2
    got = {}

    def hooked(plain, body):
        got["summary"] = measure(plain, body, args.cost)
        return got["summary"]

    trace.measure = hooked
    result = run.execute(cell, config, mix, bench, args.seed, 0.0, True,
                         torch.device("cuda", 0))
    result["device"].update(kind=torch.cuda.get_device_name(0))
    result["program_spans"] = span_keys(got["summary"], mix["driver"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
