"""The traced stretch of a run: device time by stage and by kernel, the
device's busy time, and its idle gaps labelled by what the host was doing
(``measure``).

The benchmark wraps its calls into the program in host spans of its own
(``span``); the program's forward carries the stage ranges named in
STAGES. The profiler keeps its events in memory; only the summary below
leaves the process. The ways of summing device time under a range and of
merging the device's busy intervals are copies of the port's
``eval/profile_forward.py`` and ``chip_smoke._profile_step``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

STAGES = ("backbone", "coarse_transformer", "coarse_match_1", "gam",
          "coarse_match_2", "fine")
SPAN_PREFIX = "bench:"


class Spans:
    """Host spans of the benchmark's own: record_function ranges while a
    trace is on, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        return record_function(SPAN_PREFIX + name) if self.on \
            else contextlib.nullcontext()


def _kernel_us(evt) -> float:
    """Device time of the kernels launched under a CPU event, children
    included (microseconds)."""
    return sum(k.duration for k in evt.kernels) + sum(
        _kernel_us(c) for c in evt.cpu_children)


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def _label(t: float, ranges) -> str:
    """The benchmark span and the innermost program stage open at t."""
    bench, stage = "none", ""
    for name, t0, t1 in ranges:
        if t0 <= t <= t1:
            if name.startswith(SPAN_PREFIX):
                bench = name[len(SPAN_PREFIX):]
            else:
                stage = name
    return f"{bench}:{stage}" if stage else bench


def timed(fn) -> float:
    """Seconds of ``fn()`` between CUDA events, untraced (the stretch the
    traced one is held against)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def traced(fn, light: bool = False):
    """Run ``fn()`` under the profiler with a CUDA event at each end; with
    ``light`` the device's activity alone (no host events, so no ranges,
    and a smaller cost on the host). Returns (fn's result, the profiler,
    the window in seconds)."""
    acts = [ProfilerActivity.CUDA] if light else [ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=acts) as prof:
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
    return result, prof, start.elapsed_time(end) / 1e3


def summarize(prof, window_s: float) -> Dict:
    """{"busy_s", "window_s", "stage_ms" (totals over the stretch),
    "kernel_ms" (device ms by kernel name), "device_ops" and "idle_gaps"
    (the ten longest of each, [name, seconds])}."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    busy: List[Tuple[float, float]] = []
    ops: Dict[str, float] = {}
    stage_us = dict.fromkeys(STAGES, 0.0)
    ranges = []
    for e in prof.events():
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or \
                    e.name in STAGES or e.name.startswith(SPAN_PREFIX):
                continue
            t0, t1 = e.time_range.start, e.time_range.end
            busy.append((t0, t1))
            ops[e.name] = ops.get(e.name, 0.0) + (t1 - t0)
        elif e.device_type == cpu and (e.name in STAGES
                                       or e.name.startswith(SPAN_PREFIX)):
            ranges.append((e.name, e.time_range.start, e.time_range.end))
            if e.name in STAGES:
                stage_us[e.name] += _kernel_us(e)
    merged = _merge(busy)
    busy_us = sum(t1 - t0 for t0, t1 in merged)
    gaps = sorted(((b - a, 0.5 * (a + b)) for (_, a), (b, _) in
                   zip(merged, merged[1:])), key=lambda g: -g[0])[:10]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "stage_ms": {k: v / 1e3 for k, v in stage_us.items()},
        "kernel_ms": {k: v / 1e3 for k, v in ops.items()},
        "device_ops": [[name[:120], us / 1e6] for name, us in top],
        "idle_gaps": [[_label(mid, ranges), us / 1e6] for us, mid in gaps],
    }


def measure(plain, body) -> Dict:
    """The traced stretch of a run, in three parts of the same work: plain()
    untraced between CUDA events (``untraced_s``), plain() again under the
    light trace (``busy_s`` and ``window_s``: the device's busy time and
    the idle share, with as little of the profiler's own cost as it can
    carry), and body() under the full trace (the stages, kernels, device
    operations and labelled idle gaps of ``summarize``; its own busy time
    and window as ``full_busy_s``, ``full_window_s``). Where the light
    trace sees no device activity, busy time and window are the full
    trace's."""
    untraced_s = timed(plain)
    _, prof, light_s = traced(plain, light=True)
    light = summarize(prof, light_s)
    del prof
    _, prof, window_s = traced(body)
    summary = summarize(prof, window_s)
    del prof
    summary.update(untraced_s=untraced_s, full_busy_s=summary["busy_s"],
                   full_window_s=window_s)
    if light["busy_s"] > 0:
        summary.update(busy_s=light["busy_s"], window_s=light_s)
    return summary


def kernel_ms(summary: Dict, names) -> float:
    """Device ms of every kernel whose name holds one of ``names`` (as
    ``name<`` or ``name(``, a template or a plain signature)."""
    total = 0.0
    for op, ms in summary["kernel_ms"].items():
        if any(f"{n}<" in op or f"{n}(" in op for n in names):
            total += ms
    return total
