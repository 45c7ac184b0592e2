"""CPU tests of portbench/program_spans.py: its readers on synthetic
summaries, and trace.summarize's busy time with the program's spans in
the trace.

Run from the repository root: ``python -m pytest portbench/tests -q``.
The splitting functions are held in tests/test_torch_port_spans.py.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import program_spans as ps
from portbench import trace

SUMMARY = {"batches": 4, "matcher_prep_idle_ms": 8.0,
           "forward_idle_ms": 100.0, "matcher_readback_idle_ms": 12.0,
           "host_syncs": 48.0, "ransac_device_ms": 6.0,
           "loss_device_ms": 80.0, "backward_device_ms": 1000.0,
           "optimizer_device_ms": 40.0}
WANT = {"matcher_prep_idle_ms.match": 2.0, "forward_idle_ms.match": 25.0,
        "matcher_readback_idle_ms.match": 3.0, "host_syncs.match": 12.0,
        "ransac_ms.match": 1.5, "loss_ms.train": 20.0,
        "backward_ms.train": 250.0, "optimizer_ms.train": 10.0,
        "host_syncs.train": 12.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_summary(name):
    assert ps.READERS[name](SUMMARY) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_its_keys_reads_none(name):
    """A summary of a program without the spans (the keys trace.measure
    alone gives) reads None, and so does one with no batch count."""
    plain = {"batches": 4, "busy_s": 1.0, "window_s": 1.5,
             "stage_ms": {"gam": 9.0}}
    assert ps.READERS[name](plain) is None
    assert ps.READERS[name](dict(SUMMARY, batches=0)) is None


def test_span_keys_take_the_cells_readers_and_scale_records():
    s = dict(SUMMARY, span_idle_ms={"matcher.pad": 4.0, ps.OUTSIDE: 2.0},
             host_syncs_by_span={"matcher.copy_out": 28, "gam": 20},
             idle_gaps_by_span=[["match_batch:matcher.copy_out", 0.01]],
             cost={"untraced_off": [0.4], "untraced_on": [0.42]})
    got = ps.span_keys(s, "match")
    assert {k for k in got if k in WANT} == {k for k in WANT
                                            if k.endswith(".match")}
    assert got["span_idle_ms"] == {"matcher.pad": 1.0, ps.OUTSIDE: 0.5}
    assert got["host_syncs_by_span"] == {"gam": 5.0,
                                         "matcher.copy_out": 7.0}
    assert got["idle_gaps_by_span"] == s["idle_gaps_by_span"]
    assert got["cost_ms"] == {"untraced_off": [100.0],
                              "untraced_on": [pytest.approx(105.0)]}
    assert set(ps.span_keys(s, "train")) & set(WANT) == {
        k for k in WANT if k.endswith(".train")}


def _event(name, device, t0, t1, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device \
        else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=t0, end=t1),
                           kernels=[], cpu_children=[])


def test_full_trace_busy_time_leaves_out_the_new_ranges_annotations():
    """The GPU-side annotations that the program's new ranges leave in a
    full trace (one per range, over the device time of its kernels) are
    not device work: trace.summarize's busy time and operations hold the
    kernels alone, as before the spans."""
    kernels = [_event("gemm", True, 0, 10), _event("gemm", True, 20, 30)]
    annotations = [_event(n, True, 0, 30, annotation=True)
                   for n in ("matcher.forward", "matcher.copy_in",
                             "ransac", "train.backward", "gam")]
    host = [_event(n, False, 0, 40) for n in ("matcher.call", "gam")]
    prof = SimpleNamespace(events=lambda: kernels + annotations + host)
    s = trace.summarize(prof, 50e-6)
    assert s["busy_s"] == pytest.approx(20e-6)
    assert set(s["kernel_ms"]) == {"gemm"}
    assert [g[0] for g in s["idle_gaps"]] == ["none:gam"]
