"""The port's span recorder (geoformer_tpu_torch/utils/spans.py) and the
benchmark's reading of it (portbench/program_spans.py), on the CPU.

Spans nest, carry their thread and the id of their call or step; off, they
keep nothing, change no output and cost no more than the bare
``record_function`` they replace; the matcher, the forward and the train
step record their parts in order; each span's ends lie on the profiler's
axis where its ``record_function`` range does; syncs are counted under the
innermost span; and the idle split and the launch attribution give exact
parts on synthetic intervals. The host syncs of the card and the device
trace's clock are held in tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import timeit
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from geoformer_tpu_torch import config as pc
from geoformer_tpu_torch import weights
from geoformer_tpu_torch.eval.matcher import BatchedMatcher
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.train.optim import make_optimizer
from geoformer_tpu_torch.train.trainer import TrainState, make_train_step
from geoformer_tpu_torch.utils import spans
from geoformer_tpu_torch.utils.spans import recording, span
from portbench import program_spans as ps

STAGES = ("backbone", "coarse_transformer", "coarse_match_1", "gam",
          "coarse_match_2", "fine")
TRAIN_PARTS = ("train.forward", "train.supervision", "train.loss",
               "train.backward", "train.clip", "train.optimizer")


def _small_config():
    """A narrow model whose untrained weights still leave matches, so the
    GAM and the fine stage work."""
    return pc.GeoFormerConfig(
        backbone=pc.BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=pc.CoarseTransformerConfig(
            d_model=32, nhead=4, layer_names=("self", "cross") * 2),
        fine=pc.FineTransformerConfig(d_model=16, nhead=2),
        match=pc.MatchConfig(thr=1e-4, max_matches=64),
        geo=pc.GeoModuleConfig(nhead=2, ransac_iters=32, max_inliers=64),
        fine_match=pc.FineMatchConfig(thr=1e-3))


@pytest.fixture(scope="module")
def matcher():
    torch.manual_seed(0)
    model = weights.random_init(GeoFormer(_small_config()), seed=0)
    return BatchedMatcher(model.config, model, batch_size=2, device="cpu")


def _pairs(n=2, hw=(64, 64)):
    rng = np.random.default_rng(3)
    a = [rng.random(hw, dtype=np.float32) for _ in range(n)]
    return a, [np.roll(x, 8, axis=1) for x in a]


def _children(rec, parent):
    return [s.name for s in rec.spans if s.parent == parent]


# ------------------------------------------------------------ recorder --

def test_spans_nest_with_parents_threads_and_ids():
    with recording() as rec:
        with span("a"):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e"):
            box = []
            t = threading.Thread(target=lambda: box.append(
                spans._active._open("t", spans.clock())))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "c", "d", "e", "t"]
    by = {s.name: s for s in rec.spans}
    assert [by[n].parent for n in names] == [-1, 0, 1, 0, -1, -1]
    # a and its spans are call 0, e call 1; the other thread's first span
    # starts a call of its own
    assert [by[n].group for n in names] == [0, 0, 0, 0, 1, 2]
    main = threading.get_ident()
    assert all(by[n].thread == main for n in "abcde")
    assert by["t"].thread != main
    for s in rec.spans[:5]:
        assert s.start_ns <= s.end_ns
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].end_ns \
        <= by["b"].end_ns <= by["d"].start_ns <= by["a"].end_ns \
        <= by["e"].start_ns


def test_recordings_do_not_nest_and_end_cleanly():
    with recording():
        with pytest.raises(RuntimeError):
            with recording():
                pass
    assert spans._active is None
    with pytest.raises(ValueError):
        with recording():
            raise ValueError("inside")
    assert spans._active is None


def test_off_keeps_nothing():
    """Outside a recording and a profiler a span is the one shared null
    context, and a count goes nowhere."""
    assert spans._active is None
    assert span("x") is span("y") is spans._NULL
    with span("x"):
        spans.count(spans.SYNC)
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("x"), record_function)


def test_off_and_on_give_the_same_outputs(matcher):
    a, b = _pairs()
    off = matcher.match_batch(a, b, return_geo=True)
    with recording(syncs=True):
        on = matcher.match_batch(a, b, return_geo=True)
    assert len(off) == len(on) == 2
    for x, y in zip(off, on):
        for u, v in zip(x[:3], y[:3]):
            np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(x[3]["H"], y[3]["H"])
        assert x[3]["num_inliers"] == y[3]["num_inliers"]


def test_the_matcher_records_its_parts_and_the_six_stages(matcher):
    """Two chunks of two pairs at 64x64: each a matcher.call with pad,
    copy in, forward (the six stages inside, RANSAC inside the GAM), copy
    out and unpack in order, one id a call."""
    a, b = _pairs(4)
    with recording() as rec:
        matcher.match_batch(a, b, return_geo=True)
    calls = [i for i, s in enumerate(rec.spans) if s.name == "matcher.call"]
    assert len(calls) == 2
    for k, c in enumerate(calls):
        assert rec.spans[c].parent == -1
        assert _children(rec, c) == ["matcher.pad", "matcher.copy_in",
                                     "matcher.forward", "matcher.copy_out",
                                     "matcher.unpack"]
        fwd = next(i for i, s in enumerate(rec.spans)
                   if s.name == "matcher.forward" and s.parent == c)
        assert tuple(_children(rec, fwd)) == STAGES
        gam = next(i for i, s in enumerate(rec.spans)
                   if s.name == "gam" and s.parent == fwd)
        assert _children(rec, gam) == ["ransac"]
        assert {s.group for s in rec.spans
                if s.start_ns >= rec.spans[c].start_ns
                and s.end_ns <= rec.spans[c].end_ns} == {k}


def test_the_train_step_records_its_six_parts():
    cfg = _small_config().replace(match=dataclasses.replace(
        _small_config().match, force_one_match=True))
    model = weights.random_init(GeoFormer(cfg), seed=1)
    tc = pc.TrainConfig(batch_size=1, image_hw=(64, 80))
    state = TrainState(model, make_optimizer(tc.optim, model.parameters()))
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.random((1, 64, 80, 1), dtype=np.float32))
    eye = torch.eye(3)[None]
    batch = {"image0": img, "image1": img.clone(), "H_0to1": eye,
             "H_1to0": eye}
    step = make_train_step(tc)
    gen = torch.Generator().manual_seed(0)
    with recording() as rec:
        for _ in range(2):
            step(state, batch, 1e-4, generator=gen)
    roots = [i for i, s in enumerate(rec.spans) if s.parent == -1]
    assert [rec.spans[i].name for i in roots] == ["train.step"] * 2
    for k, r in enumerate(roots):
        assert tuple(_children(rec, r)) == TRAIN_PARTS
        assert rec.spans[r].group == k
        fwd = next(i for i, s in enumerate(rec.spans)
                   if s.name == "train.forward" and s.parent == r)
        assert tuple(_children(rec, fwd)) == STAGES


def _ends_off_their_ranges():
    """The largest distance (us) between an end of two nested spans, on
    the trace's axis, and the same end of the record_function range each
    opened, under a CPU-only profiler."""
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):    # the profiler's first range
                pass                            # pays for its set-up
            with span("outer"):
                time.sleep(0.002)
                with span("inner"):
                    time.sleep(0.003)
    got, names, _, _ = ps._axis(rec, prof)
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in names}
    assert set(ranges) == set(names) == {"outer", "inner"}
    return max(max(abs(a - ranges[n].start), abs(b - ranges[n].end))
               for (a, b), n in zip(got, names))


def test_span_ends_lie_on_the_record_function_ranges():
    """Each span's ends lie within 50 us of its range's on the trace's
    axis. A span's end is the midpoint of the clock read before and after
    the range's own enter (or exit), inside which the profiler stamps the
    range; on a shared host that call now and then stalls for 100 us and
    more, so a stalled attempt is taken again (five at most)."""
    worst = [_ends_off_their_ranges() for _ in range(5)]
    assert min(worst) < 50, worst


def test_syncs_are_counted_under_the_innermost_span():
    """The sync debug mode's warning (raised here by hand: the CPU has no
    syncs) counts under the innermost span of its thread, or, on a thread
    with none open, of the recording's; other warnings pass through; the
    filters come back as they were."""
    filters = list(warnings.filters)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with recording(syncs=True) as rec:
            warnings.warn(spans.SYNC_WARNING)
            with span("outer"):
                warnings.warn(spans.SYNC_WARNING)
                with span("inner"):
                    for _ in range(3):
                        warnings.warn(spans.SYNC_WARNING)
                    t = threading.Thread(target=warnings.warn,
                                         args=(spans.SYNC_WARNING,))
                    t.start()
                    t.join(timeout=10)
                    assert not t.is_alive()
                    warnings.warn("something else")
    assert rec.totals(spans.SYNC) == {None: 1, "outer": 1, "inner": 4}
    assert [str(w.message) for w in shown] == ["something else"]
    assert warnings.filters == filters


def test_span_off_costs_at_most_a_microsecond_over_record_function():
    """Off (no recording, no profiler), a span costs at most 1 us more
    than the bare record_function range the forward's stages used."""
    def bare():
        with record_function("stage"):
            pass

    def ours():
        with span("stage"):
            pass

    n = 20000
    t_bare = min(timeit.repeat(bare, number=n, repeat=5)) / n
    t_ours = min(timeit.repeat(ours, number=n, repeat=5)) / n
    assert t_ours - t_bare <= 1e-6, (t_ours, t_bare)


# ------------------------------------------------------ program_spans --

def test_segments_give_the_innermost_span():
    spans_ = [(0, 10), (2, 8), (3, 5), (9, 12)]
    segs = ps.segments(spans_)
    assert segs == [(0, 2, 0), (2, 3, 1), (3, 5, 2), (5, 8, 1), (8, 9, 0),
                    (9, 10, 3), (10, 12, 3)]


def test_idle_split_sums_exactly_to_the_idle_time():
    rng = np.random.default_rng(0)
    cuts = np.sort(rng.uniform(0, 1000, 40))
    spans_ = []
    for k in range(0, 40, 4):           # calls with two nested parts
        a, b, c, d = cuts[k:k + 4]
        spans_ += [(a, d), (a, b), (c, d)]
    busy = sorted(tuple(sorted(rng.uniform(-50, 1050, 2)))
                  for _ in range(60))
    busy = [tuple(x) for x in __import__("portbench.trace", fromlist=["_"])
            ._merge(busy)]
    gaps = ps.idle(busy, -100.0, 1100.0)
    total = sum(b - a for a, b in gaps)
    covered = sum(min(b, 1100) - max(a, -100) for a, b in busy
                  if b > -100 and a < 1100)
    assert total == pytest.approx(1200.0 - covered, abs=1e-9)
    parts = ps.split(gaps, ps.segments(spans_))
    assert sum(parts.values()) == pytest.approx(total, rel=1e-12)
    # by brute force: each idle microsecond's innermost span
    want = {}
    for a, b in gaps:
        for t in np.arange(np.ceil(a), b, 1.0):
            open_ = [i for i, (s0, s1) in enumerate(spans_) if s0 <= t < s1]
            who = max(open_, key=lambda i: (spans_[i][0], i)) if open_ \
                else -1
            want[who] = want.get(who, 0) + 1
    for who, n in want.items():
        assert parts.get(who, 0.0) == pytest.approx(n, abs=2 * len(gaps))


def test_nested_idle_goes_to_the_innermost_and_rolls_up():
    names = ["matcher.call", "matcher.pad", "matcher.forward", "gam",
             "ransac"]
    parents = [-1, 0, 0, 2, 3]
    spans_ = [(0, 100), (0, 10), (10, 90), (40, 60), (45, 55)]
    gaps = [(5, 15), (42, 50), (95, 120)]
    by_index = ps.split(gaps, ps.segments(spans_))
    assert by_index == {1: 5, 2: 5, 3: 3, 4: 5, 0: 5, -1: 20}
    by_name, under = ps.rollup(by_index, names, parents)
    assert by_name == {"matcher.pad": 5, "matcher.forward": 5, "gam": 3,
                       "ransac": 5, "matcher.call": 5, ps.OUTSIDE: 20}
    assert under(ps.MATCHER_PREP) == 5
    assert under(ps.MATCHER_FORWARD) == 13
    assert under(ps.MATCHER) == 23


def test_launches_go_to_the_span_open_at_their_launch():
    """A kernel counts under the innermost span open when it was launched
    (on any thread), whenever it ran; launches outside every span count
    as -1."""
    names = ["train.step", "train.forward", "train.backward"]
    parents = [-1, 0, 0]
    spans_ = [(0, 100), (5, 40), (50, 90)]
    launches = [(6, 3.0), (39, 2.0), (41, 7.0), (60, 11.0), (95, 1.0),
                (120, 5.0)]
    by_index = ps.at(launches, ps.segments(spans_))
    assert by_index == {1: 5.0, 0: 8.0, 2: 11.0, -1: 5.0}
    _, under = ps.rollup(by_index, names, parents)
    assert under(ps.BACKWARD) == 11.0
    assert under(("train.step",)) == 24.0
