"""CPU tests of the port's benchmark harness (portbench/).

Run from the repository root: ``python -m pytest portbench/tests -q``.
Tests marked ``cuda`` need the card and skip here; on the card (no JAX,
so no conftest): ``python3 -m pytest --noconftest portbench/tests -q``.

The harness runs here at a tiny size on the CPU (``run.execute`` with a
CPU device and shrunken traffic, skipping the look for a card), with the
port's CPU versions of its kernels.
"""

from __future__ import annotations

import ast
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, counts, gen, run
from portbench.drivers import match as match_driver

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "geoformer_tpu"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _tiny(workload, **mix_over):
    cell, config, mix, bench = run.load_cell(workload)
    if workload.startswith("bench."):
        config = dict(config, image_hw=[128, 128])
        mix = dict(mix, batch=2, pool=4, warmup_calls=1, judge_calls=1,
                   judge_from_first=1)
    else:
        config = dict(config, image_hw=[64, 96])
        mix = dict(mix, batch=2, batches=4, warmup_steps=4, log_every=2)
    mix.update(mix_over)
    return cell, config, mix, bench


def _numbers(res):
    """Every number a run's check read: the compared and the recorded."""
    return dict(res["record"], **{k: v["value"] for k, v in
                                  res["checks"].items()})


def _execute(workload, seed=2**31 + 77, config_over=None, **mix_over):
    torch.set_num_threads(4)
    cell, config, mix, bench = _tiny(workload, **mix_over)
    config.update(config_over or {})
    return run.execute(cell, config, mix, bench, seed, 1.0, False, "cpu",
                       t_start=time.perf_counter(), log=lambda m: None)


# ------------------------------------------------------------- imports ----

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    """No file of the benchmark imports JAX or the JAX package (top-level
    names compared whole: geoformer_tpu_torch is the port); the reference
    imports nothing of the port either."""
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "geoformer_tpu_torch" not in tops


def test_forbidden_modules_compared_whole():
    assert run.forbidden_in(["geoformer_tpu_torch.models", "numpy"]) == []
    assert run.forbidden_in(["geoformer_tpu.models"]) == ["geoformer_tpu"]
    assert run.forbidden_in(["jaxlib.xla_client", "flax"]) == ["flax",
                                                               "jaxlib"]


# ---------------------------------------------------------- generators ----

@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**33 + 5])
def test_pair_pool_deterministic(seed):
    a0, a1, H = gen.pair_pool(seed, 4, (64, 96), "cpu")
    b0, b1, H2 = gen.pair_pool(seed, 4, (64, 96), "cpu")
    assert torch.equal(a0, b0) and torch.equal(a1, b1)
    assert torch.equal(H, H2)
    c0, _, _ = gen.pair_pool(seed + 1, 4, (64, 96), "cpu")
    assert not torch.equal(a0, c0)
    assert a0.shape == (4, 64, 96) and float(a0.min()) >= 0 \
        and float(a0.max()) <= 1


def test_pair_pool_warp_follows_H():
    """img1 at H p is img0 at p (bilinear, away from the borders and
    before the photometric jitter)."""
    img0 = gen.textures(2, (64, 96), torch.Generator().manual_seed(3),
                        "cpu")
    H = gen.corner_homographies(2, (64, 96), torch.Generator().manual_seed(4))
    img1 = gen.warp(img0, H)
    p = torch.tensor([30.0, 20.0, 1.0], dtype=torch.float64)
    q = H[0] @ p
    x, y = (q[:2] / q[2]).round().long().tolist()
    back = torch.linalg.inv(H[0]) @ torch.tensor([x, y, 1.0],
                                                 dtype=torch.float64)
    src = back[:2] / back[2]
    x0, y0 = int(src[0]), int(src[1])
    fx, fy = float(src[0]) - x0, float(src[1]) - y0
    want = ((1 - fx) * (1 - fy) * img0[0, y0, x0]
            + fx * (1 - fy) * img0[0, y0, x0 + 1]
            + (1 - fx) * fy * img0[0, y0 + 1, x0]
            + fx * fy * img0[0, y0 + 1, x0 + 1])
    assert abs(float(img1[0, y, x]) - float(want)) < 1e-4


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_training_batches_deterministic(seed):
    a = gen.training_batches(seed, 2, 2, (64, 96), "cpu")
    b = gen.training_batches(seed, 2, 2, (64, 96), "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for x in a:
        eye = x["H_0to1"] @ x["H_1to0"]
        assert torch.allclose(eye / eye[:, 2:, 2:], torch.eye(3).expand(
            2, 3, 3), atol=1e-4)
        assert x["image0"].shape == (2, 64, 96, 1)
        assert x["mask0"].shape == (2, 8, 12)


# -------------------------------------------------------------- counts ----

def test_box_cells_by_hand():
    grid = (4, 5)
    c = torch.tensor([[[0, 0], [2, 1], [4, 3], [-3, 0]]])
    # corner: 3x3; inside: x 0..4 (5) by y 0..3 (4); far corner 3x3; off
    assert counts.box_cells(c, grid) == 9 + 20 + 9 + 0


def test_backbone_flops_by_flop_counter():
    """The backbone count against torch's own count of the reference's
    convolutions at a small size."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import model as ref

    hw = (32, 48)
    W = ref.load_params(str(run.ROOT / "checkpoints/tpu_r3_main/"
                            "params_final.npz"), "cpu")
    with FlopCounterMode(display=False) as fc:
        ref.backbone(W, torch.zeros(1, *hw))
    convs = sum(v for k, v in fc.get_flop_counts()["Global"].items()
                if "convolution" in str(k))
    assert convs == pytest.approx(counts.backbone_flops(hw), rel=1e-12)


def test_backbone_flops_closed_form():
    """(8, 2) ladder at 480x640 by hand: the stem, twelve 3x3 residual
    convolutions, two 1x1 downsamples and the FPN."""
    h2, w2 = 240, 320
    h4, w4, h8, w8 = 120, 160, 60, 80

    def cv(h, w, ci, co, k):
        return 2.0 * h * w * ci * co * k * k

    want = (cv(h2, w2, 1, 128, 7) + 4 * cv(h2, w2, 128, 128, 3)
            + cv(h4, w4, 128, 196, 3) + 3 * cv(h4, w4, 196, 196, 3)
            + cv(h4, w4, 128, 196, 1)
            + cv(h8, w8, 196, 256, 3) + 3 * cv(h8, w8, 256, 256, 3)
            + cv(h8, w8, 196, 256, 1)
            + cv(h8, w8, 256, 256, 1) + cv(h4, w4, 196, 256, 1)
            + cv(h4, w4, 256, 256, 3) + cv(h4, w4, 256, 196, 3)
            + cv(h2, w2, 128, 196, 1) + cv(h2, w2, 196, 196, 3)
            + cv(h2, w2, 196, 128, 3))
    assert counts.backbone_flops((480, 640)) == pytest.approx(want, rel=1e-12)


def test_kernel_bounds_by_hand():
    """K1 and K2 of one pair at a 4x5 grid, bf16: bytes and operations."""
    grid = (4, 5)
    H = torch.eye(3)[None]
    map0 = torch.zeros(1, 20, dtype=torch.bool)
    map0[0, :7] = True
    geo = counts.gam_geometry(H, torch.tensor([True]), map0, map0, 8, grid)
    c1, c0, n0, n1 = geo
    assert float(n0[0]) == 7.0
    cells = counts.box_cells(c1, grid)
    hd = 256
    k1_bytes = 4 * 20 * hd * 2 + 20 * 2 * 4 + 20 * 4 * 4
    k1 = counts.bound_ms(k1_bytes, 4.0 * hd * cells, 989e12)[0]
    k2_bytes = (20 * hd + 2 * 8 * hd) * 2 + 8 + 20 * hd * 4
    k2 = counts.bound_ms(k2_bytes, 4.0 * hd * 20 * 7, 989e12)[0]
    got = counts.gam_kernel_bounds(geo, grid, 8, 2, False, backward=False)
    assert got["K1"] == pytest.approx(4 * k1)
    assert got["K2"] == pytest.approx(4 * k2)
    assert got["K3"] == got["K4"] == got["K5"] == 0.0
    assert counts.bound_ms(3.35e9, 1.0, 1e12) == (pytest.approx(1.0),
                                                  "bytes")


# ------------------------------------------------------- window figures --

class _StubMatcher:
    """Stands for the matcher: each call sleeps the next of ``times``."""

    def __init__(self, times):
        self.times = list(times)

    def match_batch(self, a, b, return_geo=True):
        time.sleep(self.times.pop(0))
        return []


def test_window_rate_and_tail_over_all_calls():
    """The rate is all pairs over the whole window, the p95 that of every
    call, not a median of chunks."""
    r = match_driver.Run({"image_hw": [8, 8]}, {"batch": 2}, 0, "cpu",
                         False, print)
    r.matcher = _StubMatcher([0.01] * 6 + [0.08] * 2 + [0.01] * 60)
    r.order = list(range(8))
    r.pool0 = r.pool1 = [None] * 8
    r.judged = set()

    class _NoCapture:
        keep = None

    r.capture = _NoCapture()
    t0 = time.perf_counter()
    fig = r.window(0.3)
    elapsed = time.perf_counter() - t0
    n = fig["calls"]
    assert n >= 12
    assert fig["match_pairs_per_s"] == pytest.approx(2 * n / elapsed,
                                                     rel=0.05)
    # 2 of 12-18 calls are slow: the 95th percentile sits among them
    assert fig["match_batch_ms_p95"] > 60.0


# ----------------------------------------------------- reference checks --

@pytest.mark.parametrize("hw", [[128, 128], [120, 160]])
def test_reference_follows_the_ports_plain_path(hw):
    """At a tiny size in float32 through the port's plain paths (no
    kernels), the reference agrees with what the program chose at every
    decision, and with its features, to rounding; also where the matcher
    pads the images to its bucket (120x160 runs as 128x192)."""
    res = _execute("bench.match-b8",
                   config_over={"use_bf16": False, "image_hw": hw,
                                "geo": dict(run.load_cell("bench.match-b8")
                                            [1]["geo"], use_pallas=False)})
    c = _numbers(res)
    assert c["judged_coarse"] > 50
    assert max(c["feat_rel"], c["gam_rel"]) < 1e-5
    assert c["coarse_gap_p99"] < 1e-3 and c["fine_gap_p99"] < 1e-3
    assert c["count_rel"] == 0 and c["answers"] == 0
    assert c["ransac_has_H"] == 0 and c["ransac_inliers"] == 0
    assert c["H_px"] < 1e-3
    assert c["fine_err"] < 1e-4
    assert res["correct"]


def test_training_reference_follows_the_port():
    res = _execute("headline.train-b4")
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["loss_gap_step1"] < 1e-5
    assert c["grad_gap"] < 1e-3
    assert c["update_gap_median"] < 1e-3
    assert res["correct"]


# --------------------------------------------------------------- faults --

def test_match_fault_altered_answer(monkeypatch):
    """A returned match moved by one fine step is caught."""
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher

    real = BatchedMatcher.match_batch

    def altered(self, a, b, return_geo=False):
        out = real(self, a, b, return_geo)
        mk1 = out[0][1]
        mk1[: max(1, len(mk1) // 4), 0] += 2.0
        return out

    monkeypatch.setattr(BatchedMatcher, "match_batch", altered)
    res = _execute("bench.match-b8")
    assert not res["correct"]


def test_train_fault_state_unchanged(monkeypatch):
    """A step that returns its state unchanged reads about 1 in
    update_gap_median (leaves below the median change read their share)."""
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    res = _execute("headline.train-b4")
    assert res["checks"]["update_gap_median"]["value"] > 0.9
    assert not res["correct"]


@pytest.mark.parametrize("kind,numbers", [
    ("half", ("count_rel", "feat_rel", "gam_rel")),
    ("drop", ("count_rel", "fine_gap_p99")),
    ("H", ("H_px",)),
    ("coarse", ("coarse_gap_p99",)),
])
def test_match_fault_planted(monkeypatch, kind, numbers):
    """Faults planted in the program (calibrate.match_fault, coarse_fault):
    half of the batch left out, every second fine match dropped, the fit
    moved by 2 pixels, every second coarse match moved off its pick. Each
    fails the numbers named, which the sound run passes."""
    from geoformer_tpu_torch.models import geoformer

    sound = _execute("bench.match-b8")
    if kind == "coarse":
        monkeypatch.setattr(geoformer, "coarse_match",
                            calibrate.coarse_fault(geoformer.coarse_match))
    else:
        monkeypatch.setattr(geoformer.GeoFormer, "forward",
                            calibrate.match_fault(
                                geoformer.GeoFormer.forward, kind))
    res = _execute("bench.match-b8")
    assert not res["correct"]
    for name in numbers:
        assert sound["checks"][name]["value"] <= \
            sound["checks"][name]["limit"]
        assert res["checks"][name]["value"] > res["checks"][name]["limit"]


def test_train_fault_half_batch(monkeypatch):
    """Half the batch left out, the mean taken over the rest."""
    from geoformer_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "make_train_step",
                        calibrate.train_half_batch(trainer.make_train_step))
    res = _execute("headline.train-b4")
    assert not res["correct"]


# ------------------------------------------------------------- controls --

def test_match_control_int8_separates():
    """The control of the bf16 configuration, the program's own int8 path
    (``--int8-full``), reads three times the bf16 program or more on the
    features held against the reference, here at a tiny size on the CPU;
    on the card at the cell's size it comes out not correct
    (test_match_control_on_card)."""
    sound = _numbers(_execute("bench.match-b8"))
    ctrl = _numbers(_execute("bench.match-b8",
                             config_over={"int8_full": True}))
    for name in ("feat_rel", "gam_rel"):
        assert ctrl[name] > 3 * sound[name]


@pytest.mark.cuda
def test_match_control_on_card(cuda_device):
    """The int8 control at the cell's own size on the card comes out not
    correct under the cell's limits."""
    cell, config, mix, bench = run.load_cell("bench.match-b8")
    res = run.execute(cell, calibrate.control_config(config), mix, bench,
                      2**31 + 5, 2.0, False, cuda_device,
                      t_start=time.perf_counter(), log=lambda m: None)
    assert not res["correct"]


@pytest.mark.cuda
def test_train_control_on_card(cuda_device):
    """TF32 on (the control of a float32 configuration) reads above the
    program at a small size on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, config, mix, bench = _tiny("headline.train-b4")
    config = dict(config, image_hw=[128, 160])
    out = {}
    for name, tf32 in (("sound", False), ("control", True)):
        res = run.execute(cell, dict(config, tf32=tf32), mix, bench,
                          2**31 + 5, 1.0, False, cuda_device,
                          t_start=time.perf_counter(), log=lambda m: None)
        out[name] = {k: v["value"] for k, v in res["checks"].items()}
    assert out["control"]["grad_gap"] > 3 * out["sound"]["grad_gap"]
    assert math.isfinite(out["control"]["loss_gap_step1"])
