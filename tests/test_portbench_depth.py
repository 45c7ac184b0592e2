"""The benchmark's depth cell (depth.train-b4) on the CPU, at a small size.

The posed-RGBD generator (portbench/gen_depth.py): the same seed gives the
same batches; each view's depth re-projects into the other view; the
masks are the padded bands; the scale is 2. The port's depth GT
(train/supervision.py through geometry/depth.py) equals the plain
reference's (portbench/reference/depth.py) on those views, and the port's
depth train step follows the reference's within the cell's limits, while
the planted scale fault does not. The depth GT's spans nest inside
train.supervision. The cell resolves its files, and its seven readers read
a made-up summary. The cell runs here at 96x96 (views of 192 pixels,
depth padded to 240) with the trained depth weights, through the port's
CPU paths (no kernels). At 64x64 a pair's fit can put a warped cell
corner on a cell border to the last bit (2.5e-8 cells for seed 7), where
the GAM's windows floor differently in the program and the reference, as
tests/test_torch_port_depth_val.py notes; the 12x12 grid keeps the seed
used here clear.
"""

from __future__ import annotations

import ast
import importlib
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from geoformer_tpu_torch import config as pc
from geoformer_tpu_torch import weights
from geoformer_tpu_torch.geometry.depth import warp_kpts_depth
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.models.coarse_matching import CoarseMatches
from geoformer_tpu_torch.train import supervision as PS
from geoformer_tpu_torch.train import trainer
from geoformer_tpu_torch.train.optim import make_optimizer
from geoformer_tpu_torch.utils import spans
from portbench import calibrate_depth, gen_depth, run
from portbench.reference import depth as RD

BENCH = Path(run.__file__).resolve().parent
CELL = "depth.train-b4"
SEEDS = (0, 2**31 + 11, 2**33 + 5)
ORIG, PAD, DEPTH_PAD = 256, 128, 320          # the GT tests' views
KEYS = ("depth0", "depth1", "T_0to1", "T_1to0", "K0", "K1")


@pytest.fixture(scope="module", params=SEEDS)
def batch(request):
    torch.set_num_threads(4)
    return gen_depth.depth_batches(request.param, 1, 4, ORIG, PAD,
                                   DEPTH_PAD, "cpu")[0]


def _content(mask):
    """(rows, columns) of a view's original image, from its mask."""
    return (int(mask.any(1).sum()) * 16, int(mask.any(0).sum()) * 16)


# ------------------------------------------------------------ generator --

def test_generator_is_deterministic_per_seed():
    a = gen_depth.depth_batches(2**31 + 5, 1, 4, ORIG, PAD, DEPTH_PAD,
                                "cpu")[0]
    b = gen_depth.depth_batches(2**31 + 5, 1, 4, ORIG, PAD, DEPTH_PAD,
                                "cpu")[0]
    c = gen_depth.depth_batches(2**31 + 6, 1, 4, ORIG, PAD, DEPTH_PAD,
                                "cpu")[0]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image0"], c["image0"])


def test_views_are_laid_out_as_the_published_loader_lays_them(batch):
    """Images padded to PAD x PAD with zeros beyond the content, masks of
    the content's cells (a whole band of rows for a landscape view, of
    columns for a portrait one, a quarter of the grid), scale 2, depth at
    the original size padded with zeros, K of the original view; each
    batch holds a landscape and a portrait view; pairs overlap by at least
    0.4 and turn by 5-30 degrees."""
    g = PAD // 8
    shapes = []
    for v in "01":
        for p in range(4):
            m = batch["mask" + v][p]
            h, w = _content(m)
            assert m.sum() == (h // 16) * (w // 16)
            assert {h, w} <= {ORIG, ORIG * 3 // 4} and max(h, w) == ORIG
            if h != w:
                assert m.sum() == g * g * 3 // 4
            shapes.append("landscape" if w > h else
                          "portrait" if h > w else "square")
            img = batch["image" + v][p, ..., 0]
            assert not img[h // 2:].any() and not img[:, w // 2:].any()
            assert img[:h // 2, :w // 2].std() > 0.01
            d = batch["depth" + v][p]
            assert d.shape == (DEPTH_PAD, DEPTH_PAD)
            assert not d[h:].any() and not d[:, w:].any()
            assert (d[:h, :w] > 0).float().mean() > 0.5
            K = batch["K" + v][p]
            assert float(K[0, 2]) == w / 2 and float(K[1, 2]) == h / 2
    assert torch.equal(batch["scale0"], torch.full((4, 2), 2.0))
    assert torch.equal(batch["scale1"], torch.full((4, 2), 2.0))
    assert {"landscape", "portrait"} <= set(shapes)
    assert (batch["overlap"] >= 0.4).all()
    R = batch["T_0to1"][:, :3, :3].double()
    angle = torch.rad2deg(torch.arccos(
        ((R.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2).clamp(-1, 1)))
    assert ((angle > 4.99) & (angle < 30.01)).all()
    eye = batch["T_0to1"] @ batch["T_1to0"]
    assert torch.allclose(eye, torch.eye(4).expand(4, 4, 4), atol=1e-5)


def test_generator_refuses_views_it_cannot_lay_out():
    with pytest.raises(ValueError):
        gen_depth.depth_batches(0, 1, 4, ORIG, PAD + 8, DEPTH_PAD, "cpu")
    with pytest.raises(ValueError):
        gen_depth.depth_batches(0, 1, 4, ORIG, PAD, ORIG - 1, "cpu")


def test_depth_reprojects_into_the_other_view(batch):
    """A pixel of view 0, lifted by its depth and moved into view 1, comes
    back to itself within 0.5 px when lifted again by view 1's depth where
    it lands (inverse depth interpolated bilinearly: exact on a plane):
    for at least 99.5 % of the points that view 1 sees (all four pixels
    around them with depth, and that depth the point's own within 1 %)."""
    for p in range(4):
        h0, w0 = _content(batch["mask0"][p])
        h1, w1 = _content(batch["mask1"][p])
        d0 = batch["depth0"][p, :h0, :w0].double()
        d1 = batch["depth1"][p, :h1, :w1].double()
        K0, K1 = batch["K0"][p].double(), batch["K1"][p].double()
        T01, T10 = batch["T_0to1"][p].double(), batch["T_1to0"][p].double()
        ys, xs = torch.meshgrid(torch.arange(h0, dtype=torch.float64),
                                torch.arange(w0, dtype=torch.float64),
                                indexing="ij")
        pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)[d0 > 0]
        X = pix @ torch.linalg.inv(K0).T * d0[d0 > 0][:, None]
        Y = X @ T01[:3, :3].T + T01[:3, 3]
        q = Y @ K1.T
        q = q[:, :2] / q[:, 2:]
        inside = ((q[:, 0] >= 0) & (q[:, 0] < w1 - 1) & (q[:, 1] >= 0)
                  & (q[:, 1] < h1 - 1) & (Y[:, 2] > 0))
        inv = torch.where(d1 > 0, 1 / d1, torch.zeros_like(d1))
        x0 = q[:, 0].floor().clamp(0, w1 - 2).long()
        y0 = q[:, 1].floor().clamp(0, h1 - 2).long()
        fx, fy = q[:, 0] - x0, q[:, 1] - y0
        around = torch.stack([d1[y0, x0], d1[y0, x0 + 1], d1[y0 + 1, x0],
                              d1[y0 + 1, x0 + 1]], -1)
        z1 = 1 / (inv[y0, x0] * (1 - fx) * (1 - fy)
                  + inv[y0, x0 + 1] * fx * (1 - fy)
                  + inv[y0 + 1, x0] * (1 - fx) * fy
                  + inv[y0 + 1, x0 + 1] * fx * fy)
        seen = inside & (around > 0).all(-1) & \
            ((z1 - Y[:, 2]).abs() < 0.01 * Y[:, 2])
        X1 = torch.cat([q, torch.ones_like(q[:, :1])], -1) \
            @ torch.linalg.inv(K1).T * z1[:, None]
        back = (X1 @ T10[:3, :3].T + T10[:3, 3]) @ K0.T
        err = ((back[:, :2] / back[:, 2:]) - pix[:, :2]).norm(dim=-1)[seen]
        assert seen.sum() > 0.5 * inside.sum() > 1000
        assert float((err < 0.5).double().mean()) >= 0.995
        assert float(err.median()) < 1e-3


# ---------------------------------------------------- GT against the port --

def test_coarse_depth_gt_equals_the_reference(batch):
    hw = (PAD, PAD)
    pj, pv = PS.spvs_coarse_depth_sparse(
        *(batch[k] for k in KEYS), hw, 8, batch["mask0"], batch["mask1"],
        batch["scale0"], batch["scale1"])
    rj, rv = RD.coarse_gt(batch, (PAD // 8, PAD // 8))
    assert int(rv.sum()) > 100
    assert not (rv & (batch["mask0"].reshape(4, -1) == 0)).any()
    assert torch.equal(pv, rv)
    assert torch.equal(pj[pv], rj[rv])


def _matches(batch, seed):
    """64 matches a pair: the reference's GT cells moved by up to a cell,
    the first eight on the grid's first row and column."""
    g = PAD // 8
    gt_j, gt_valid = RD.coarse_gt(batch, (g, g))
    gen = torch.Generator().manual_seed(seed)
    i = torch.randint(0, g * g, (4, 64), generator=gen)
    i[:, :8] = torch.tensor([0, 1, 2, g, 2 * g, g + 1, g - 1, 2 * g - 1])
    j = torch.gather(torch.where(gt_valid, gt_j, 0), 1, i)
    j = (j + torch.randint(-1, 2, j.shape, generator=gen)).clamp(0, g * g - 1)
    return i, j


def test_fine_depth_labels_equal_the_reference(batch):
    i, j = _matches(batch, 3)
    m = CoarseMatches(None, i, j, torch.ones_like(i, dtype=torch.bool),
                      torch.zeros(i.shape))
    got = PS.spvs_fine_depth(m, batch["depth0"], batch["depth1"],
                             batch["T_0to1"], batch["K0"], batch["K1"],
                             PAD // 8, PAD // 8, 8, 2, 5,
                             scale0=batch["scale0"], scale1=batch["scale1"])
    want = RD.fine_labels(i, j, batch, PAD // 8)
    assert want.sum() > 20
    assert torch.equal(got, want)


def test_the_warp_follows_the_published_rules():
    """A keypoint off depth0's map, and one that lands where depth1 is 0,
    are invalid (the published warp_kpts); the reference agrees."""
    d = torch.full((1, 20, 30), 5.0)
    d1 = d.clone()
    d1[0, :, 20:] = 0.0
    K = torch.tensor([[[20.0, 0, 15], [0, 20.0, 10], [0, 0, 1]]])
    T = torch.eye(4)[None]
    k = torch.tensor([[[-1.0, 5.0], [5.0, 5.0], [25.0, 5.0], [29.4, 5.0]]])
    for warp in (warp_kpts_depth, RD.warp_kpts):
        valid, _ = warp(k, d, d1, T, K, K)
        assert valid.tolist() == [[False, True, False, False]]


# ------------------------------------------------------ the cell, small --

def _small_cell(**mix_over):
    cell, config, mix, bench = run.load_cell(CELL)
    config = dict(config, image_hw=[96, 96], depth_pad=240)
    mix = dict(mix, batch=2, batches=2, warmup_steps=4, log_every=2,
               orig_long_edge=192, **mix_over)
    return cell, config, mix, bench


def _execute():
    torch.set_num_threads(4)
    cell, config, mix, bench = _small_cell()
    return run.execute(cell, config, mix, bench, 2**31 + 77, 0.5, False,
                       "cpu", t_start=time.perf_counter(),
                       log=lambda m: None)


def test_the_depth_step_follows_the_reference():
    res = _execute()
    assert res["correct"], res["checks"]
    assert res["record"]["overlap_min"] >= 0.4
    assert res["metrics"]["train_pairs_per_s"]["value"] > 0


def test_the_scale_fault_fails_the_check(monkeypatch):
    """The depth GT taken without scale0/scale1 (at the resized
    resolution) fails the comparison the sound step passes."""
    monkeypatch.setattr(trainer, "_depth_losses",
                        calibrate_depth.scale_fault(trainer._depth_losses))
    res = _execute()
    assert not res["correct"]
    assert res["checks"]["loss_gap_step1"]["value"] > \
        res["checks"]["loss_gap_step1"]["limit"]


def test_a_program_without_the_published_warp_exits_at_once(monkeypatch):
    """The driver's probe holds on the program; a depth warp that counts
    every keypoint valid (as one without the published rules does on the
    probe's off-map and zero-depth keypoints) makes the run exit before
    set-up builds anything."""
    from geoformer_tpu_torch.geometry import depth as PD
    from portbench.drivers import depth_train

    assert depth_train.warps_as_published()

    def all_valid(kpts0, *rest):
        return torch.ones(kpts0.shape[:2], dtype=torch.bool), kpts0

    monkeypatch.setattr(PD, "warp_kpts_depth", all_valid)
    assert not depth_train.warps_as_published()
    cell, config, mix, bench = _small_cell()
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="cannot be run on it"):
        run.execute(cell, config, mix, bench, 5, 0.5, False, "cpu",
                    log=lambda m: None)
    assert time.perf_counter() - t0 < 5.0


def test_depth_gt_spans_nest_inside_the_supervision():
    """Under a recording, each depth train step records depth.coarse_gt
    then depth.fine_gt as the only children of train.supervision, and no
    counter reading under them; the step's scalars are those of a step
    taken without the recording."""
    cfg = pc.GeoFormerConfig(
        backbone=pc.BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=pc.CoarseTransformerConfig(
            d_model=32, nhead=4, layer_names=("self", "cross") * 2),
        fine=pc.FineTransformerConfig(d_model=16, nhead=2),
        match=pc.MatchConfig(thr=1e-4, max_matches=64,
                             force_one_match=True),
        geo=pc.GeoModuleConfig(nhead=2, ransac_iters=32, max_inliers=64),
        fine_match=pc.FineMatchConfig(thr=1e-3))
    b = gen_depth.depth_batches(7, 1, 2, 128, 64, 160, "cpu")[0]
    b = {k: v for k, v in b.items() if k != "overlap"}
    tc = pc.TrainConfig(batch_size=2, image_hw=(64, 64))
    out = []
    for on in (False, True):
        model = weights.random_init(GeoFormer(cfg), seed=1)
        state = trainer.TrainState(model, make_optimizer(
            tc.optim, model.parameters()))
        step = trainer.make_depth_train_step(tc)
        gen = torch.Generator().manual_seed(0)
        if on:
            with spans.recording(syncs=True) as rec:
                sc = step(state, b, 1e-4, generator=gen)
        else:
            sc = step(state, b, 1e-4, generator=gen)
        out.append({k: float(v) for k, v in sc.items()})
    assert out[0] == out[1]
    names = [s.name for s in rec.spans]
    sup = names.index("train.supervision")
    kids = [s.name for s in rec.spans if s.parent == sup]
    assert kids == ["depth.coarse_gt", "depth.fine_gt"]
    assert rec.spans[sup].parent == names.index("train.step")
    assert not [k for k in rec.counts
                if k[1] >= 0 and rec.spans[k[1]].name.startswith("depth.")]


# -------------------------------------------------- files and readers --

def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ["gen_depth.py", "reference/depth.py",
                                  "drivers/depth_train.py",
                                  "calibrate_depth.py"])
def test_no_jax_and_the_reference_stands_alone(name):
    tops = set(_imports(BENCH / name))
    assert not tops & {"jax", "jaxlib", "flax", "geoformer_tpu"}
    if name in ("gen_depth.py", "reference/depth.py"):
        assert "geoformer_tpu_torch" not in tops


READERS = ("forward_ms.train", "supervision_ms.depth", "backward_ms.depth",
           "gam_kernels_roofline.train", "mfu.train",
           "device.idle_share.train", "host_syncs.depth")


def test_the_cell_resolves_its_files():
    cell, config, mix, bench = run.load_cell(CELL)
    assert cell["config"] == "geoformer-depth-640" and cell["chips"] == 1
    assert config["image_hw"] == [640, 640] and config["depth_pad"] == 2000
    assert (run.ROOT / config["weights"]).is_file()
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    assert driver.__name__ == "portbench.drivers.depth_train"
    assert set(run.limits_of(CELL)) == {"loss_gap_step1", "grad_gap",
                                        "update_gap_median"}
    e2e, per = run.cell_metrics(bench, cell)
    assert {m["name"] for m in e2e} == {"train_pairs_per_s", "peak_gib",
                                        "setup_s"}
    assert sorted(m["name"] for m in per) == sorted(READERS)
    for m in per:
        assert callable(run._metric_reader(m["name"]))


def _made_up():
    return {"batches": 4, "stage_ms": {"backbone": 400.0, "gam": 40.0,
                                       "coarse_transformer": 80.0,
                                       "coarse_match_1": 10.0,
                                       "coarse_match_2": 10.0, "fine": 60.0},
            "span_device_ms": {"train.supervision": 1.0,
                               "depth.coarse_gt": 6.0, "depth.fine_gt": 5.0,
                               "train.loss": 30.0},
            "backward_device_ms": 1200.0, "gam_bound_ms": 1.0,
            "gam_kernel_ms": 4.0, "flops": 6.7e12, "untraced_s": 2.0,
            "peak_flops": 67e12, "busy_s": 1.8, "window_s": 2.0,
            "host_syncs": 40.0}


@pytest.mark.parametrize("name,want", [
    ("forward_ms.train", 150.0), ("supervision_ms.depth", 3.0),
    ("backward_ms.depth", 300.0), ("gam_kernels_roofline.train", 25.0),
    ("mfu.train", 5.0), ("device.idle_share.train", 10.0),
    ("host_syncs.depth", 10.0)])
def test_each_reader_reads_a_made_up_summary(name, want):
    read = run._metric_reader(name)
    assert math.isclose(read(_made_up()), want, rel_tol=1e-9)
    empty = {"batches": 4, "stage_ms": {}, "kernel_ms": {}}
    assert read(empty) is None


def test_the_supervision_reader_takes_a_program_without_depth_spans():
    """The parent's program has train.supervision and no depth spans."""
    s = _made_up()
    s["span_device_ms"] = {"train.supervision": 12.0}
    assert run._metric_reader("supervision_ms.depth")(s) == 3.0


def test_limits_are_finite_and_positive():
    lim = run.limits_of(CELL)
    assert all(np.isfinite(v) and v > 0 for v in lim.values())
