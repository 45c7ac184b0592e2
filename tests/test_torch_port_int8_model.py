"""The eval-only int8 paths of the port against the JAX package on the CPU.

Layers: both int8 backbone ladders, EncoderLayer(int8) with each attention
kind, and the GAM's int8 cross layer against JAX's box_window_call with
the Pallas kernel K1 in interpret mode. The whole forward: `--int8` (int8
backbone, float GAM) and `--int8-full` (int8 everywhere, the GAM too) on
the trained checkpoint (checkpoints/tpu_r3_main) at 96x128 against the
JAX CPU forward, f32, the GAM's RANSAC draws injected, on the port's box
and gather paths. Entry points: `cli infer --int8-full`, the int8
self-check and `cli export --int8-full`'s bundle.

Bars. The integer products are exact in both packages
(test_torch_port_quantize), but a float input that differs by an ulp
(XLA:CPU contracts a*b+c into one FMA, the port rounds twice; sums in
another order) can cross a rounding boundary of its quantum, which moves
that element by one quantum (amax / 127), and the next layers carry it.
So: single layers at 2e-3 abs; a ladder's outputs within LADDER_QUANTA
quanta of its amax (measured within 2 on the small random ladders); the
whole forward: has_H equal, coarse match sets overlapping >= 0.9
(measured 0.970-1.0), inlier counts within 5 % (measured 0-3 of 120-192),
at least 80 % of the common fine matches within 0.05 px of JAX's
(measured 0.843-0.961; a moved one moves by whole fine cells) and none
more than the window's 8 px. The GAM on JAX's own inputs: 1e-4 with a
float GAM (measured 7.6e-6); under `--int8-full` GAM_GAP (measured 0.082
on both paths, |x| ~ 1). The box path quantizes k_proj's input over the
whole source token set (as the JAX TPU path does), the gather path over
the gathered windows (as the JAX CPU path does); the two scales differ
only where the largest token lies in no window, which the GAM test with
an injected outlier token covers, and which did not occur here.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.models import backbone as jbb  # noqa: E402
from geoformer_tpu.models import transformer as jtr  # noqa: E402
from geoformer_tpu.ops import pallas_attention as jpa  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu_torch import cli, weights  # noqa: E402
from geoformer_tpu_torch.config import BackboneConfig  # noqa: E402
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.eval import selfcheck  # noqa: E402
from geoformer_tpu_torch.geometry.homography import (  # noqa: E402
    sample_homography,
    sample_homography_draws,
)
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.models import transformer as ttr  # noqa: E402
from geoformer_tpu_torch.models.backbone import build_backbone  # noqa: E402
from geoformer_tpu_torch.models.coarse_matching import CoarseMatches  # noqa: E402
from geoformer_tpu_torch.ops import gam_kernels  # noqa: E402
from geoformer_tpu_torch.serving import export as serving  # noqa: E402
from torch_port_util import (  # noqa: E402
    assert_close,
    flatten,
    jax_forward_and_draws,
    n,
    port_config,
    small_config,
    smooth_images,
    t,
)

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
B, HW = 2, (96, 128)
LAYER_ATOL = 2e-3
LADDER_QUANTA = 4
# the whole int8 forward against JAX's (module docstring)
OVERLAP, INLIER_SLACK, KP_SAME, KP_WINDOW = 0.9, 0.05, 0.8, 8.0
GAM_GAP = {"box": 0.25, "gather": 0.25}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's torch work on one thread: under the suite's parallel
    workers the int8 path's elementwise passes thrash when every worker
    runs one thread a core. Restored after the test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int8(cfg, full: bool):
    r = dataclasses.replace
    return cfg.replace(backbone=r(cfg.backbone, int8=True),
                       coarse=r(cfg.coarse, int8=full),
                       fine=r(cfg.fine, int8=full),
                       geo=r(cfg.geo, int8=full))


# ---------------------------------------------------------------- layers --

@pytest.mark.parametrize("ladder", ["8_2", "16_4"])
def test_int8_ladder_matches_jax(ladder):
    """Every convolution of the ladder is an Int8Conv (each equals JAX's
    int8_conv bit for bit on the same input: test_torch_port_quantize);
    the ladder's outputs are within LADDER_QUANTA quanta (amax / 127) of
    the JAX ladder's."""
    from geoformer_tpu_torch.models.layers import Conv, Int8Conv

    dims = (16, 24, 32) if ladder == "8_2" else (16, 24, 32, 40)
    res = (8, 2) if ladder == "8_2" else (16, 4)
    x = np.random.default_rng(0).random((2, 64, 96, 1)).astype(np.float32)
    jm = jbb.build_backbone(jcfg.BackboneConfig(
        initial_dim=16, block_dims=dims, resolution=res, int8=True))
    var = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    # non-trivial running statistics
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        var["batch_stats"])
    var = {"params": var["params"], "batch_stats": stats}
    refs = jax.jit(jm.apply)(var, jnp.asarray(x))
    tm = build_backbone(BackboneConfig(initial_dim=16, block_dims=dims,
                                       resolution=res, int8=True))
    tm = weights.load_jax_params(tm, flatten(var)).eval()
    convs = [m for m in tm.modules() if isinstance(m, Conv)]
    assert len(convs) == (22 if ladder == "8_2" else 27)
    assert all(isinstance(m, Int8Conv) for m in convs)
    with torch.no_grad():
        got = tm(t(x))
    for g, r in zip(got, refs):
        assert g.shape == r.shape
        quantum = np.abs(np.asarray(r)).max() / 127
        assert np.abs(n(g) - np.asarray(r)).max() <= LADDER_QUANTA * quantum
    with pytest.raises(ValueError, match="eval-only"):
        tm(t(x), train=True)


@pytest.mark.parametrize("attention", ["full", "linear", "linear_flat"])
def test_int8_encoder_layer_matches_jax(attention):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    src = rng.normal(size=(2, 10, 16)).astype(np.float32)
    sm = rng.random((2, 10)) > 0.3
    jl = jtr.EncoderLayer(16, 2, attention, mlp_act="tanh", int8=True)
    var = jl.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(src))
    ref = jl.apply(var, jnp.asarray(x), jnp.asarray(src), None,
                   jnp.asarray(sm))
    tl = ttr.EncoderLayer(16, 2, attention, mlp_act="tanh", int8=True)
    weights.load_jax_params(tl, flatten(var))
    got = tl(t(x), t(src), None, t(sm))
    assert_close(got, ref, 0, LAYER_ATOL)


def test_int8_gam_cross_layer_matches_pallas_box_window_call(monkeypatch):
    """The int8 cross layer on the box path against JAX's box_window_call
    with the Pallas kernel K1 in interpret mode: both quantize k_proj's
    input over the whole source token set."""
    hg, wg, d = 8, 8, 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, d)).astype(np.float32)
    src = rng.normal(size=(2, hg * wg, d)).astype(np.float32)
    src[1, 5] *= 6.0       # a large token that lies in no window of batch 1
    centers = np.stack([rng.integers(2, wg, size=(2, 40)),
                        rng.integers(2, hg, size=(2, 40))],
                       -1).astype(np.int32)
    jl = jtr.EncoderLayer(d, 2, "full", mlp_act="tanh", int8=True)
    var = jl.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(src))
    forward = jpa._box_forward

    def interpret(q, k, v, c, grid, r, fill, q_tile, kv_tile, **kw):
        return forward(q, k, v, c, grid, r, fill, 8, 8, interpret=True,
                       force_tiled=True)

    monkeypatch.setattr(jpa, "_box_forward", interpret)
    ref = jl.apply(var, jnp.asarray(x), jnp.asarray(src),
                   jnp.asarray(centers), (hg, wg), 2,
                   method=jtr.EncoderLayer.box_window_call)
    tl = ttr.EncoderLayer(d, 2, "full", mlp_act="tanh", int8=True)
    weights.load_jax_params(tl, flatten(var))
    got = tl.box_window_call(t(x), t(src), t(centers), (hg, wg), 2)
    assert_close(got, ref, 0, LAYER_ATOL)


# ----------------------------------------------------------- the forward --

def _trained_pairs():
    """Two self-check pairs at HW: procedural textures from the seed and
    their warps by homographies from a seeded generator."""
    base = native.native_textures(B, *HW, 123456)
    gen = torch.Generator().manual_seed(0)
    Hs = sample_homography(sample_homography_draws(B, HW, gen), HW).numpy()
    warped = native.native_warp(base, Hs)
    return (base[..., None].astype(np.float32),
            warped[..., None].astype(np.float32), Hs)


@pytest.fixture(scope="module", params=["int8", "int8_full"])
def run(request):
    """The trained checkpoint at the self-check's configuration (fewer
    matches, hypotheses and inliers, 96x128) through the JAX forward."""
    if not CKPT.is_file():
        pytest.skip(f"no trained checkpoint at {CKPT}")
    cfg = _int8(jcfg.GeoFormerConfig(
        match=jcfg.MatchConfig(max_matches=256),
        geo=jcfg.GeoModuleConfig(ransac_iters=64, max_inliers=256)),
        request.param == "int8_full")
    img0, img1, Hs = _trained_pairs()
    variables = load_variables(str(CKPT))
    out, sample_idx, inter = jax_forward_and_draws(
        cfg, variables, img0, img1, jax.random.key(0), intermediates=True)
    return dict(mode=request.param, cfg=cfg, flat=flatten(variables),
                img0=img0, img1=img1, Hs=Hs, out=out, sample_idx=sample_idx,
                inter=inter)


def _port(run, box: bool):
    pcfg = port_config(run["cfg"])
    pcfg = pcfg.replace(geo=dataclasses.replace(pcfg.geo, use_pallas=box))
    return weights.load_jax_params(GeoFormer(pcfg), run["flat"]).eval()


def _pairs(m, b):
    v = n(m.valid[b]).astype(bool)
    return set(zip(n(m.i_ids[b])[v].tolist(), n(m.j_ids[b])[v].tolist()))


def _hold_to_jax(out, ref):
    """The int8 forward bar against the JAX forward (see the module
    docstring); returns the measured numbers."""
    np.testing.assert_array_equal(n(out.geo.has_H), np.asarray(ref.geo.has_H))
    rec = []
    for b in range(B):
        pr, pp = _pairs(ref.matches, b), _pairs(out.matches, b)
        overlap = len(pr & pp) / max(len(pr | pp), 1)
        inl, ref_inl = int(out.geo.num_inliers[b]), int(ref.geo.num_inliers[b])
        sel = (np.asarray(ref.fine.valid[b]) & n(out.fine.valid[b])
               & (np.asarray(ref.matches.i_ids[b]) == n(out.matches.i_ids[b])))
        d = np.maximum(
            np.abs(n(out.fine.mkpts0[b]) - np.asarray(ref.fine.mkpts0[b])),
            np.abs(n(out.fine.mkpts1[b]) - np.asarray(ref.fine.mkpts1[b]))
        ).max(-1)[sel]
        rec.append((overlap, inl, ref_inl, float((d < 0.05).mean()),
                    float(d.max())))
        assert overlap >= OVERLAP, rec
        assert abs(inl - ref_inl) <= INLIER_SLACK * ref_inl, rec
        assert sel.sum() > 50, rec
        assert (d < 0.05).mean() >= KP_SAME, rec
        assert d.max() <= KP_WINDOW, rec
    return rec


@pytest.mark.parametrize("path", ["box", "gather"])
def test_int8_forward_matches_jax(run, path):
    model = _port(run, path == "box")
    gam_kernels.reset_launch_counts()
    with torch.no_grad():
        out = model(t(run["img0"]), t(run["img1"]),
                    sample_idx=t(run["sample_idx"]))
    assert np.asarray(run["out"].geo.has_H).all()
    _hold_to_jax(out, run["out"])
    assert not any(gam_kernels.LAUNCHES.values())


@pytest.mark.parametrize("path", ["box", "gather"])
def test_int8_gam_features_against_the_jax_cpu_path(run, path):
    """The GAM on JAX's CNN features and first-pass matches, against the
    JAX CPU (gather) path. --int8 leaves the GAM in float: 1e-4. Under
    --int8-full both port paths are a few quanta off (ulp-level
    differences cross rounding boundaries, then pass through four
    layers), and the box path's k_proj scale covers the whole source
    token set: GAM_GAP bounds each."""
    model = _port(run, path == "box")
    cnn = t(np.asarray(run["inter"]["backbone"]["__call__"][0][0]))
    j1 = jax_first_pass(run)
    matches = CoarseMatches(None, t(j1.i_ids).long(), t(j1.j_ids).long(),
                            t(j1.valid), t(j1.mconf))
    with torch.no_grad():
        g0, g1, _ = model.geo_module(cnn[:B], cnn[B:], matches, 8,
                                     sample_idx=t(run["sample_idx"]))
    r0, r1, _ = run["inter"]["geo_module"]["__call__"][0]
    gap = max(np.abs(n(g0) - np.asarray(r0)).max(),
              np.abs(n(g1) - np.asarray(r1)).max())
    bar = GAM_GAP[path] if run["mode"] == "int8_full" else 1e-4
    assert gap <= bar, (run["mode"], path, gap)


def jax_first_pass(run):
    """JAX's first-pass matches from its coarse transformer's output."""
    from geoformer_tpu.models.coarse_matching import coarse_match

    cfg = run["cfg"]
    f0, f1 = run["inter"]["loftr_coarse"]["__call__"][0]
    return coarse_match(f0, f1, cfg.match.thr, cfg.match.dsmax_temperature,
                        cfg.match.max_matches, streaming=True)


def test_int8_train_forward_raises(run):
    model = _port(run, True)
    with pytest.raises(ValueError, match="eval-only"):
        model(t(run["img0"]), t(run["img1"]), train=True)


def test_the_int8_selfcheck_matches_and_fits(run):
    """The self-check's match_pairs with the int8 model and JAX's draws
    gives the forward's match counts (within 10 %); with --int8-full, its
    fits find both homographies within 3 px."""
    model = _port(run, True)
    matches, _ = selfcheck.match_pairs(model, run["img0"][..., 0],
                                       run["img1"][..., 0], "cpu",
                                       gam_sample_idx=run["sample_idx"])
    ref = run["out"].fine
    for b, (p0, p1) in enumerate(matches):
        v = np.asarray(ref.valid[b])
        assert abs(len(p0) - v.sum()) <= 0.1 * v.sum()
    if run["mode"] == "int8_full":
        dists, _ = selfcheck.fit_pairs(matches, run["Hs"], HW, device="cpu")
        assert np.isfinite(dists).all() and max(dists) < 3.0, dists


# ---------------------------------------------------------- entry points --

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from geoformer_tpu_torch.utils.plotting import write_png

    d = tmp_path_factory.mktemp("int8_pair")
    img0, img1 = smooth_images(np.random.default_rng(4), 1, 96, 128)
    for name, im in (("a.png", img0), ("b.png", img1)):
        write_png(str(d / name), (im[0, :, :, 0] * 255).astype(np.uint8))
    return d


def test_cli_infer_int8_full_runs_the_int8_model(pair, monkeypatch, capsys):
    """`infer --int8-full` builds the int8 model, and its matches are that
    model's through the BatchedMatcher."""
    built = {}
    real = cli._model

    def spy(args):
        cfg, model = real(args)
        built.update(cfg=cfg, model=model)
        return cfg, model

    monkeypatch.setattr(cli, "_model", spy)
    out = pair / "m.npy"
    argv = ["infer", str(pair / "a.png"), str(pair / "b.png"), "--imsize",
            "64", "--max-matches", "64", "--gam-ransac-iters", "32",
            "--gam-max-inliers", "64", "--ckpt", str(CKPT), "--pallas",
            "--int8-full", "--device", "cpu", "--out", str(out)]
    cli.main(argv)
    cfg = built["cfg"]
    assert cfg.backbone.int8 and cfg.coarse.int8 and cfg.fine.int8 \
        and cfg.geo.int8
    got = np.load(out)
    assert got.ndim == 2 and got.shape[1] == 5 and len(got) > 0
    assert np.isfinite(got).all()
    assert "matches in" in capsys.readouterr().out


def test_the_int8_selfcheck_configs():
    c = selfcheck.selfcheck_config(int8=True)
    assert c.backbone.int8 and not (c.coarse.int8 or c.fine.int8
                                    or c.geo.int8)
    c = selfcheck.selfcheck_config(bf16=True, pallas=True, int8_full=True)
    assert c.backbone.int8 and c.coarse.int8 and c.fine.int8 and c.geo.int8
    assert c.use_bf16 and c.geo.use_pallas and c.match.max_matches == 1024


def test_cli_export_int8_full_bundle_round_trip(tmp_path, monkeypatch,
                                                capsys):
    """`cli export --int8-full`: the command's int8 flags reach the model,
    the quantization is lowered into the program (aten._int_mm nodes), and
    the loaded bundle gives the eager int8 forward's matches with the same
    RANSAC noise. The exported model takes the command's config at the
    narrow widths of small_config with one self/cross pair a stack
    (tracing the default widths' int8 graph takes minutes on a CPU; the
    op count, not the width, sets that cost)."""
    real = cli._model
    built = {}

    def narrow(args):
        cfg, _ = real(args)
        base = port_config(small_config())
        small = base.replace(
            match=cfg.match,
            coarse=dataclasses.replace(base.coarse,
                                       layer_names=("self", "cross")),
            geo=dataclasses.replace(
                base.geo, layer_names=("self", "cross"),
                use_pallas=cfg.geo.use_pallas,
                ransac_iters=cfg.geo.ransac_iters,
                max_inliers=cfg.geo.max_inliers, int8=cfg.geo.int8))
        small = _int8(small, cfg.coarse.int8)
        assert cfg.backbone.int8 and cfg.fine.int8 == cfg.coarse.int8
        built["cfg"] = small
        built["model"] = weights.random_init(GeoFormer(small), seed=0)
        return small, built["model"]

    monkeypatch.setattr(cli, "_model", narrow)
    out = tmp_path / "b8.gfmz"
    cli.main(["export", "--out", str(out), "--platforms", "cpu",
              "--int8-full", "--height", "64", "--width", "80", "--pallas",
              "--max-matches", "32", "--gam-ransac-iters", "16",
              "--gam-max-inliers", "32", "--match-thr", "1e-4"])
    assert "serving bundle (1x64x80" in capsys.readouterr().out
    served = serving.load_bundle(str(out))
    for part in ("backbone", "coarse", "fine", "geo"):
        assert served.manifest["config"][part]["int8"] is True
    targets = {str(node.target) for node in served.program.graph.nodes}
    assert "aten._int_mm.default" in targets
    cfg, model = built["cfg"], built["model"].eval()
    img0, img1 = smooth_images(np.random.default_rng(5), 1, 64, 80)
    got = served(img0, img1)
    with torch.no_grad():
        ref = model(t(img0), t(img1), torch.ones(1, 8, 10),
                    torch.ones(1, 8, 10),
                    ransac_noise=serving.ransac_noise(cfg, 1)).fine
    assert n(ref.valid).any()
    np.testing.assert_array_equal(got["valid"], n(ref.valid))
    np.testing.assert_array_equal(got["mkpts0"], n(ref.mkpts0))
    np.testing.assert_array_equal(got["mkpts1"], n(ref.mkpts1))
    json.dumps(served.manifest)
