"""The port's whole inference forward against the JAX forward on the CPU.

Both run the same narrow model (tests/torch_port_util.small_config) with the
same JAX-initialized weights on the same seeded image pair, in f32. The JAX
CPU forward takes the GAM's gather path and plain full attention; the port
is held against it on both of its paths: the box path (K1 and K2, which on
the CPU are their plain versions) and the gather path. RANSAC hypotheses are
drawn with JAX exactly as the JAX forward draws them and injected.

Tolerances: first-pass matches, RANSAC inliers and has_H exactly; H at
1e-3 rel / 1e-3 abs; GAM features at 1e-4 rel / 1e-4 abs; the final
matches by the bar of __graft_entry__.py (match sets overlap >= 0.9,
keypoints of common matches within 0.05 px).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.models.coarse_matching import (  # noqa: E402
    coarse_match as j_coarse_match,
)
from geoformer_tpu_torch.eval.matcher import BatchedMatcher  # noqa: E402
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.models.coarse_matching import CoarseMatches  # noqa: E402
from geoformer_tpu_torch.models.position import add_position_encoding  # noqa: E402
from geoformer_tpu_torch.ops import gam_kernels  # noqa: E402
from geoformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import (  # noqa: E402
    assert_close,
    flatten,
    n,
    port_config,
    small_config,
    smooth_images,
    t,
)
from torch_port_util import one_torch_thread  # noqa: E402,F401

B, H, W = 2, 64, 80


def _jax_forward(cfg, variables, img0, img1, key, mask0=None, mask1=None):
    """GeoFormer.apply with intermediates, the first-pass matches and the
    RANSAC samples the forward drew."""
    model = JGeoFormer(cfg)
    m = (None, None) if mask0 is None else (jnp.asarray(mask0),
                                            jnp.asarray(mask1))
    out, st = jax.jit(lambda v, a, b, k, m0, m1: model.apply(
        v, a, b, m0, m1, rngs={"ransac": k}, capture_intermediates=True,
        mutable=["intermediates"]))(variables, jnp.asarray(img0),
                                    jnp.asarray(img1), key, *m)
    inter = st["intermediates"]
    f0, f1 = inter["loftr_coarse"]["__call__"][0]
    flat_m = [None if x is None else x.reshape(B, -1) for x in m]
    matches1 = j_coarse_match(f0, f1, cfg.match.thr,
                              cfg.match.dsmax_temperature,
                              cfg.match.max_matches, *flat_m,
                              streaming=True)
    # the key GeoFormer.__call__ takes with make_rng("ransac"), split per
    # batch row as _build_geo_state splits it; then ransac.py:110-112
    rkey = model.apply(variables, method=lambda mod: mod.make_rng("ransac"),
                       rngs={"ransac": key})
    keys = jax.random.split(rkey, B)
    iters = cfg.geo.ransac_iters

    def draw(k, v):
        g = jax.random.gumbel(k, (iters, v.shape[0]))
        return jax.lax.top_k(jnp.where(v[None, :], g, -jnp.inf), 4)[1]

    sample_idx = np.asarray(jax.vmap(draw)(keys, matches1.valid))
    return dict(out=out, inter=inter, matches1=matches1,
                sample_idx=sample_idx)


@pytest.fixture(scope="module")
def run():
    cfg = small_config()
    img0, img1 = smooth_images(np.random.default_rng(0), B, H, W)
    key = jax.random.key(0)
    variables = jax.jit(JGeoFormer(cfg).init)(
        {"params": key, "ransac": key}, jnp.asarray(img0[:1]),
        jnp.asarray(img0[:1]))
    ref = _jax_forward(cfg, variables, img0, img1, jax.random.key(5))
    return dict(cfg=cfg, flat=flatten(variables), img0=img0, img1=img1,
                variables=variables, **ref)


def _port(run, use_pallas):
    pcfg = port_config(run["cfg"])
    pcfg = pcfg.replace(geo=dataclasses.replace(pcfg.geo,
                                                use_pallas=use_pallas))
    return load_jax_params(GeoFormer(pcfg), run["flat"])


def _pairs(m, b):
    v = n(m.valid[b]).astype(bool)
    return set(zip(n(m.i_ids[b])[v].tolist(), n(m.j_ids[b])[v].tolist()))


@pytest.fixture(scope="module", params=["box", "gather"])
def port_out(request, run):
    model = _port(run, request.param == "box")
    gam_kernels.reset_launch_counts()
    out = model(t(run["img0"]), t(run["img1"]),
                sample_idx=t(run["sample_idx"]))
    return request.param, model, out


def test_the_fixture_exercises_the_gam(run):
    """Matches on both pairs, and RANSAC finds H for both, so the cross
    layers' output is used and the fine stage decodes matches."""
    geo = run["out"].geo
    assert np.asarray(geo.has_H).all()
    assert (np.asarray(run["matches1"].valid).sum(1) > 8).all()
    assert (np.asarray(run["out"].fine.valid).sum(1) > 8).all()


def test_backbone_and_coarse_transformer_match_jax(run, port_out):
    _, model, _ = port_out
    x = np.concatenate([run["img0"], run["img1"]])
    coarse, fine = model.backbone(t(x))
    jc, jf = run["inter"]["backbone"]["__call__"][0]
    assert_close(coarse, jc, 1e-4, 1e-4)
    assert_close(fine, jf, 1e-4, 1e-4)
    f = add_position_encoding(coarse).reshape(2 * B, -1, coarse.shape[-1])
    f0, f1 = model.loftr_coarse(f[:B], f[B:])
    r0, r1 = run["inter"]["loftr_coarse"]["__call__"][0]
    assert_close(f0, r0, 1e-4, 1e-4)
    assert_close(f1, r1, 1e-4, 1e-4)


def test_first_pass_matches_equal_jax(run, port_out):
    _, _, out = port_out
    ref = run["matches1"]
    np.testing.assert_array_equal(n(out.matches1.valid),
                                  np.asarray(ref.valid))
    for b in range(B):
        assert _pairs(out.matches1, b) == _pairs(ref, b)


def test_geo_state_matches_jax(run, port_out):
    _, _, out = port_out
    ref = run["out"].geo
    np.testing.assert_array_equal(n(out.geo.has_H), np.asarray(ref.has_H))
    np.testing.assert_array_equal(n(out.geo.num_inliers),
                                  np.asarray(ref.num_inliers))
    np.testing.assert_array_equal(n(out.geo.map0), np.asarray(ref.map0))
    np.testing.assert_array_equal(n(out.geo.map1), np.asarray(ref.map1))
    assert_close(out.geo.H, ref.H, 1e-3, 1e-3)


def test_gam_features_match_jax(run, port_out):
    """The GAM on the JAX first-pass matches and CNN features: the box path
    (K1/K2 plain versions) and the gather path both give JAX's output."""
    _, model, _ = port_out
    jc = run["inter"]["backbone"]["__call__"][0][0]
    cnn = t(np.asarray(jc))
    m1 = run["matches1"]
    matches = CoarseMatches(None, t(m1.i_ids).long(), t(m1.j_ids).long(),
                            t(m1.valid), t(m1.mconf))
    g0, g1, _ = model.geo_module(cnn[:B], cnn[B:], matches, 8,
                                 sample_idx=t(run["sample_idx"]))
    r0, r1, _ = run["inter"]["geo_module"]["__call__"][0]
    assert_close(g0, r0, 1e-4, 1e-4)
    assert_close(g1, r1, 1e-4, 1e-4)


def test_final_matches_meet_the_parity_bar(run, port_out):
    _, _, out = port_out
    ref = run["out"]
    for b in range(B):
        pr, pp = _pairs(ref.matches, b), _pairs(out.matches, b)
        overlap = len(pr & pp) / max(len(pr | pp), 1)
        assert overlap >= 0.9, overlap
        sel = (np.asarray(ref.fine.valid[b]) & n(out.fine.valid[b])
               & (np.asarray(ref.matches.i_ids[b]) == n(out.matches.i_ids[b])))
        assert sel.sum() > 0
        for name in ("mkpts0", "mkpts1"):
            d = np.abs(n(getattr(out.fine, name)[b])[sel]
                       - np.asarray(getattr(ref.fine, name)[b])[sel]).max()
            assert d < 0.05, (name, d)


def test_cpu_forward_launches_no_kernel(port_out):
    assert set(gam_kernels.LAUNCHES) >= {"box_window_attention",
                                         "masked_kv_attention"}
    assert not any(gam_kernels.LAUNCHES.values()), gam_kernels.LAUNCHES


def test_padded_forward_matches_jax(run):
    """Padding masks (the matcher's path): the right quarter of image 1 of
    the second pair is padding."""
    cfg = run["cfg"]
    m0 = np.ones((B, H // 8, W // 8), np.float32)
    m1 = m0.copy()
    m1[1, :, -2:] = 0.0
    img1 = run["img1"].copy()
    img1[1, :, -16:] = 0.0
    ref = _jax_forward(cfg, run["variables"], run["img0"], img1,
                       jax.random.key(7), m0, m1)
    model = _port(run, True)
    out = model(t(run["img0"]), t(img1), t(m0), t(m1),
                sample_idx=t(ref["sample_idx"]))
    r = ref["out"]
    np.testing.assert_array_equal(n(out.geo.has_H), np.asarray(r.geo.has_H))
    for b in range(B):
        assert _pairs(out.matches1, b) == _pairs(ref["matches1"], b)
        pr, pp = _pairs(r.matches, b), _pairs(out.matches, b)
        assert len(pr & pp) / max(len(pr | pp), 1) >= 0.9
    # no match lands in the padding
    v = n(out.fine.valid[1]).astype(bool)
    assert (n(out.matches.j_ids[1])[v] % (W // 8) < W // 8 - 2).all()


def test_batched_matcher_pads_and_returns_unpadded_matches(run):
    model = _port(run, True)
    bm = BatchedMatcher(model.config, model, batch_size=2, device="cpu")
    a0, a1 = run["img0"][0, :, :, 0], run["img1"][0, :, :, 0]
    small0, small1 = a0[:48, :72], a1[:48, :72]
    res = bm.match_batch([a0, small0, a0], [a1, small1, a1], return_geo=True)
    assert len(res) == 3
    for mk0, mk1, mc, geo in res:
        assert mk0.shape == mk1.shape and mk0.shape[0] == mc.shape[0]
        assert np.isfinite(mk0).all() and np.isfinite(mk1).all()
        assert geo["H"].shape == (3, 3)
    assert res[0][0].shape[0] > 0
    # same pair, same seed: same answer whatever else is in the batch
    np.testing.assert_array_equal(res[0][0], res[2][0])
    assert (res[1][0][:, 0] < 72).all() and (res[1][0][:, 1] < 48).all()


@pytest.mark.parametrize("field,value", [
    ("seq_axis", "seq"), ("coarse", "int8")])
def test_unported_options_raise(run, field, value):
    """Sequence parallelism is not ported (it names its ROADMAP item); the
    int8 paths are eval-only, so a train-mode forward raises."""
    cfg = port_config(run["cfg"])
    if field == "seq_axis":
        with pytest.raises(NotImplementedError, match="item 3"):
            GeoFormer(cfg.replace(seq_axis=value))
        return
    model = GeoFormer(cfg.replace(coarse=dataclasses.replace(cfg.coarse,
                                                             int8=True)))
    with pytest.raises(ValueError, match="eval-only"):
        model(t(run["img0"]), t(run["img1"]), train=True)
