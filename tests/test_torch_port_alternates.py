"""The forward's alternates against the JAX package on the CPU: the sinkhorn
matcher, the dense coarse path and its extraction, the dense GeoLoss and
the soft-argmax fine loss, the (16, 4) ladder and its torch conversion,
plain LoFTR, NMS with top-k keypoints, and mutual-NN matching.

One JAX GeoFormer compile covers the (16, 4) ladder, the sinkhorn matcher
(its learned bin_score carried across by weights.jax_to_state_dict) and
``return_conf`` at once (tests/torch_port_util.small_config with four
block_dims, f32, JAX's RANSAC draws injected); one more runs the sinkhorn
matcher on the trained checkpoint (whose matches give homographies away
from the identity), and one compiles LoFTR.

Tolerances: f32 sums in another order, 1e-4 rel / 1e-5 abs for features,
log-couplings and losses (gradients 1e-4 rel / 1e-6 abs); confidences of
the dense path 1e-4 rel / 1e-6 abs; ids, validity, NMS keeps and the NN
matches exactly; the whole forward's matches by the parity bar of
__graft_entry__.py (overlap >= 0.9, keypoints within 0.05 px).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.eval.nn_matching import mutual_nn_match as j_nn  # noqa: E402
from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.models import coarse_matching as jcm  # noqa: E402
from geoformer_tpu.models.loftr import LoFTR as JLoFTR  # noqa: E402
from geoformer_tpu.ops import nms as jnms  # noqa: E402
from geoformer_tpu.ops import sinkhorn as jsk  # noqa: E402
from geoformer_tpu.train import loss as jloss  # noqa: E402
from geoformer_tpu.utils import torch_convert as jtc  # noqa: E402
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch import weights  # noqa: E402
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.eval.nn_matching import mutual_nn_match  # noqa: E402
from geoformer_tpu_torch.geometry.homography import (  # noqa: E402
    sample_homography,
    sample_homography_draws,
)
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.models import coarse_matching as tcm  # noqa: E402
from geoformer_tpu_torch.models.loftr import LoFTR  # noqa: E402
from geoformer_tpu_torch.ops import nms as tnms  # noqa: E402
from geoformer_tpu_torch.ops import sinkhorn as tsk  # noqa: E402
from geoformer_tpu_torch.train import loss as tloss  # noqa: E402
from geoformer_tpu_torch.utils import torch_convert as tc  # noqa: E402
from torch_port_util import (  # noqa: E402
    assert_close,
    flatten,
    n,
    port_config,
    small_config,
    smooth_images,
    t,
)

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
B, H, W = 2, 128, 160


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's torch work on one thread: under the suite's parallel
    workers the int8 path's elementwise passes thrash when every worker
    runs one thread a core. Restored after the test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- sinkhorn --

@pytest.mark.parametrize("iters", [1, 3])
def test_log_optimal_transport_matches_jax(iters):
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(2, 7, 9)).astype(np.float32) * 3
    scores[1, :, 4] = -1e9           # a masked column
    ref = jsk.log_optimal_transport(jnp.asarray(scores), jnp.asarray(0.7),
                                    iters)
    got = tsk.log_optimal_transport(t(scores), torch.tensor(0.7), iters)
    assert got.shape == (2, 8, 10)
    assert_close(got, ref, 1e-4, 1e-5)


# ------------------------------------------------------- dense extraction --

@pytest.mark.parametrize("capacity", [-1, 16])
@pytest.mark.parametrize("force_one", [False, True])
def test_extract_matches_matches_jax(capacity, force_one):
    rng = np.random.default_rng(1)
    conf = rng.random((2, 30, 25)).astype(np.float32) ** 4
    conf[1] *= 1e-3                  # a pair with no match above thr
    m0 = (rng.random((2, 30)) > 0.1).astype(np.float32)
    m1 = (rng.random((2, 25)) > 0.1).astype(np.float32)
    ref = jcm.extract_matches(jnp.asarray(conf), 0.2, capacity, force_one,
                              jnp.asarray(m0), jnp.asarray(m1))
    got = tcm.extract_matches(t(conf), 0.2, capacity, force_one, t(m0),
                              t(m1))
    np.testing.assert_array_equal(n(got.valid), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    for f in ("i_ids", "j_ids"):
        np.testing.assert_array_equal(n(getattr(got, f))[v],
                                      np.asarray(getattr(ref, f))[v])
    assert_close(n(got.mconf)[v], np.asarray(ref.mconf)[v], 1e-6, 0)
    assert got.conf is not None and got.conf.shape == (2, 30, 25)


# ----------------------------------------------------------------- losses --

def test_dense_geo_loss_value_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    b, l, s, m, ww = 2, 12, 10, 6, 9
    conf = rng.random((b, l, s)).astype(np.float32)
    dect = rng.random((b, l, s)).astype(np.float32)
    gt = (rng.random((b, l, s)) > 0.9).astype(np.float32)
    fine = rng.random((b, m, ww, ww)).astype(np.float32)
    fgt = (rng.random((b, m, ww, ww)) > 0.95).astype(np.float32)
    fvalid = rng.random((b, m)) > 0.3
    m0 = (rng.random((b, l)) > 0.2).astype(np.float32)
    m1 = (rng.random((b, s)) > 0.2).astype(np.float32)
    for cfg_kw in ({}, {"sparse_spvs": False},
                   {"coarse_type": "cross_entropy"}):
        jc = jcfg.LossConfig(**cfg_kw)

        def jl(c, d, f):
            return jloss.geo_loss(c, d, jnp.asarray(gt), f, jnp.asarray(fgt),
                                  jnp.asarray(fvalid), jc, jnp.asarray(m0),
                                  jnp.asarray(m1))[0]

        ref, grads = jax.value_and_grad(jl, argnums=(0, 1, 2))(
            jnp.asarray(conf), jnp.asarray(dect), jnp.asarray(fine))
        xs = [t(a).requires_grad_() for a in (conf, dect, fine)]
        got, parts = tloss.geo_loss(*xs[:2], t(gt), xs[2], t(fgt),
                                    t(fvalid), tcfg.LossConfig(**cfg_kw),
                                    t(m0), t(m1))
        got.backward()
        assert set(parts) == {"loss_c", "loss_d", "loss_f", "loss"}
        assert_close(got, ref, 1e-4, 1e-5, str(cfg_kw))
        for x, g in zip(xs, grads):
            assert_close(x.grad, g, 1e-4, 1e-6, str(cfg_kw))


def test_fine_loss_l2_std_value_and_gradient_match_jax():
    rng = np.random.default_rng(3)
    ef = rng.normal(size=(2, 20, 3)).astype(np.float32) * 0.5
    ef[..., 2] = np.abs(ef[..., 2]) + 0.05
    gt = rng.normal(size=(2, 20, 2)).astype(np.float32) * 0.6
    valid = rng.random((2, 20)) > 0.2
    ref, g = jax.value_and_grad(lambda e: jloss.fine_loss_l2_std(
        e, jnp.asarray(gt), jnp.asarray(valid)))(jnp.asarray(ef))
    x = t(ef).requires_grad_()
    got = tloss.fine_loss_l2_std(x, t(gt), t(valid))
    got.backward()
    assert_close(got, ref, 1e-4, 1e-6)
    assert_close(x.grad, g, 1e-4, 1e-6)


# ------------------------------------- (16, 4) GeoFormer with sinkhorn --

def _alt_config():
    base = small_config()
    return base.replace(
        backbone=jcfg.BackboneConfig(initial_dim=16, block_dims=(16, 24, 32,
                                                                 32),
                                     resolution=(16, 4)),
        match=dataclasses.replace(base.match, match_type="sinkhorn",
                                  skh_init_bin_score=0.5, thr=1e-4),
        coarse_scale=16, fine_scale=4)


@pytest.fixture(scope="module")
def alt():
    cfg = _alt_config()
    img0, img1 = smooth_images(np.random.default_rng(0), B, H, W, shift=16)
    key = jax.random.key(0)
    variables = jax.jit(JGeoFormer(cfg).init)(
        {"params": key, "ransac": key}, jnp.asarray(img0[:1]),
        jnp.asarray(img0[:1]))
    # a trained-looking dustbin score, not the initial one
    variables = {**variables, "params": {**variables["params"],
                                         "bin_score": jnp.asarray(0.8)}}
    out, sample_idx, inter = _jax_forward(cfg, variables, img0, img1)
    model = weights.load_jax_params(GeoFormer(port_config(cfg)),
                                    flatten(variables)).eval()
    with torch.no_grad():
        got = model(t(img0), t(img1), sample_idx=t(sample_idx),
                    return_conf=True)
    return dict(cfg=cfg, out=out, inter=inter, got=got, model=model,
                img0=img0, img1=img1)


def _jax_forward(cfg, variables, img0, img1):
    """The JAX forward with return_conf, its intermediates, and the GAM's
    draws (jax_forward_and_draws's rule; sinkhorn's first-pass matches
    come from its own extraction)."""
    model = JGeoFormer(cfg)
    key = jax.random.key(5)
    out, st = jax.jit(lambda v, a, b: model.apply(
        v, a, b, return_conf=True, rngs={"ransac": key},
        capture_intermediates=True, mutable=["intermediates"]))(
            variables, jnp.asarray(img0), jnp.asarray(img1))
    rkey = model.apply(variables, method=lambda mod: mod.make_rng("ransac"),
                       rngs={"ransac": key})
    valid1 = jcm.extract_matches(out.dect_conf, cfg.match.thr,
                                 cfg.match.max_matches).valid

    def draw(k, v):
        g = jax.random.gumbel(k, (cfg.geo.ransac_iters, v.shape[0]))
        return jax.lax.top_k(jnp.where(v[None, :], g, -jnp.inf), 4)[1]

    idx = np.asarray(jax.vmap(draw)(jax.random.split(rkey, B), valid1))
    return out, idx, st["intermediates"]


def test_the_bin_score_is_carried_across(alt):
    assert alt["model"].bin_score.item() == pytest.approx(0.8)
    sd = weights.jax_to_state_dict({"params/bin_score": np.float32(0.8)})
    assert sd["bin_score"].shape == ()


def test_16_4_ladder_features_match_jax(alt):
    x = np.concatenate([alt["img0"], alt["img1"]])
    with torch.no_grad():
        c, f = alt["model"].backbone(t(x))
    jc, jf = alt["inter"]["backbone"]["__call__"][0]
    assert c.shape == (2 * B, H // 16, W // 16, 32)
    assert f.shape == (2 * B, H // 4, W // 4, 24)
    assert_close(c, jc, 1e-4, 1e-4)
    assert_close(f, jf, 1e-4, 1e-4)


def test_16_4_sinkhorn_first_pass_matches_jax(alt):
    """The (16, 4) sinkhorn forward runs end to end; its first pass (the
    dense confidences returned, exp(Z) without the dustbins, and the
    matches drawn from them) equals JAX's. (Its second pass is held on
    the trained model below: this untrained model matches every cell to
    itself, so RANSAC fits a homography within f32 noise of the identity,
    which puts every warped cell centre on a cell border.)"""
    got, ref = alt["got"], alt["out"]
    l0 = (H // 16) * (W // 16)
    assert got.matches.conf.shape == (B, l0, l0)
    assert_close(got.matches1.conf, ref.dect_conf, 1e-4, 1e-6, "pass 1")
    j1 = jcm.extract_matches(ref.dect_conf, alt["cfg"].match.thr,
                             alt["cfg"].match.max_matches)
    np.testing.assert_array_equal(n(got.matches1.valid), np.asarray(j1.valid))
    v = np.asarray(j1.valid)
    np.testing.assert_array_equal(n(got.matches1.j_ids)[v],
                                  np.asarray(j1.j_ids)[v])
    assert got.fine.mkpts0.shape == (B, alt["cfg"].match.max_matches, 2)
    assert np.isfinite(n(got.fine.mkpts1)).all()


@pytest.fixture(scope="module")
def trained_sinkhorn():
    """The trained checkpoint with the sinkhorn matcher (bin_score 1.0,
    the config's initial value, added to its variables) on two textured
    pairs under known homographies, 96x128, f32."""
    from geoformer_tpu.train.checkpoint import load_variables

    if not CKPT.is_file():
        pytest.skip(f"no trained checkpoint at {CKPT}")
    cfg = jcfg.GeoFormerConfig(
        match=jcfg.MatchConfig(match_type="sinkhorn", max_matches=256),
        geo=jcfg.GeoModuleConfig(ransac_iters=64, max_inliers=256))
    variables = load_variables(str(CKPT))
    variables = {**variables, "params": {**variables["params"],
                                         "bin_score": jnp.asarray(1.0)}}
    hw = (96, 128)
    base = native.native_textures(B, *hw, 123456)
    Hs = sample_homography(sample_homography_draws(
        B, hw, torch.Generator().manual_seed(0)), hw).numpy()
    img0 = base[..., None].astype(np.float32)
    img1 = native.native_warp(base, Hs)[..., None].astype(np.float32)
    out, idx, _ = _jax_forward(cfg, variables, img0, img1)
    model = weights.load_jax_params(GeoFormer(port_config(cfg)),
                                    flatten(variables)).eval()
    with torch.no_grad():
        got = model(t(img0), t(img1), sample_idx=t(idx), return_conf=True)
    return got, out


def test_sinkhorn_forward_matches_jax(trained_sinkhorn):
    got, ref = trained_sinkhorn
    assert_close(got.matches.conf, ref.conf, 1e-4, 1e-6, "pass 2")
    assert np.asarray(ref.geo.has_H).all()
    np.testing.assert_array_equal(n(got.geo.has_H), np.asarray(ref.geo.has_H))
    for b in range(B):
        v = np.asarray(ref.matches.valid[b])
        pr = set(zip(np.asarray(ref.matches.i_ids[b])[v].tolist(),
                     np.asarray(ref.matches.j_ids[b])[v].tolist()))
        vg = n(got.matches.valid[b]).astype(bool)
        pg = set(zip(n(got.matches.i_ids[b])[vg].tolist(),
                     n(got.matches.j_ids[b])[vg].tolist()))
        assert len(pr) > 50
        assert len(pr & pg) / max(len(pr | pg), 1) >= 0.9
        sel = (np.asarray(ref.fine.valid[b]) & n(got.fine.valid[b])
               & (np.asarray(ref.matches.i_ids[b]) == n(got.matches.i_ids[b])))
        assert sel.sum() > 0
        for name in ("mkpts0", "mkpts1"):
            d = np.abs(n(getattr(got.fine, name)[b])[sel]
                       - np.asarray(getattr(ref.fine, name)[b])[sel]).max()
            assert d < 0.05, (name, d)


def test_dense_dual_softmax_forward_returns_conf(alt):
    """return_conf on the dual-softmax matcher: the dense path's
    confidences, differentiable, and the streamed path's matches."""
    cfg = port_config(small_config())
    model = weights.random_init(GeoFormer(cfg), seed=1)
    i0, i1 = smooth_images(np.random.default_rng(6), 1, 64, 80)
    g = torch.Generator().manual_seed(0)
    dense = model(t(i0), t(i1), generator=g, return_conf=True)
    assert dense.matches.conf.shape == (1, 80, 80)
    assert dense.matches.conf.requires_grad
    with torch.no_grad():
        streamed = model(t(i0), t(i1),
                         generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(n(dense.matches1.valid),
                                  n(streamed.matches1.valid))
    v = n(streamed.matches1.valid).astype(bool)
    np.testing.assert_array_equal(n(dense.matches1.j_ids)[v],
                                  n(streamed.matches1.j_ids)[v])


def test_16_4_torch_conversion_matches_the_jax_converter(alt):
    """A reference-named (16, 4) state dict: the port's converter gives
    the same tensors as the JAX converter followed by the port's JAX
    loader, and converts back to the same names."""
    from geoformer_tpu_torch.models.backbone import ResNetFPN_16_4

    model = alt["model"]
    ref_sd = tc.to_torch_state_dict(model)
    assert "matcher.backbone.layer4.1.conv2.weight" in ref_sd
    assert "matcher.backbone.layer4_outconv.weight" in ref_sd
    got = tc.convert_state_dict(ref_sd, 4, 4, 2)
    jvars = jtc.convert_state_dict(ref_sd, 4, 4, 2)
    via_jax = weights.jax_to_state_dict(flatten(jvars))
    assert set(got) == set(via_jax)
    for k in got:
        np.testing.assert_array_equal(got[k], n(via_jax[k]), err_msg=k)
    assert isinstance(model.backbone, ResNetFPN_16_4)
    own = {k for k in model.state_dict() if k != "bin_score"}
    assert set(got) == own


# ------------------------------------------------------------------ LoFTR --

def test_loftr_matches_jax():
    cfg = small_config(match=jcfg.MatchConfig(thr=1e-4, max_matches=-1))
    img0, img1 = smooth_images(np.random.default_rng(1), B, 64, 80)
    key = jax.random.key(0)
    jm = JLoFTR(cfg)
    variables = jax.jit(jm.init)(key, jnp.asarray(img0[:1]),
                                 jnp.asarray(img0[:1]))
    ref = jax.jit(jm.apply)(variables, jnp.asarray(img0), jnp.asarray(img1))
    model = weights.load_jax_params(LoFTR(port_config(cfg)),
                                    flatten(variables)).eval()
    with torch.no_grad():
        got = model(t(img0), t(img1))
    assert_close(got.conf, ref.conf, 1e-4, 1e-6, "conf")
    np.testing.assert_array_equal(n(got.valid), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    assert v.sum() > 8
    np.testing.assert_array_equal(n(got.matches.j_ids)[v],
                                  np.asarray(ref.matches.j_ids)[v])
    assert_close(n(got.expec_f)[v], np.asarray(ref.expec_f)[v], 1e-4, 1e-5)
    assert_close(n(got.mkpts0)[v], np.asarray(ref.mkpts0)[v], 0, 1e-5)
    assert_close(n(got.mkpts1)[v], np.asarray(ref.mkpts1)[v], 1e-5, 1e-4)


# ------------------------------------------------------ NMS and NN match --

@pytest.mark.parametrize("radius", [1, 2, 4])
@pytest.mark.parametrize("noise", [False, True])
def test_simple_nms_matches_jax(radius, noise):
    rng = np.random.default_rng(4)
    scores = np.round(rng.random((2, 24, 30)) * 8).astype(np.float32) / 8
    key = jax.random.key(7) if noise else None
    ref = jnms.simple_nms(jnp.asarray(scores), radius, key)
    # JAX's tie noise, injected
    u = np.asarray(jax.random.uniform(key, scores.shape)) if noise else None
    got = tnms.simple_nms(t(scores), radius,
                          noise=None if u is None else t(u))
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    if noise:
        gen = tnms.simple_nms(t(scores), radius,
                              generator=torch.Generator().manual_seed(0))
        # a generator's draw breaks ties too: every kept score is a
        # window maximum
        kept = n(gen) > 0
        assert kept.any() and (n(gen)[kept] == scores[kept]).all()


def test_top_k_keypoints_matches_jax():
    rng = np.random.default_rng(5)
    scores = rng.random((24, 30)).astype(np.float32)
    jxy, jv = jnms.top_k_keypoints(jnp.asarray(scores), 17)
    xy, v = tnms.top_k_keypoints(t(scores), 17)
    np.testing.assert_array_equal(n(xy), np.asarray(jxy))
    np.testing.assert_array_equal(n(v), np.asarray(jv))


@pytest.mark.parametrize("threshold", [None, 0.3])
def test_mutual_nn_match_matches_jax(threshold):
    rng = np.random.default_rng(6)
    d0 = rng.normal(size=(40, 16)).astype(np.float32)
    d1 = np.concatenate([d0[:25] + 0.3 * rng.normal(size=(25, 16)),
                         rng.normal(size=(20, 16))]).astype(np.float32)
    ri, rv, rs = j_nn(jnp.asarray(d0), jnp.asarray(d1), threshold)
    gi, gv, gs = mutual_nn_match(t(d0), t(d1), threshold)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(n(gi), np.asarray(ri))
    np.testing.assert_array_equal(n(gv), np.asarray(rv))
    assert_close(gs, rs, 1e-5, 1e-6)
    assert 10 < n(gv).sum() < 40
