"""The port's depth geometry and depth supervision against the JAX package.

Inputs are two views of a rendered room (the port's renderer, numpy
textures) with exact depth, then damaged: a rectangle of zero depth in
each view (holes) and a band of view 1's depth scaled by 1.5 (inconsistent
depths), under random extra camera motion.

warp_kpts_depth samples depth at round() in view 0 and at floor() of the
warped point in view 1, so a keypoint within float noise of a tie can pick
another cell in either package. The keypoints are kept where the float64
warp puts both at least TIE px from a tie (as
tests/test_torch_port_train_step.py keeps its cells from borders); the
fixture asserts that the kept ones still cover every branch (valid,
holes, inconsistent, out of view). Bars: ``valid`` equal, the warped
points within 1e-3 px; the symmetric epipolar distance within 1e-5
relative where its residual does not cancel (see the test);
relative_pose_error within 1e-6 degrees.

The supervision runs at a padded size, 64x64 images whose content is
48x64 (the mask's last two coarse rows are 0), with scale0/scale1 of 1.25
(original views of 60x80 pixels, depths padded to 96x96): gt_j/gt_valid,
the dense coarse GT and the fine labels equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.geometry import depth as J  # noqa: E402
from geoformer_tpu.models.coarse_matching import (  # noqa: E402
    CoarseMatches as JMatches,
)
from geoformer_tpu.train import supervision as JS  # noqa: E402
from geoformer_tpu_torch.data.planes import (  # noqa: E402
    look_at,
    render_planes,
    room_scene,
)
from geoformer_tpu_torch.geometry import depth as P  # noqa: E402
from geoformer_tpu_torch.models.coarse_matching import (  # noqa: E402
    CoarseMatches,
)
from geoformer_tpu_torch.train import supervision as PS  # noqa: E402
from torch_port_util import n, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

TIE = 1e-3
B, L = 3, 400


def _views(seed, hw=(96, 128), f=110.0, pad=None):
    """(depth0, depth1, T_0to1, K) of a rendered room, damaged."""
    rng = np.random.default_rng(seed)
    tex = rng.random((6, 32, 48)).astype(np.float32)
    planes = room_scene(rng, tex, cluttered=True)
    h, w = hw
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    c0 = np.array([rng.uniform(-1, 0), rng.uniform(-.3, .3), 0.0])
    c1 = c0 + np.array([rng.uniform(0.3, 1.0), rng.uniform(-.2, .2),
                        rng.uniform(-.3, .3)])
    T0 = look_at(c0, [rng.uniform(-.5, .5), 0, 8])
    T1 = look_at(c1, [rng.uniform(-.5, .5), 0, 8])
    _, d0 = render_planes(K, T0, planes, hw, return_depth=True)
    _, d1 = render_planes(K, T1, planes, hw, return_depth=True)
    d0[h // 4:h // 3, w // 5:w // 3] = 0                  # holes
    d1[h // 2:h // 2 + 8, :] = 0
    d1[:, w // 2:w // 2 + 12] *= 1.5                     # inconsistent
    if pad:
        d0 = np.pad(d0, ((0, pad - h), (0, pad - w)))
        d1 = np.pad(d1, ((0, pad - h), (0, pad - w)))
    T = (T1 @ np.linalg.inv(T0)).astype(np.float32)
    return d0, d1, T, K.astype(np.float32)


def _warp64(k, d0, T, K):
    """The float64 warp of keypoints [L, 2], for the tie margins."""
    x = np.clip(np.round(k[:, 0]), 0, d0.shape[1] - 1).astype(int)
    y = np.clip(np.round(k[:, 1]), 0, d0.shape[0] - 1).astype(int)
    z = d0[y, x].astype(np.float64)
    ph = np.concatenate([k, np.ones((len(k), 1))], 1) * z[:, None]
    cam1 = (T[:3, :3] @ (np.linalg.inv(K) @ ph.T)).T + T[:3, 3]
    proj = (K @ cam1.T).T
    return proj[:, :2] / (proj[:, 2:] + 1e-4)


@pytest.fixture(scope="module")
def warp_case():
    rng = np.random.default_rng(0)
    depth0, depth1, Ts, Ks, kpts = [], [], [], [], []
    for b in range(B):
        d0, d1, T, K = _views(b)
        cand = rng.uniform([-2, -2], [130, 98], (20 * L, 2))
        w64 = _warp64(cand, d0, T, K)
        frac0 = np.abs(cand - np.floor(cand) - 0.5)          # round ties
        frac1 = np.abs(w64 - np.round(w64))                  # floor ties
        keep = (frac0.min(1) > TIE) & (frac1.min(1) > TIE)
        kpts.append(cand[keep][:L])
        depth0.append(d0)
        depth1.append(d1)
        Ts.append(T)
        Ks.append(K)
    arr = dict(kpts0=np.stack(kpts).astype(np.float32),
               depth0=np.stack(depth0), depth1=np.stack(depth1),
               T=np.stack(Ts), K0=np.stack(Ks), K1=np.stack(Ks))
    jv, jw = J.warp_kpts_depth(*(jnp.asarray(arr[k]) for k in (
        "kpts0", "depth0", "depth1", "T", "K0", "K1")))
    pv, pw = P.warp_kpts_depth(*(t(arr[k]) for k in (
        "kpts0", "depth0", "depth1", "T", "K0", "K1")))
    return dict(arr=arr, jv=np.asarray(jv), jw=np.asarray(jw), pv=n(pv),
                pw=n(pw))


def test_the_keypoints_cover_every_branch(warp_case):
    a = warp_case["arr"]
    jv, jw = warp_case["jv"], warp_case["jw"]
    k = a["kpts0"]
    d0 = np.stack([a["depth0"][b][np.clip(np.round(k[b, :, 1]), 0, 95)
                                  .astype(int),
                                  np.clip(np.round(k[b, :, 0]), 0, 127)
                                  .astype(int)] for b in range(B)])
    inside = (jw[..., 0] > 0) & (jw[..., 0] < 127) & (jw[..., 1] > 0) \
        & (jw[..., 1] < 95)
    assert k.shape == (B, L, 2)
    assert jv.mean() > 0.2                               # valid
    assert ((d0 == 0)).sum() > 10                        # holes
    assert (~inside & (d0 > 0)).sum() > 10               # out of view
    assert (inside & (d0 > 0) & ~jv).sum() > 10          # inconsistent


def test_warp_kpts_depth_matches_jax(warp_case):
    np.testing.assert_array_equal(warp_case["pv"], warp_case["jv"])
    np.testing.assert_allclose(warp_case["pw"], warp_case["jw"], atol=1e-3,
                               rtol=1e-6)


def test_epipolar_distance_and_essential_match_jax(warp_case):
    a = warp_case["arr"]
    rng = np.random.default_rng(1)
    p0 = rng.uniform(0, 128, (B, 200, 2)).astype(np.float32)
    p1 = p0 + rng.normal(0, 2, p0.shape).astype(np.float32)
    T = a["T"]
    jE = np.asarray(J.essential_from_pose(jnp.asarray(T)))
    pE = n(P.essential_from_pose(t(T)))
    np.testing.assert_allclose(pE, jE, rtol=1e-6, atol=1e-7)
    ref = np.stack([np.asarray(J.symmetric_epipolar_distance(
        jnp.asarray(p0[b]), jnp.asarray(p1[b]), jnp.asarray(jE[b]),
        jnp.asarray(a["K0"][b]), jnp.asarray(a["K1"][b])))
        for b in range(B)])
    got = n(P.symmetric_epipolar_distance(t(p0), t(p1), t(jE), t(a["K0"]),
                                          t(a["K1"])))
    # x1^T E x0 cancels: its f32 rounding is relative to |x1| |E x0|, not
    # to the residual, and the packages sum in different orders (XLA's dot
    # contracts with FMA). So 1e-5 relative, or 1e-6 of the distance the
    # terms give uncancelled, whichever is larger.
    def h(p, K):
        q = (p - K[:, None, :2, 2]) / K[:, None, [0, 1], [0, 1]]
        return np.concatenate([q, np.ones_like(q[..., :1])], -1)

    x0, x1 = h(p0, a["K0"]), h(p1, a["K1"])
    Ex0 = np.einsum("bij,blj->bli", jE, x0)
    Etx1 = np.einsum("bji,blj->bli", jE, x1)
    plain = (np.linalg.norm(x1, axis=-1) * np.linalg.norm(Ex0, axis=-1)) \
        ** 2 * (1 / (Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2)
                + 1 / (Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2))
    bar = np.maximum(1e-5 * np.abs(ref), 1e-6 * plain)
    assert (np.abs(got - ref) <= bar).all(), np.abs(got - ref).max()
    assert (np.abs(got - ref) <= 1e-5 * np.abs(ref)).mean() > 0.9


def test_relative_pose_error_matches_jax(warp_case):
    rng = np.random.default_rng(2)
    for T in warp_case["arr"]["T"].astype(np.float64):
        ax = rng.normal(size=3) * 0.05
        c, s = np.cos(np.linalg.norm(ax)), np.sin(np.linalg.norm(ax))
        u = ax / np.linalg.norm(ax)
        Ux = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
        R = (c * np.eye(3) + s * Ux + (1 - c) * np.outer(u, u)) @ T[:3, :3]
        tr = T[:3, 3] + rng.normal(size=3) * 0.1
        for thr in (0.0, 10.0):
            ref = J.relative_pose_error(T, R, tr, ignore_gt_t_thr=thr)
            got = P.relative_pose_error(T, R, tr, ignore_gt_t_thr=thr)
            np.testing.assert_allclose(got, ref, atol=1e-6)


# ------------------------------------------------------------ supervision --

HW = (64, 64)                     # padded images, 48x64 content
SCALE = 1.25                      # original / resized
M = 48


@pytest.fixture(scope="module")
def spvs_case():
    views = [_views(10 + b, hw=(60, 80), f=70.0, pad=96) for b in range(2)]
    d0, d1, T, K = (np.stack(x) for x in zip(*views))
    T10 = np.linalg.inv(T).astype(np.float32)
    mask = np.ones((2, 8, 8), np.float32)
    mask[:, 6:] = 0
    scale = np.full((2, 2), SCALE, np.float32)
    rng = np.random.default_rng(3)
    i_ids = rng.integers(0, 48, (2, M))
    j_ids = np.clip(i_ids + rng.integers(-2, 3, (2, M)), 0, 47)
    valid = rng.random((2, M)) < 0.8
    args = (d0, d1, T, T10, K, K)
    jargs = [jnp.asarray(x) for x in args]
    targs = [t(x) for x in args]
    jm = (jnp.asarray(mask), jnp.asarray(mask))
    tm = (t(mask), t(mask))
    js, ts = jnp.asarray(scale), t(scale)
    out = {}
    out["jax_sparse"] = [np.asarray(x) for x in JS.spvs_coarse_depth_sparse(
        *jargs, HW, 8, *jm, js, js)]
    out["port_sparse"] = [n(x) for x in PS.spvs_coarse_depth_sparse(
        *targs, HW, 8, *tm, ts, ts)]
    out["jax_dense"] = np.asarray(JS.spvs_coarse_depth(
        *jargs, HW, 8, *jm, js, js))
    out["port_dense"] = n(PS.spvs_coarse_depth(*targs, HW, 8, *tm, ts, ts))
    zeros = np.zeros((2, M), np.float32)
    jmatch = JMatches(None, jnp.asarray(i_ids), jnp.asarray(j_ids),
                      jnp.asarray(valid), jnp.asarray(zeros))
    tmatch = CoarseMatches(None, t(i_ids), t(j_ids), t(valid), t(zeros))
    out["jax_fine"] = np.asarray(JS.spvs_fine_depth(
        jmatch, jargs[0], jargs[1], jargs[2], jargs[4], jargs[5], 8, 8,
        scale0=js, scale1=js))
    out["port_fine"] = n(PS.spvs_fine_depth(
        tmatch, targs[0], targs[1], targs[2], targs[4], targs[5], 8, 8,
        scale0=ts, scale1=ts))
    return out


def test_coarse_depth_gt_matches_jax(spvs_case):
    (jj, jv), (pj, pv) = spvs_case["jax_sparse"], spvs_case["port_sparse"]
    assert jv.sum() > 20                      # the pair has GT rows
    assert not jv[:, 48:].any()               # padded rows hold none
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pj, jj)
    np.testing.assert_array_equal(spvs_case["port_dense"],
                                  spvs_case["jax_dense"])


def test_fine_depth_labels_match_jax(spvs_case):
    ref = spvs_case["jax_fine"]
    assert ref.sum() > 5 and ref.sum() < ref.size
    np.testing.assert_array_equal(spvs_case["port_fine"], ref)
