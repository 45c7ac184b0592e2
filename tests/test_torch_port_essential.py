"""The port's essential-matrix RANSAC against the JAX estimator.

Both run on the same inputs with JAX's draws injected: the samples JAX's
batched_pose_errors takes from its key (split per pair, Gumbel top-12 over
the valid entries) are handed to the port as ``sample_idx``. The pairs are
tests/test_pose.py's synthetic two-view scenes: noisy with 20 % outliers,
clean, and the failure modes (no valid match; four valid, below
min_valid).

The exact comparison runs in float64 (the JAX package under
jax.experimental.enable_x64, the port on f64 tensors: both are
dtype-generic). In f32 an eigh of the 9x9 normal matrix is
ill-conditioned: on the same matrix the JAX package's LAPACK and torch's
give smallest eigenvectors 0.03 apart (the JAX one is 0.03 from the f64
eigenvector, the port's 0.008; measured on the noisy pairs' hypotheses),
so the leaders' capture counts, and with them the LO path, may differ.
In f64 the two agree to ~1e-12 and every decision is the same: ``ok``
and the inlier masks equal, E equal up to sign within 1e-6, R and t and
the angular errors within 1e-3 degrees, inf where JAX has inf. In f32,
the path's dtype, both recover the same poses: ``ok`` equal and each
pair's error within 5 degrees where JAX's is, as tests/test_pose.py holds
the JAX estimator to cv2's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.geometry import essential as J  # noqa: E402
from geoformer_tpu_torch.geometry import essential as P  # noqa: E402
from geoformer_tpu_torch.geometry.ransac import gumbel_sample_idx  # noqa: E402
from torch_port_util import n, t  # noqa: E402

K = np.array([[420.0, 0, 320], [0, 420, 240], [0, 0, 1]])
ITERS = 128
DEG = 1e-3


def _project(pts3d, K, R=np.eye(3), tr=np.zeros(3)):
    cam = pts3d @ R.T + tr
    uv = cam @ K.T
    return uv[:, :2] / uv[:, 2:]


def _two_view(rng, n=300, outlier_frac=0.2, noise_px=0.5, angle_deg=8.0,
              tr=(0.6, 0.15, 0.05)):
    """tests/test_pose.py's scene: points at depth 4-9 seen by two cameras
    rotated about y and moved by tr, with pixel noise and outliers."""
    pts = rng.uniform([-2, -2, 4], [2, 2, 9], size=(n, 3))
    th = np.deg2rad(angle_deg)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    tr = np.asarray(tr, np.float64)
    uv0 = _project(pts, K) + rng.normal(0, noise_px, (n, 2))
    uv1 = _project(pts, K, R, tr) + rng.normal(0, noise_px, (n, 2))
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    uv1[idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = tr
    return uv0, uv1, T


def _batch(kind):
    rng = np.random.default_rng({"noisy": 7, "clean": 11, "fail": 3}[kind])
    if kind == "fail":
        k0 = rng.uniform([0, 0], [640, 480], (2, 64, 2))
        k1 = rng.uniform([0, 0], [640, 480], (2, 64, 2))
        valid = np.zeros((2, 64), bool)
        valid[1, :4] = True                       # below min_valid
        T = np.tile(np.eye(4), (2, 1, 1))
    else:
        views = [_two_view(rng, n=200, angle_deg=4 + 2 * i,
                           **({} if kind == "noisy" else
                              dict(outlier_frac=0.0, noise_px=0.0)))
                 for i in range(4)]
        k0, k1, T = (np.stack(x) for x in zip(*views))
        valid = np.ones(k0.shape[:2], bool)
        valid[1, 150:] = False                    # a padded tail
    b = len(k0)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(mkpts0=f32(k0), mkpts1=f32(k1), valid=valid,
                K0=f32(np.tile(K, (b, 1, 1))), K1=f32(np.tile(K, (b, 1, 1))),
                T_0to1=f32(T))


def jax_samples(key, valid, iters):
    """The [B, iters, 12] samples batched_pose_errors draws from ``key``."""
    def draw(k, v):
        g = jax.random.gumbel(k, (iters, v.shape[0]))
        return jax.lax.top_k(jnp.where(v[None], g, -jnp.inf), 12)[1]

    keys = jax.random.split(key, valid.shape[0])
    return np.asarray(jax.vmap(draw)(keys, jnp.asarray(valid)))


def _angle_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.rad2deg(np.arccos(np.clip(c, -1, 1)))


def _run(bt, dtype):
    """(JAX pose errors, JAX per-pair fits, port pose errors, port fit)."""
    jd = jnp.float64 if dtype == "f64" else jnp.float32
    td = torch.float64 if dtype == "f64" else torch.float32
    key = jax.random.key(0)
    jb = {k: jnp.asarray(v, jd if v.dtype.kind == "f" else None)
          for k, v in bt.items()}
    ref = [np.asarray(x) for x in J.batched_pose_errors(
        key, jb["mkpts0"], jb["mkpts1"], jb["valid"], jb["K0"], jb["K1"],
        jb["T_0to1"], iters=ITERS)]
    idx = jax_samples(key, bt["valid"], ITERS)
    keys = jax.random.split(key, len(bt["valid"]))
    fits = []
    for i in range(len(keys)):
        p0 = J.normalize_by_intrinsics(jb["mkpts0"][i], jb["K0"][i])
        p1 = J.normalize_by_intrinsics(jb["mkpts1"][i], jb["K1"][i])
        fmean = (jb["K0"][i, 0, 0] + jb["K0"][i, 1, 1] + jb["K1"][i, 0, 0]
                 + jb["K1"][i, 1, 1]) / 4.0
        fits.append({k: np.asarray(v) for k, v in J.ransac_essential(
            keys[i], p0, p1, jb["valid"][i], thr=0.5 / fmean,
            iters=ITERS).items()})
    tb = {k: t(v, td if v.dtype.kind == "f" else None)
          for k, v in bt.items()}
    got = [n(x) if x.dtype != torch.float64 else x.numpy()
           for x in P.batched_pose_errors(
               tb["mkpts0"], tb["mkpts1"], tb["valid"], tb["K0"], tb["K1"],
               tb["T_0to1"], iters=ITERS, sample_idx=t(idx))]
    p0 = P.normalize_by_intrinsics(tb["mkpts0"], tb["K0"])
    p1 = P.normalize_by_intrinsics(tb["mkpts1"], tb["K1"])
    fm = (tb["K0"][:, 0, 0] + tb["K0"][:, 1, 1] + tb["K1"][:, 0, 0]
          + tb["K1"][:, 1, 1]) / 4.0
    fit = {k: v.numpy() for k, v in P.ransac_essential(
        p0, p1, tb["valid"], 0.5 / fm, iters=ITERS,
        sample_idx=t(idx)).items()}
    return ref, fits, got, fit


@pytest.fixture(scope="module", params=["noisy", "clean", "fail"])
def case(request):
    bt = _batch(request.param)
    with jax.enable_x64(True):
        ref, fits, got, fit = _run(bt, "f64")
    ref32, _, got32, _ = _run(bt, "f32")
    return dict(kind=request.param, ref=ref, got=got, fits=fits, fit=fit,
                ref32=ref32, got32=got32)


def test_ok_and_inlier_masks_match_jax(case):
    for i, ref in enumerate(case["fits"]):
        assert bool(case["fit"]["ok"][i]) == bool(ref["ok"]), i
        np.testing.assert_array_equal(case["fit"]["inliers"][i],
                                      ref["inliers"], err_msg=str(i))
        assert int(case["fit"]["num_inliers"][i]) == int(ref["num_inliers"])
    if case["kind"] == "fail":
        assert not case["fit"]["ok"].any()
    else:
        assert case["fit"]["ok"].all()


def test_pose_and_essential_match_jax(case):
    for i, ref in enumerate(case["fits"]):
        if not ref["ok"]:
            continue
        E, Er = case["fit"]["E"][i], ref["E"]
        s = np.sign((E * Er).sum())
        np.testing.assert_allclose(s * E, Er, atol=1e-6, err_msg=str(i))
        assert _angle_deg(case["fit"]["R"][i], ref["R"]) < DEG, i
        tt = case["fit"]["t"][i]
        ang = np.rad2deg(np.arccos(np.clip(
            tt @ ref["t"] / np.linalg.norm(tt) / np.linalg.norm(ref["t"]),
            -1, 1)))
        assert ang < DEG, (i, ang)


def test_pose_errors_match_jax(case):
    (t_ref, r_ref, n_ref, ok_ref), (t_got, r_got, n_got, ok_got) = \
        case["ref"], case["got"]
    np.testing.assert_array_equal(ok_got, ok_ref)
    np.testing.assert_array_equal(n_got, n_ref)
    for ref, got in ((t_ref, t_got), (r_ref, r_got)):
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], atol=DEG)
    if case["kind"] == "clean":
        assert (r_got < 0.3).all() and (t_got < 1.0).all()


def test_f32_pose_recovery_matches_jax(case):
    (t_ref, r_ref, _, ok_ref), (t_got, r_got, _, ok_got) = \
        case["ref32"], case["got32"]
    np.testing.assert_array_equal(ok_got, ok_ref)
    err_ref = np.maximum(t_ref, r_ref)
    err_got = np.maximum(t_got, r_got)
    np.testing.assert_array_equal(np.isinf(err_got), np.isinf(err_ref))
    good = err_ref < 5.0
    assert (err_got[good] < 5.0).all(), (err_got, err_ref)
    if case["kind"] == "clean":
        assert good.all()


def test_drawn_samples_recover_the_pose():
    """With the port's own draws (a torch.Generator, 512 hypotheses as the
    validation runs it) every noisy pair's fit is ok and within 10
    degrees: JAX's own draws (keys 0-3) give errors of up to 5.1 degrees on
    these pairs (200 points, 0.5 px noise, the second pair cut to 150)."""
    bt = {k: t(v) for k, v in _batch("noisy").items()}
    t_e, r_e, _, ok = P.batched_pose_errors(
        bt["mkpts0"], bt["mkpts1"], bt["valid"], bt["K0"], bt["K1"],
        bt["T_0to1"], generator=torch.Generator().manual_seed(0))
    assert ok.all()
    assert (torch.maximum(t_e, r_e) < 10.0).all(), (t_e, r_e)
    idx = gumbel_sample_idx(bt["valid"], ITERS,
                            torch.Generator().manual_seed(0), k=12)
    assert idx.shape == (4, ITERS, 12)
    assert bool(torch.gather(bt["valid"], 1, idx[1].reshape(1, -1)).all())
