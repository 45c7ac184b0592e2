"""The port's Lie maps and PnP RANSAC (engine/lie.py, engine/pnp.py)
against the JAX package's.

Lie maps: so3/se3 exp and log on seeded tangents at, near and away from
0 (the series branch below |w| = 1e-2 and the closed forms), in f32
within 1e-6 of JAX, and their forward-mode Jacobians at 0 within 1e-5.

PnP: both run on the same capacity-padded 2D-3D sets with JAX's draws
injected (the [256, 6] samples pnp_ransac takes from its key, Gumbel
top-6 over the valid entries, handed to the port as ``sample_idx``). The
scenes are tests/test_engine.py's: a general one (points at depth 4-8)
and the planar wall of test_pnp_ransac_planar_scene (near 180 deg roll),
each with 0.5 px noise and 20 % outliers, and a set with 5 valid points
(below min_valid). In f64 (JAX under enable_x64, the port on f64 tensors)
every decision is the same: ``ok``, the inlier mask and the count equal,
T within 1e-8. In f32, the path's dtype, the 12x12 DLT normal matrix is
ill-conditioned and the two LAPACKs may order near-tied hypotheses
differently, so f32 is held by the pose: ``ok`` equal, inlier counts
within 2, and each package's T within 1e-3 (rotation entries and
translation, the scene's units) of the other's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.engine import lie as JL  # noqa: E402
from geoformer_tpu.engine import pnp as JP  # noqa: E402
from geoformer_tpu_torch.engine import lie as PL  # noqa: E402
from geoformer_tpu_torch.engine import pnp as PP  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ITERS = 256
F32_T = 1e-3


def _tangents():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.5, size=(8, 6))
    xi[0] = 0.0                                    # the identity
    xi[1, :3] = [3e-5, -2e-5, 1e-5]                # deep in the series
    xi[2, :3] = rng.normal(size=3) * 5e-3          # just inside it
    xi[3, :3] = rng.normal(size=3) * 2e-2          # just outside
    return xi.astype(np.float32)


def test_so3_se3_maps_equal_jax():
    xi = _tangents()
    T_j = np.asarray(JL.se3_exp(jnp.asarray(xi)))
    T_p = PL.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T_p, T_j, atol=1e-6)
    np.testing.assert_allclose(PL.se3_log(torch.from_numpy(T_j)).numpy(),
                               np.asarray(JL.se3_log(jnp.asarray(T_j))),
                               atol=1e-6)
    w = xi[:, :3]
    R_j = np.asarray(JL.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(PL.so3_exp(torch.from_numpy(w)).numpy(), R_j,
                               atol=1e-6)
    np.testing.assert_allclose(PL.so3_log(torch.from_numpy(R_j)).numpy(),
                               np.asarray(JL.so3_log(jnp.asarray(R_j))),
                               atol=1e-6)
    pts = np.random.default_rng(1).normal(size=(8, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        PL.se3_apply(torch.from_numpy(T_j), torch.from_numpy(pts)).numpy(),
        np.asarray(JL.se3_apply(jnp.asarray(T_j), jnp.asarray(pts))),
        atol=1e-5)


@pytest.mark.parametrize("fn", ["se3_exp", "se3_log_of_exp"])
def test_jacobians_at_zero_are_finite_and_equal(fn):
    z = np.zeros(6, np.float32)

    def j_fn(x):
        T = JL.se3_exp(x)
        return T if fn == "se3_exp" else JL.se3_log(T)

    def p_fn(x):
        T = PL.se3_exp(x)
        return T if fn == "se3_exp" else PL.se3_log(T)

    J_j = np.asarray(jax.jacfwd(j_fn)(jnp.asarray(z)))
    J_p = torch.func.jacfwd(p_fn)(torch.from_numpy(z)).numpy()
    assert np.isfinite(J_p).all()
    np.testing.assert_allclose(J_p, J_j, atol=1e-5)


def _scene(kind):
    """(P [cap, 3], U [cap, 2], V [cap], K, T_gt) of tests/test_engine.py's
    PnP scenes."""
    if kind == "general":
        rng = np.random.default_rng(11)
        K = np.array([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]])
        xi = np.array([0.05, -0.1, 0.03, 0.4, -0.2, 0.1])
        n, cap = 80, 128
        T_gt = np.asarray(JL.se3_exp(jnp.asarray(xi, jnp.float32)),
                          np.float64)
        pts = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3))
    else:
        rng = np.random.default_rng(7)
        K = np.array([[520.0, 0, 320], [0, 520, 240], [0, 0, 1]])
        xi = np.array([0.03, 0.02, 3.10, 0.3, -0.1, 0.5])
        T_gt = np.asarray(JL.se3_exp(jnp.asarray(xi, jnp.float32)),
                          np.float64)
        T_gt[:3, 3] = [0.2, -0.1, 0.4]
        n, cap = 200, 512
        pts = np.column_stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                               np.full(n, 8.0)])
    pc = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    vis = pc[:, 2] > 0.5
    pts, pc = pts[vis], pc[vis]
    n = len(pts)
    uv = (pc / pc[:, 2:]) @ K.T
    uv = uv[:, :2] + rng.normal(0, 0.5, (n, 2))
    uv[:n // 5] = rng.uniform(0, 640, (n // 5, 2))
    if kind == "few":
        n = 5
    P = np.zeros((cap, 3))
    U = np.zeros((cap, 2))
    V = np.zeros(cap, bool)
    P[:n], U[:n], V[:n] = pts[:n], uv[:n], True
    return P, U, V, K, T_gt


def jax_pnp_sample_idx(key, valid, iters=ITERS):
    """The [iters, 6] samples JAX's pnp_ransac draws from ``key``."""
    g = jax.random.gumbel(key, (iters, len(valid)))
    return np.asarray(jax.lax.top_k(
        jnp.where(jnp.asarray(valid)[None], g, -jnp.inf), 6)[1])


def _both(kind, x64, seed=0):
    P, U, V, K, T_gt = _scene(kind)
    key = jax.random.key(seed)
    dt = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        j = JP.pnp_ransac(key, jnp.asarray(P, dt), jnp.asarray(U, dt),
                          jnp.asarray(K, dt), jnp.asarray(V), thr_px=4.0)
        j = {k: np.asarray(v) for k, v in j.items()}
    idx = jax_pnp_sample_idx(key, V)
    tdt = torch.float64 if x64 else torch.float32
    p = PP.pnp_ransac(torch.tensor(P, dtype=tdt), torch.tensor(U, dtype=tdt),
                      torch.tensor(K, dtype=tdt), torch.from_numpy(V),
                      thr_px=4.0, sample_idx=torch.from_numpy(idx))
    return j, {k: v.numpy() for k, v in p.items()}, T_gt


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_pnp_decisions_equal_jax_in_f64(kind):
    j, p, T_gt = _both(kind, x64=True)
    assert bool(j["ok"]) and bool(p["ok"])
    np.testing.assert_array_equal(p["inliers"], j["inliers"])
    assert int(p["num_inliers"]) == int(j["num_inliers"])
    np.testing.assert_allclose(p["T"], j["T"], atol=1e-8)
    # and the pose is the scene's (tests/test_engine.py's bars)
    dR = p["T"][:3, :3].T @ T_gt[:3, :3]
    assert np.rad2deg(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 1


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_pnp_pose_within_the_f32_bar(kind):
    j, p, _ = _both(kind, x64=False)
    assert bool(j["ok"]) and bool(p["ok"])
    assert abs(int(p["num_inliers"]) - int(j["num_inliers"])) <= 2
    np.testing.assert_allclose(p["T"], j["T"], atol=F32_T)


def test_pnp_below_min_valid_is_not_ok():
    j, p, _ = _both("few", x64=False)
    assert not bool(j["ok"]) and not bool(p["ok"])
    assert np.isfinite(p["T"]).all()


def test_pnp_draws_from_a_generator():
    P, U, V, K, T_gt = _scene("general")
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    outs = [PP.pnp_ransac(f(P), f(U), f(K), torch.from_numpy(V), thr_px=4.0,
                          generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    np.testing.assert_array_equal(outs[0]["T"].numpy(), outs[1]["T"].numpy())
    for o in outs:
        assert bool(o["ok"])
        dR = o["T"].numpy()[:3, :3].T @ T_gt[:3, :3]
        assert np.rad2deg(np.arccos(np.clip((np.trace(dR) - 1) / 2,
                                            -1, 1))) < 1.0
