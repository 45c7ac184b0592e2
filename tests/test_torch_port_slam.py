"""The port's planar SLAM (engine/slam.py) against the JAX package's.

Both run_planar_slam drivers take the same injected exact matcher: for an
edge (i, j) of a 7-frame seeded SL(3) trajectory it returns 160 points of
frame i and their images in frame j under H_j H_i^-1 (0.3 px noise, 15 %
outliers), and 3 points for the edge (2, 5), whose fit fails. The JAX
fits draw from jax.random.key(0); the port's fits get the same samples
injected (tests/torch_port_util.JaxDrawsMatcher.patch_fits). Bars: the
edges' diagnostics equal (ok, match and inlier counts; rms within 1e-4
px), the chained odometry's corners within 1e-3 px (the f32 fits' IRLS
polish differs between LAPACKs at ~1e-4 px), and the optimized
trajectory's corners within 1e-2 px of JAX's (the f32 SL(3) solve;
tests/test_torch_port_homography_graph.py holds the solve alone), the
corner drifts within 1e-2 px. trajectory_drift and save_trajectory are
held to JAX's on the same homographies (drift within 1e-5 px, the same
text).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.engine import homography_graph as JG  # noqa: E402
from geoformer_tpu.engine import slam as JS  # noqa: E402
from geoformer_tpu.geometry.homography import corner_error  # noqa: E402
from geoformer_tpu_torch.engine import slam as PS  # noqa: E402
from torch_port_util import JaxDrawsMatcher  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

HW = (240, 320)
FRAMES = 7
STRIDE = 3


def _trajectory():
    rng = np.random.default_rng(5)
    Hs = [np.eye(3, dtype=np.float32)]
    for _ in range(1, FRAMES):
        xi = rng.normal(0, 0.01, 8).astype(np.float32)
        xi[4:6] = rng.normal(0, 6.0, 2)
        xi[6:] *= 1e-4
        Hs.append(np.asarray(JG.sl3_exp(jnp.asarray(xi))) @ Hs[-1])
    return np.stack(Hs)


def _matcher(Hs):
    def match(i, j):
        rng = np.random.default_rng(100 * i + j)
        n = 3 if (i, j) == (2, 5) else 160
        p0 = rng.uniform([20, 20], [HW[1] - 20, HW[0] - 20], (n, 2))
        Hij = Hs[j] @ np.linalg.inv(Hs[i])
        ph = np.concatenate([p0, np.ones((n, 1))], 1) @ Hij.T
        p1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.3, (n, 2))
        out = rng.random(n) < 0.15
        p1[out] = rng.uniform([0, 0], [HW[1], HW[0]], (int(out.sum()), 2))
        return p0.astype(np.float32), p1.astype(np.float32)
    return match


def _corners(a, b):
    return max(float(corner_error(jnp.asarray(x, jnp.float32),
                                  jnp.asarray(y, jnp.float32), HW))
               for x, y in zip(a, b))


def test_build_edges_equals_jax():
    for k, s in ((1, 0), (2, 5), (7, 3), (12, 5), (5, 1)):
        assert PS.build_edges(k, s) == JS.build_edges(k, s)


def test_run_planar_slam_equals_jax(monkeypatch):
    Hs = _trajectory()
    frames = [np.zeros(HW, np.float32)] * FRAMES
    match = _matcher(Hs)
    j = JS.run_planar_slam(frames, match, loop_stride=STRIDE, log=lambda *a:
                           None)
    JaxDrawsMatcher.patch_fits(monkeypatch, PS)
    logged = []
    p = PS.run_planar_slam(frames, match, loop_stride=STRIDE,
                           log=logged.append, device="cpu")
    assert logged == ["edge 2->5: fit failed (3 matches)"]
    assert len(p["edges"]) == len(j["edges"]) == 10
    for pe, je in zip(p["edges"], j["edges"]):
        assert {k: v for k, v in pe.items() if k != "rms_px"} == \
            {k: v for k, v in je.items() if k != "rms_px"}
        if je["ok"]:
            assert abs(pe["rms_px"] - je["rms_px"]) <= 1e-4
    assert _corners(p["H_chained"], j["H_chained"]) < 1e-3
    assert _corners(p["H_traj"], j["H_traj"]) < 1e-2
    for key in ("H_chained", "H_traj"):
        d_p = PS.trajectory_drift(p[key], Hs, HW)
        d_j = JS.trajectory_drift(j[key], Hs, HW)
        assert abs(d_p - d_j) < 1e-2, (key, d_p, d_j)
    # loop closure helps, as in tests/test_slam.py
    assert PS.trajectory_drift(p["H_traj"], Hs, HW) < 1.0


def test_drift_and_trajectory_file_equal_jax(tmp_path):
    Hs = _trajectory()
    est = Hs * np.float32(1.01) + np.float32(1e-4)
    assert abs(PS.trajectory_drift(est, Hs, HW)
               - JS.trajectory_drift(est, Hs, HW)) < 1e-5
    PS.save_trajectory(est, str(tmp_path / "p.txt"))
    JS.save_trajectory(est, str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_text() == \
        (tmp_path / "j.txt").read_text()


def test_no_edge_fits_returns_the_chain():
    frames = [np.zeros(HW, np.float32)] * 3
    res = PS.run_planar_slam(
        frames, lambda i, j: (np.zeros((2, 2)), np.zeros((2, 2))),
        log=lambda *a: None, device="cpu")
    np.testing.assert_array_equal(res["H_traj"], np.tile(np.eye(3),
                                                         (3, 1, 1)))
    assert [e["ok"] for e in res["edges"]] == [False, False]
