"""The port's SL(3) homography graph (engine/homography_graph.py) against
the JAX package's.

sl3_exp on seeded tangents at pixel-scale translations (f32, within 1e-5
of JAX relative to the largest entry: 8 squarings compound the
rounding). optimize_homography_graph on tests/test_engine.py's loop
graph (6 frames, noisy odometry, one heavily weighted exact loop
closure) and on a second graph with an invalid edge: in f64 (JAX under
enable_x64) the optimized homographies and the residual history equal
JAX's within 1e-9 relative; in f32, the path's dtype, the two packages'
results are within 1e-3 px of each other at the corners of a 480x640
frame and the history within 1e-4 relative. A graph solve on the CPU
runs 15 dense 48x48 solves, no float atomics, so two runs give the same
bits.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.engine import homography_graph as JG  # noqa: E402
from geoformer_tpu.geometry.homography import corner_error  # noqa: E402
from geoformer_tpu_torch.engine import homography_graph as PG  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

HW = (480, 640)


def test_sl3_exp_equals_jax():
    rng = np.random.default_rng(3)
    xi = rng.normal(0, 0.02, (16, 8)).astype(np.float32)
    xi[:, 4:6] = rng.normal(0, 30.0, (16, 2))
    xi[:, 6:] *= 1e-4
    xi[0] = 0.0
    j = np.asarray(JG.sl3_exp(jnp.asarray(xi)))
    p = PG.sl3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(p, j, atol=1e-5 * np.abs(j).max())
    np.testing.assert_array_equal(p[0], np.eye(3, dtype=np.float32))


def _loop_graph(invalid_edge: bool):
    """tests/test_engine.py:263's graph; with ``invalid_edge`` one more
    (wildly wrong) edge 1 -> 3 marked invalid."""
    rng = np.random.default_rng(8)
    K = 6
    Hs_gt = [np.eye(3, dtype=np.float32)]
    for _ in range(1, K):
        xi = rng.normal(0, 0.02, 8).astype(np.float32)
        xi[4] = 8.0 * rng.normal()
        xi[5] = 8.0 * rng.normal()
        xi[6:] *= 1e-4
        Hs_gt.append(np.asarray(JG.sl3_exp(jnp.asarray(xi))) @ Hs_gt[-1])
    ei, ej, eH = [], [], []
    for i in range(K - 1):
        noise_xi = rng.normal(0, 0.003, 8).astype(np.float32)
        noise_xi[4:6] *= 100
        noise_xi[6:] *= 1e-3
        noise = np.asarray(JG.sl3_exp(jnp.asarray(noise_xi)))
        eH.append(noise @ Hs_gt[i + 1] @ np.linalg.inv(Hs_gt[i]))
        ei.append(i)
        ej.append(i + 1)
    ei.append(0)
    ej.append(K - 1)
    eH.append(Hs_gt[K - 1] @ np.linalg.inv(Hs_gt[0]))
    H0 = [np.eye(3, dtype=np.float32)]
    for i in range(K - 1):
        H0.append(eH[i] @ H0[-1])
    weights = [1.0] * (len(ei) - 1) + [10.0]
    valid = [True] * len(ei)
    if invalid_edge:
        ei.append(1)
        ej.append(3)
        eH.append(np.diag([2.0, 0.5, 1.0]))
        weights.append(5.0)
        valid.append(False)
    return (np.stack(H0).astype(np.float32), np.asarray(ei),
            np.asarray(ej), np.stack(eH).astype(np.float32),
            np.asarray(valid), np.asarray(weights, np.float32), Hs_gt)


@functools.lru_cache(maxsize=None)
def _solve(invalid_edge, x64, iters=15):
    H0, ei, ej, eH, valid, w, Hs_gt = _loop_graph(invalid_edge)
    dt = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        jg = JG.HomographyGraph(
            H=jnp.asarray(H0, dt), edge_i=jnp.asarray(ei, jnp.int32),
            edge_j=jnp.asarray(ej, jnp.int32), edge_H=jnp.asarray(eH, dt),
            edge_valid=jnp.asarray(valid), edge_weight=jnp.asarray(w, dt))
        jH, jh = (np.asarray(x) for x in
                  JG.optimize_homography_graph(jg, iters=iters))
    tdt = torch.float64 if x64 else torch.float32
    pg = PG.HomographyGraph(
        H=torch.tensor(H0, dtype=tdt), edge_i=torch.from_numpy(ei),
        edge_j=torch.from_numpy(ej), edge_H=torch.tensor(eH, dtype=tdt),
        edge_valid=torch.from_numpy(valid),
        edge_weight=torch.tensor(w, dtype=tdt))
    pH, ph = (x.numpy() for x in PG.optimize_homography_graph(pg,
                                                               iters=iters))
    return jH, jh, pH, ph, pg, Hs_gt


def _corner_px(a, b):
    return max(float(corner_error(jnp.asarray(x, jnp.float32),
                                  jnp.asarray(y, jnp.float32), HW))
               for x, y in zip(a, b))


@pytest.mark.parametrize("invalid_edge", [False, True])
def test_graph_solve_equals_jax_in_f64(invalid_edge):
    jH, jh, pH, ph, _, _ = _solve(invalid_edge, x64=True)
    np.testing.assert_allclose(pH, jH, rtol=0, atol=1e-9 * np.abs(jH).max())
    np.testing.assert_allclose(ph, jh, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("invalid_edge", [False, True])
def test_graph_solve_within_the_f32_bar(invalid_edge):
    jH, jh, pH, ph, pg, Hs_gt = _solve(invalid_edge, x64=False)
    assert _corner_px(pH, jH) < 1e-3
    np.testing.assert_allclose(ph, jh, rtol=1e-4)
    # the loop closes as tests/test_engine.py requires of JAX
    assert np.mean([_corner_px([pH[k]], [Hs_gt[k]]) for k in range(6)]) < 3
    again = PG.optimize_homography_graph(pg, iters=15)[0].numpy()
    np.testing.assert_array_equal(again, pH)
