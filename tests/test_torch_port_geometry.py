"""Port geometry: homography helpers and batched RANSAC against JAX.

The RANSAC hypotheses are drawn with JAX exactly as ransac.py:110-112 draws
them (Gumbel noise + top-4 over the valid entries) and injected into the
port, so both solvers score the same hypotheses. Tolerances: warps and
solves 1e-4 rel (f32); the fitted H 1e-3 rel / 1e-3 abs (an f32 eigen-solve
of a 9x9 normal matrix); inlier sets, counts and ok flags exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.geometry import homography as jh  # noqa: E402
from geoformer_tpu.geometry.ransac import (  # noqa: E402
    dlt_homography as j_dlt,
    ransac_homography as j_ransac,
)
from geoformer_tpu_torch.geometry import homography as th  # noqa: E402
from geoformer_tpu_torch.geometry import ransac as tr  # noqa: E402
from torch_port_util import assert_close, n, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401


def _homographies(rng, b):
    return (np.eye(3)[None] + np.concatenate([
        0.05 * rng.normal(size=(b, 2, 3)),
        1e-4 * rng.normal(size=(b, 1, 3))], axis=1)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_points_matches_jax(seed):
    rng = np.random.default_rng(seed)
    H = _homographies(rng, 3)
    pts = (rng.random((3, 50, 2)) * 600).astype(np.float32)
    H[0, 2] = (0, 0, 0)      # zero denominator -> eps guard
    assert_close(th.warp_points(t(pts), t(H)),
                 jh.warp_points(jnp.asarray(pts), jnp.asarray(H)), 1e-5, 1e-3)


def test_warp_points_broadcasts_grid_over_batch():
    rng = np.random.default_rng(2)
    H = _homographies(rng, 4)
    grid = (rng.random((1, 30, 2)) * 100).astype(np.float32)
    out = th.warp_points(t(grid), t(H))
    assert out.shape == (4, 30, 2)
    assert_close(out, jh.warp_points(jnp.asarray(grid), jnp.asarray(H)),
                 1e-5, 1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_four_point_homography_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src = (rng.random((6, 4, 2)) * 500).astype(np.float32)
    dst = (src + rng.normal(size=src.shape) * 20).astype(np.float32)
    ref = jax.vmap(jh.four_point_homography)(jnp.asarray(src),
                                             jnp.asarray(dst))
    got = th.four_point_homography(t(src), t(dst))
    assert_close(got, ref, 1e-3, 1e-5)
    # and it maps the four points
    assert_close(th.warp_points(t(src), got), dst, 0, 1e-2)


def test_solve8_pivots_and_flags_singular_systems():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(5, 8, 8)).astype(np.float32)
    A[:, 0, 0] = 0.0                 # forces a row swap at the first step
    b = rng.normal(size=(5, 8)).astype(np.float32)
    A[4] = 0.0                       # singular system
    got = n(th.solve8(t(A), t(b)))
    ref = np.asarray(jax.vmap(jh._solve8)(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(got[:4], ref[:4], rtol=1e-3, atol=1e-4)
    assert not np.isfinite(got[4]).all() and not np.isfinite(ref[4]).all()


def _correspondences(seed, b=2, m=64, n_valid=(50, 30), outliers=0.3):
    rng = np.random.default_rng(seed)
    H = _homographies(rng, b)
    pts0 = (rng.random((b, m, 2)) * np.array([640, 480])).astype(np.float32)
    pts1 = np.asarray(jh.warp_points(jnp.asarray(pts0), jnp.asarray(H)))
    pts1 = pts1 + rng.normal(size=pts1.shape) * 1.5
    bad = rng.random((b, m)) < outliers
    pts1[bad] = rng.random((int(bad.sum()), 2)) * 600
    valid = np.zeros((b, m), bool)
    for i, k in enumerate(n_valid):
        valid[i, :k] = True
    return pts0, pts1.astype(np.float32), valid


def _jax_samples(keys, valid, iters):
    """ransac.py:110-112, per batch row."""
    def one(key, v):
        g = jax.random.gumbel(key, (iters, v.shape[0]))
        return jax.lax.top_k(jnp.where(v[None, :], g, -jnp.inf), 4)[1]
    return np.asarray(jax.vmap(one)(keys, jnp.asarray(valid)))


@pytest.mark.parametrize("seed,thr", [(0, 8.0), (1, 3.0), (2, 8.0)])
def test_ransac_with_injected_samples_matches_jax(seed, thr):
    pts0, pts1, valid = _correspondences(seed)
    iters = 32
    keys = jax.random.split(jax.random.key(seed), pts0.shape[0])
    ref = jax.vmap(lambda k, a, b_, v: j_ransac(
        k, a, b_, v, thr=thr, iters=iters, refine_iters=2))(
            keys, jnp.asarray(pts0), jnp.asarray(pts1), jnp.asarray(valid))
    idx = _jax_samples(keys, valid, iters)
    got = tr.ransac_homography(t(pts0), t(pts1), t(valid), thr=thr,
                               iters=iters, refine_iters=2,
                               sample_idx=t(idx))
    np.testing.assert_array_equal(n(got["inliers"]),
                                  np.asarray(ref["inliers"]))
    np.testing.assert_array_equal(n(got["num_inliers"]),
                                  np.asarray(ref["num_inliers"]))
    np.testing.assert_array_equal(n(got["ok"]), np.asarray(ref["ok"]))
    assert_close(got["H"], ref["H"], 1e-3, 1e-3)


def test_ransac_with_too_few_matches_is_not_ok():
    pts0, pts1, valid = _correspondences(4, n_valid=(3, 0))
    got = tr.ransac_homography(t(pts0), t(pts1), t(valid), thr=8.0, iters=16,
                               generator=torch.Generator().manual_seed(0))
    assert not n(got["ok"]).any()
    assert np.isfinite(n(got["H"])).all()


def test_dlt_matches_jax():
    pts0, pts1, valid = _correspondences(5, outliers=0.0)
    w = valid.astype(np.float32)
    ref = jax.vmap(j_dlt)(jnp.asarray(pts0), jnp.asarray(pts1),
                          jnp.asarray(w))
    assert_close(tr.dlt_homography(t(pts0), t(pts1), t(w)), ref, 1e-3, 1e-3)


def test_gumbel_samples_are_distinct_valid_entries():
    valid = torch.zeros((3, 40), dtype=torch.bool)
    valid[0, :10] = True
    valid[1, 5:9] = True
    valid[2] = True
    idx = tr.gumbel_sample_idx(valid, 64, torch.Generator().manual_seed(1))
    assert idx.shape == (3, 64, 4)
    for b in range(3):
        assert valid[b][idx[b]].all()
        assert (idx[b].sort(-1).values.diff(dim=-1) > 0).all()
    # the generator decides the draw
    again = tr.gumbel_sample_idx(valid, 64, torch.Generator().manual_seed(1))
    assert torch.equal(idx, again)
