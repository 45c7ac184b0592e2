"""Port matching: streamed extraction, capacities, coarse and fine decode.

Each function gets the same seeded numpy inputs as its JAX counterpart.
Tolerances: the streamed LSE vectors at 1e-5 rel / 1e-5 abs (f32 sums in
another order); confidences, exp(2 sim - r - c) of LSEs in the tens, at
1e-4 rel; indices, validity and selections exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.core import capacity as jcap  # noqa: E402
from geoformer_tpu.models import coarse_matching as jcm  # noqa: E402
from geoformer_tpu.models import fine as jfine  # noqa: E402
from geoformer_tpu.ops import fused_loss as jfl  # noqa: E402
from geoformer_tpu.ops.matching import dual_softmax as j_dual  # noqa: E402
from geoformer_tpu_torch.core import capacity as tcap  # noqa: E402
from geoformer_tpu_torch.models import coarse_matching as tcm  # noqa: E402
from geoformer_tpu_torch.models import fine as tfine  # noqa: E402
from geoformer_tpu_torch.ops import streaming_match as tsm  # noqa: E402
from geoformer_tpu_torch.ops.matching import dual_softmax  # noqa: E402
from torch_port_util import assert_close, flatten, n, t  # noqa: E402
from geoformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401


def _feats(seed, b=2, l=70, s=60, c=16, scale=1.5, noise=0.1):
    rng = np.random.default_rng(seed)
    f0 = (rng.normal(size=(b, l, c)) * scale).astype(np.float32)
    f1 = (rng.normal(size=(b, s, c)) * scale).astype(np.float32)
    f1[:, : min(l, s) // 2] = f0[:, : min(l, s) // 2] + noise * rng.normal(
        size=(b, min(l, s) // 2, c))         # some true correspondences
    return f0, f1


def _masks(seed, b, l, s):
    rng = np.random.default_rng(seed + 100)
    m0 = (rng.random((b, l)) > 0.2).astype(np.float32)
    m1 = (rng.random((b, s)) > 0.2).astype(np.float32)
    return m0, m1


@pytest.mark.parametrize("chunk", [7, 32, 600])
@pytest.mark.parametrize("masked", [False, True])
def test_sim_lse_matches_jax(chunk, masked):
    f0, f1 = _feats(0)
    m0, m1 = _masks(0, 2, 70, 60) if masked else (None, None)
    jm = (None, None) if not masked else (jnp.asarray(m0), jnp.asarray(m1))
    tm = (None, None) if not masked else (t(m0), t(m1))
    r_ref, c_ref = jfl.sim_lse(jnp.asarray(f0), jnp.asarray(f1), 0.1, *jm,
                               chunk=chunk)
    r, c = tsm.sim_lse(t(f0), t(f1), 0.1, *tm, chunk=chunk)
    assert_close(r, r_ref, 1e-5, 1e-5)
    assert_close(c, c_ref, 1e-5, 1e-5)


@pytest.mark.parametrize("chunk", [7, 600])
@pytest.mark.parametrize("masked", [False, True])
def test_streaming_match_extract_matches_jax(chunk, masked):
    f0, f1 = _feats(1)
    m0, m1 = _masks(1, 2, 70, 60) if masked else (None, None)
    jm = (None, None) if not masked else (jnp.asarray(m0), jnp.asarray(m1))
    tm = (None, None) if not masked else (t(m0), t(m1))
    ref = jfl.streaming_match_extract(jnp.asarray(f0), jnp.asarray(f1), 0.1,
                                      *jm, chunk=chunk)
    got = tsm.streaming_match_extract(t(f0), t(f1), 0.1, *tm, chunk=chunk)
    assert_close(got[0], ref[0], 1e-4, 1e-6, "row_best")
    np.testing.assert_array_equal(n(got[1]), np.asarray(ref[1]))
    if not masked:  # masked columns' argmax is a tie among -1e9 rows
        np.testing.assert_array_equal(n(got[2]), np.asarray(ref[2]))
    assert_close(got[3], ref[3], 1e-4, 1e-6, "conf00")


@pytest.mark.parametrize("capacity", [1, 5, 16, 40])
def test_masked_select_capacity_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    mask = rng.random((3, 30)) > 0.5
    mask[2] = False
    idx, ok = tcap.masked_select_capacity(t(mask), capacity)
    for b in range(3):
        ri, rok = jcap.masked_select_capacity(jnp.asarray(mask[b]), capacity)
        np.testing.assert_array_equal(n(ok[b]), np.asarray(rok))
        np.testing.assert_array_equal(n(idx[b])[n(ok[b])],
                                      np.asarray(ri)[np.asarray(rok)])


@pytest.mark.parametrize("capacity", [4, 20])
def test_topk_select_matches_jax_with_ties(capacity):
    rng = np.random.default_rng(capacity)
    score = rng.integers(0, 5, size=(2, 25)).astype(np.float32)  # many ties
    valid = rng.random((2, 25)) > 0.3
    idx, ok = tcap.topk_select(t(score), t(valid), capacity)
    for b in range(2):
        ri, rok = jcap.topk_select(jnp.asarray(score[b]),
                                   jnp.asarray(valid[b]), capacity)
        np.testing.assert_array_equal(n(idx[b]), np.asarray(ri))
        np.testing.assert_array_equal(n(ok[b]), np.asarray(rok))


@pytest.mark.parametrize("capacity", [-1, 16, 100])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("force_one", [False, True])
def test_coarse_match_matches_jax(capacity, masked, force_one):
    f0, f1 = _feats(2, l=80, s=80, noise=1.0)
    m0, m1 = _masks(2, 2, 80, 80) if masked else (None, None)
    jm = (None, None) if not masked else (jnp.asarray(m0), jnp.asarray(m1))
    tm = (None, None) if not masked else (t(m0), t(m1))
    thr = 0.05 if not force_one else 0.99
    ref = jcm.coarse_match(jnp.asarray(f0), jnp.asarray(f1), thr, 0.1,
                           capacity, *jm, force_one=force_one,
                           streaming=True)
    got = tcm.coarse_match(t(f0), t(f1), thr, 0.1, capacity, *tm,
                           force_one=force_one)
    np.testing.assert_array_equal(n(got.valid), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    if not force_one:
        assert v.any()
    # the selected (i, j) sets agree; their order may not, since top-k
    # orders confidences that saturate near 1 and differ in the last bit
    for b in range(2):
        pairs = lambda m: sorted(zip(n(m.i_ids[b])[v[b]].tolist(),  # noqa
                                     n(m.j_ids[b])[v[b]].tolist()))
        assert pairs(got) == pairs(ref)
        assert_close(np.sort(n(got.mconf[b])), np.sort(n(ref.mconf[b])),
                     1e-4, 1e-6)
    assert got.conf.shape == (2, 0, 0)


def test_dense_coarse_match_is_not_ported_yet():
    """The dense path (streaming=False) is ported: it gives JAX's dense
    matches and returns the confidence it extracted them from."""
    f0, f1 = _feats(3)
    ref = jcm.coarse_match(jnp.asarray(f0), jnp.asarray(f1), 0.2,
                           streaming=False)
    got = tcm.coarse_match(t(f0), t(f1), 0.2, streaming=False)
    assert_close(got.conf, ref.conf, 1e-4, 1e-6, "conf")
    np.testing.assert_array_equal(n(got.valid), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(n(got.j_ids)[v], np.asarray(ref.j_ids)[v])


@pytest.mark.parametrize("masked", [False, True])
def test_dual_softmax_matches_jax(masked):
    f0, f1 = _feats(4, l=25, s=25)
    m0, m1 = _masks(4, 2, 25, 25) if masked else (None, None)
    jm = (None, None) if not masked else (jnp.asarray(m0), jnp.asarray(m1))
    tm = (None, None) if not masked else (t(m0), t(m1))
    assert_close(dual_softmax(t(f0), t(f1), 0.1, *tm),
                 j_dual(jnp.asarray(f0), jnp.asarray(f1), 0.1, *jm),
                 1e-4, 1e-7)


def test_match_coords_matches_jax():
    ids = np.arange(0, 4800, 7).reshape(2, -1)
    assert_close(tcm.match_coords(t(ids), 80, 8),
                 jcm.match_coords(jnp.asarray(ids), 80, 8), 0, 0)


@pytest.mark.parametrize("window", [3, 5])
def test_gather_windows_matches_jax(window):
    rng = np.random.default_rng(window)
    feat = rng.normal(size=(2, 16, 20, 6)).astype(np.float32)
    ids = rng.integers(0, 4 * 5, size=(2, 9))
    ref = jfine.gather_windows(jnp.asarray(feat), jnp.asarray(ids), 5, 4,
                               window)
    assert_close(tfine.gather_windows(t(feat), t(ids), 5, 4, window), ref,
                 0, 0)


def test_fine_preprocess_matches_jax():
    rng = np.random.default_rng(5)
    ff0, ff1 = (rng.normal(size=(2, 16, 20, 8)).astype(np.float32)
                for _ in range(2))
    fc0, fc1 = (rng.normal(size=(2, 20, 12)).astype(np.float32)
                for _ in range(2))
    ids = rng.integers(0, 20, size=(2, 2, 6))
    matches = jcm.CoarseMatches(None, jnp.asarray(ids[0]),
                                jnp.asarray(ids[1]), None, None)
    jmod = jfine.FinePreprocess(8, 12, 5, True)
    args = (jnp.asarray(ff0), jnp.asarray(ff1), jnp.asarray(fc0),
            jnp.asarray(fc1), matches, 4, 5, 5)
    variables = jmod.init(jax.random.key(0), *args)
    ref = jmod.apply(variables, *args)
    tmod = load_jax_params(tfine.FinePreprocess(8, 12, 5, True),
                           flatten(variables))
    tm = tcm.CoarseMatches(None, t(ids[0]), t(ids[1]), None, None)
    got = tmod(t(ff0), t(ff1), t(fc0), t(fc1), tm, 4, 5, 5)
    for a, b in zip(got, ref):
        assert_close(a, b, 1e-4, 1e-5)


def test_fine_matching_matches_jax():
    rng = np.random.default_rng(6)
    conf = rng.random((2, 7, 25, 25)).astype(np.float32) ** 8
    ids = rng.integers(0, 80, size=(2, 2, 7))
    valid = rng.random((2, 7)) > 0.3
    jm = jcm.CoarseMatches(None, jnp.asarray(ids[0]), jnp.asarray(ids[1]),
                           jnp.asarray(valid), None)
    tm = tcm.CoarseMatches(None, t(ids[0]), t(ids[1]), t(valid), None)
    ref = jfine.fine_matching(jnp.asarray(conf), jm, 10, 10, 8, 2, 5, 0.5)
    got = tfine.fine_matching(t(conf), tm, 10, 10, 8, 2, 5, 0.5)
    for name in ("mkpts0", "mkpts1", "mconf", "valid"):
        assert_close(getattr(got, name), getattr(ref, name), 0, 0, name)
