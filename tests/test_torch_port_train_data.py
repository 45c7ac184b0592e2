"""The port's training data and supervision against the JAX package.

Pair data: sample_homography, warp_image and make_pair_batch get the random
numbers JAX draws along its own key splits (data/synthetic.py:230-273,
geometry/homography.py:232-246), injected as a dict of draws, and every
output is compared. Supervision: the sparse coarse GT and the fine window
labels of the same homographies and matches. The texture bank is the port's
own build of cpp/synthgen.cpp (the JAX package's binding is not imported:
it builds into cpp/).

Tolerances: homographies at 1e-5 rel (the same 8x8 solve in f32); images at
2e-3 abs: both packages invert H in f32 (jnp.linalg.inv vs torch.linalg.inv,
last-bit differences), which moves a bilinear tap by ~1e-4 px at 64x80 and a
pixel by at most the local gradient times that, and gamma (< 1.35) and the
blur keep it below 2e-3; the coarse masks, GT rows and fine labels exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.data.synthetic import (  # noqa: E402
    make_pair_batch as j_make_pair_batch,
)
from geoformer_tpu.geometry.homography import (  # noqa: E402
    sample_homography as j_sample_homography,
)
from geoformer_tpu.models.coarse_matching import CoarseMatches as JMatches  # noqa: E402
from geoformer_tpu.ops.image_warp import warp_image as j_warp_image  # noqa: E402
from geoformer_tpu.train.supervision import (  # noqa: E402
    spvs_coarse_homography_sparse as j_spvs_coarse,
    spvs_fine_homography as j_spvs_fine,
)
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.data.synthetic import (  # noqa: E402
    base_image_stream,
    make_pair_batch,
    pair_draws,
)
from geoformer_tpu_torch.geometry.homography import (  # noqa: E402
    sample_homography,
    sample_homography_draws,
)
from geoformer_tpu_torch.models.coarse_matching import CoarseMatches  # noqa: E402
from geoformer_tpu_torch.ops.image_warp import warp_image  # noqa: E402
from geoformer_tpu_torch.train.supervision import (  # noqa: E402
    spvs_coarse_homography_sparse,
    spvs_fine_homography,
)
from torch_port_util import assert_close, n, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

HW = (64, 80)


def jax_homography_draws(keys, hw):
    """The draws of the JAX sample_homography, one key per sample."""
    h, w = hw
    rg = max(h, w)

    def one(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        return dict(
            big=jax.random.randint(k1, (4, 2), -rg // 3, rg // 3)
            .astype(jnp.float32),
            small=jax.random.randint(k2, (4, 2), -5, 5).astype(jnp.float32),
            u_warp=jax.random.uniform(k3),
            flip=jax.random.randint(k4, (), 0, 2),
            u_flip=jax.random.uniform(k5, (2,)))

    return {k: t(v) for k, v in jax.vmap(one)(keys).items()}


def jax_pair_draws(key, b, hw):
    """The draws of the JAX make_pair_batch for key."""
    keys = jax.random.split(key, 6)
    draws = jax_homography_draws(jax.random.split(keys[0], b), hw)
    kb, kc, kn, kg, kbl = jax.random.split(keys[1], 5)
    shape = (b, 1, 1, 1)
    draws.update(
        bright=t(jax.random.uniform(kb, shape, minval=-0.1,
                                    maxval=0.1)).reshape(b),
        contrast=t(jax.random.uniform(kc, shape, minval=0.8,
                                      maxval=1.2)).reshape(b),
        noise=t(jax.random.normal(kn, (b, *hw, 1)))[..., 0],
        gamma=t(jax.random.uniform(kg, shape, minval=0.75,
                                   maxval=1.35)).reshape(b),
        u_blur=t(jax.random.uniform(kbl, shape)).reshape(b),
        u_swap=t(jax.random.uniform(keys[4], shape)).reshape(b))
    return draws


def test_sample_homography_matches_jax():
    keys = jax.random.split(jax.random.key(0), 64)
    ref = jax.vmap(lambda k: j_sample_homography(k, HW))(keys)
    draws = jax_homography_draws(keys, HW)
    # the draws cover every branch: small warps, flips, flip after H
    u = n(draws["u_flip"])
    assert (n(draws["u_warp"]) < 0.2).any() and (u[:, 0] < 0.2).any()
    assert ((u[:, 0] < 0.2) & (u[:, 1] >= 0.6)).any()
    assert_close(sample_homography(draws, HW), ref, 1e-5, 1e-4)


def test_homography_draws_ranges():
    gen = torch.Generator().manual_seed(0)
    d = sample_homography_draws(500, HW, gen)
    rg = max(HW)
    assert d["big"].min() >= -rg // 3 and d["big"].max() < rg // 3
    assert d["small"].min() >= -5 and d["small"].max() < 5
    assert set(n(d["flip"]).tolist()) == {0, 1}
    H = sample_homography(d, HW)
    assert H.shape == (500, 3, 3) and torch.isfinite(H).all()


def test_warp_image_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.random((3, *HW, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.key(1), 3)
    H = jax.vmap(lambda k: j_sample_homography(k, HW, small_warp_p=0.0,
                                               flip_p=0.0))(keys)
    ref = j_warp_image(jnp.asarray(img), H)
    got = warp_image(t(img), t(H))
    assert_close(got, ref, 0, 2e-3)
    assert (n(got)[n(ref) == 0] == 0).mean() > 0.99  # the same zero border


@pytest.mark.parametrize("seed", [0, 1])
def test_make_pair_batch_matches_jax(seed):
    b = 6
    base = np.random.default_rng(seed).random((b, *HW)).astype(np.float32)
    key = jax.random.key(seed)
    ref = j_make_pair_batch(jnp.asarray(base), key)
    draws = jax_pair_draws(key, b, HW)
    swap = n(draws["u_swap"]) < 0.5
    assert swap.any() and (~swap).any()
    got = make_pair_batch(t(base), draws=draws)
    for name in ("H_0to1", "H_1to0"):
        assert_close(got[name], ref[name], 1e-5, 1e-4, name)
    for name in ("image0", "image1"):
        assert got[name].shape == (b, *HW, 1)
        assert_close(got[name], ref[name], 0, 2e-3, name)
    for name in ("mask0", "mask1"):
        np.testing.assert_array_equal(n(got[name]), np.asarray(ref[name]))


def test_make_pair_batch_from_a_generator():
    base = torch.rand((2, *HW), generator=torch.Generator().manual_seed(0))
    a = make_pair_batch(base, torch.Generator().manual_seed(3))
    b = make_pair_batch(base, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["image0"].min() >= 0 and a["image1"].max() <= 1
    d = pair_draws(2, HW, torch.Generator().manual_seed(3))
    assert d["noise"].shape == (2, *HW) and "sensor0" not in d
    s = make_pair_batch(base, torch.Generator().manual_seed(3), sensor=True)
    assert all(torch.equal(a[k], s[k]) for k in ("H_0to1", "mask1"))
    assert not torch.equal(a["image0"], s["image0"])


def test_native_texture_bank_and_stream():
    bank = native.native_textures_mixed(4, 48, 64, seed=7)
    assert bank.shape == (4, 48, 64) and bank.dtype == np.float32
    assert bank.min() >= 0 and bank.max() <= 1 and bank.std() > 0.05
    np.testing.assert_array_equal(bank,
                                  native.native_textures_mixed(4, 48, 64, 7))
    assert native.build().parent.parent == native.BUILD_DIR
    plain = native.native_textures(2, 48, 64, seed=7)
    np.testing.assert_array_equal(plain[0], bank[0])  # index 0: structured
    stream = base_image_stream((48, 64), 3, seed=7, bank_size=4)
    rng = np.random.default_rng(7)
    for _ in range(2):
        np.testing.assert_array_equal(
            next(stream), bank[rng.integers(0, 4, size=3)])
    # a directory without images leaves the procedural bank alone
    stream = base_image_stream((48, 64), 3, seed=7, bank_size=4,
                               image_dir="no-such-dir")
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(next(stream),
                                  bank[rng.integers(0, 4, size=3)])
    # bank_refresh=1: every batch after the first from the bank of a new seed
    stream = base_image_stream((48, 64), 3, seed=7, bank_size=4,
                               bank_refresh=1)
    rng = np.random.default_rng(7)
    for i in range(3):
        bank_i = native.native_textures_mixed(4, 48, 64, 7 + 1009 * i)
        np.testing.assert_array_equal(next(stream),
                                      bank_i[rng.integers(0, 4, size=3)])


def _homographies(b, seed):
    keys = jax.random.split(jax.random.key(seed), b)
    H = jax.vmap(lambda k: j_sample_homography(k, HW))(keys)
    return H, jnp.linalg.inv(H)


@pytest.mark.parametrize("masked", [False, True])
def test_spvs_coarse_homography_sparse_matches_jax(masked):
    b = 8
    H01, H10 = _homographies(b, 2)
    m0 = m1 = None
    if masked:
        rng = np.random.default_rng(0)
        m0 = (rng.random((b, HW[0] // 8, HW[1] // 8)) > 0.2).astype(
            np.float32)
        m1 = (rng.random((b, HW[0] // 8, HW[1] // 8)) > 0.2).astype(
            np.float32)
    j = j_spvs_coarse(H01, H10, HW, 8,
                      *(None if m is None else jnp.asarray(m)
                        for m in (m0, m1)))
    got = spvs_coarse_homography_sparse(
        t(H01), t(H10), HW, 8, *(None if m is None else t(m)
                                 for m in (m0, m1)))
    assert np.asarray(j[1]).sum() > 10
    np.testing.assert_array_equal(n(got[1]), np.asarray(j[1]))
    np.testing.assert_array_equal(n(got[0]), np.asarray(j[0]))


def test_spvs_fine_homography_matches_jax():
    b, m = 4, 32
    rng = np.random.default_rng(1)
    H01, H10 = _homographies(b, 3)
    wc = HW[1] // 8
    l0 = (HW[0] // 8) * wc
    i_ids = rng.integers(0, l0, (b, m)).astype(np.int32)
    # matches near the true correspondence, so some windows are positive
    from geoformer_tpu.geometry.homography import warp_points
    from geoformer_tpu.models.coarse_matching import match_coords
    p = warp_points(match_coords(jnp.asarray(i_ids), wc, 8), H01) / 8
    cx = np.clip(np.round(np.asarray(p[..., 0])), 0, wc - 1)
    cy = np.clip(np.round(np.asarray(p[..., 1])), 0, HW[0] // 8 - 1)
    j_ids = (cy * wc + cx).astype(np.int32)
    valid = np.ones((b, m), bool)
    zeros = np.zeros((b, m), np.float32)
    ref = j_spvs_fine(JMatches(None, jnp.asarray(i_ids), jnp.asarray(j_ids),
                               jnp.asarray(valid), jnp.asarray(zeros)),
                      H01, wc, wc)
    got = spvs_fine_homography(CoarseMatches(None, t(i_ids).long(),
                                             t(j_ids).long(), t(valid),
                                             t(zeros)), t(H01), wc, wc)
    assert got.shape == (b, m, 25, 25) and np.asarray(ref).sum() > 10
    np.testing.assert_array_equal(n(got), np.asarray(ref))
