"""The port's fit_homography_np against the JAX one on the CPU.

The JAX fit draws its 4-point samples with jax.random.gumbel + top_k from
jax.random.key(seed); the test draws the same indices with JAX and injects
them into the port, so both score the same hypotheses. Tolerances: H at
1e-3 relative (the same f32 8x8 solves and IRLS polish, XLA's eigh against
torch's; measured <= 1.5e-5, and 7.4e-4 for the six-point fit), inlier
masks exactly; None exactly where the JAX fit gives None.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu.eval.hpatches import fit_homography_np as j_fit  # noqa: E402
from geoformer_tpu_torch.eval.hpatches import fit_homography_np  # noqa: E402
from torch_port_util import jax_fit_sample_idx as jax_sample_idx  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

H_TRUE = np.array([[0.9, 0.08, 20.0], [-0.05, 1.1, -12.0], [2e-4, -1e-4, 1.0]])


def correspondences(n, outliers, seed):
    """n matches under H_TRUE with 0.5 px noise; ``outliers`` of them
    replaced by random points."""
    rng = np.random.default_rng(seed)
    p0 = rng.random((n, 2)) * [640, 480]
    ph = np.concatenate([p0, np.ones((n, 1))], 1) @ H_TRUE.T
    p1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.5, (n, 2))
    k = rng.choice(n, outliers, replace=False)
    p1[k] = rng.random((outliers, 2)) * [640, 480]
    return p0.astype(np.float32), p1.astype(np.float32)


@pytest.mark.parametrize("n,outliers,seed", [(6, 1, 0), (70, 20, 1),
                                             (300, 150, 2), (1024, 300, 3)])
def test_fit_matches_jax_with_injected_samples(n, outliers, seed):
    p0, p1 = correspondences(n, outliers, seed)
    H_ref, inl_ref = j_fit(p0, p1, 3.0, seed=seed)
    H, inl = fit_homography_np(p0, p1, 3.0, seed=seed, device="cpu",
                               sample_idx=jax_sample_idx(n, seed))
    assert H_ref is not None and H is not None
    assert H.shape == (3, 3) and inl.shape == (n,)
    np.testing.assert_allclose(H, H_ref, rtol=1e-3, atol=1e-3 * np.abs(
        H_ref).max())
    np.testing.assert_array_equal(inl, inl_ref)


def test_fit_with_its_own_draws_finds_the_homography():
    p0, p1 = correspondences(500, 200, 4)
    for seed in (0, 1):
        H, inl = fit_homography_np(p0, p1, 3.0, seed=seed, device="cpu")
        assert inl.sum() >= 280
        np.testing.assert_allclose(H / H[2, 2], H_TRUE, rtol=0.05,
                                   atol=5e-3)
    a = fit_homography_np(p0, p1, 3.0, seed=7, device="cpu")
    b = fit_homography_np(p0, p1, 3.0, seed=7, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])


def test_fit_gives_none_where_jax_does():
    p0, p1 = correspondences(3, 0, 5)
    assert j_fit(p0, p1, 3.0) == (None, None)
    assert fit_homography_np(p0, p1, 3.0, device="cpu") == (None, None)
    # degenerate: every point on one line, the targets scattered
    rng = np.random.default_rng(6)
    t = rng.random(40)
    q0 = np.stack([t * 600, t * 400], 1).astype(np.float32)
    q1 = (rng.random((40, 2)) * 500).astype(np.float32)
    assert j_fit(q0, q1, 3.0)[0] is None
    H, inl = fit_homography_np(q0, q1, 3.0, device="cpu",
                               sample_idx=jax_sample_idx(40, 0))
    assert H is None and inl is None


def test_fit_truncates_beyond_the_cap_with_a_warning():
    p0, p1 = correspondences(80, 10, 7)
    with pytest.warns(UserWarning, match="truncating 80 -> 64"):
        H, inl = fit_homography_np(p0, p1, 3.0, cap=64, device="cpu",
                                   sample_idx=jax_sample_idx(80, 0, cap=64))
    assert inl.shape == (64,)
    with pytest.warns(UserWarning):
        H_ref, inl_ref = j_fit(p0, p1, 3.0, cap=64)
    np.testing.assert_array_equal(inl, inl_ref)


def test_fit_runs_on_the_given_device(monkeypatch):
    """The fit's tensors and its generator live on the device it is given
    (on the card the same call runs there; tests/test_torch_port_cuda.py
    holds it to the CPU)."""
    from geoformer_tpu_torch.eval import hpatches

    seen = {}
    real = hpatches.ransac_homography

    def spy(a, b, v, **kw):
        seen["devices"] = {a.device.type, b.device.type, v.device.type}
        seen["generator"] = kw["generator"].device.type
        return real(a, b, v, **kw)

    monkeypatch.setattr(hpatches, "ransac_homography", spy)
    p0, p1 = correspondences(50, 5, 8)
    fit_homography_np(p0, p1, 3.0, device=torch.device("cpu"))
    assert seen == {"devices": {"cpu"}, "generator": "cpu"}
