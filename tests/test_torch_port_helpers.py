"""The port's public helpers against the JAX package's, on the CPU.

Each helper of the JAX package that no path of the port had called gets
its counterpart in the port module that mirrors its file, and is held to
the JAX function on the same seeded inputs:

- geometry/homography.py: the ellipse kernel equals
  cv2.getStructuringElement(MORPH_ELLIPSE, (2r, 2r)) for r = 1..6 (what
  the JAX _disk_kernel returns where cv2 is installed); erode_mask equals
  JAX's; compute_valid_mask equals JAX's away from pixels whose source
  lies within 1e-4 px of the image's edge (the two invert H in f32 by
  different LAPACKs); pixel_shuffle and its inverse (NHWC) and the ids of
  mutual_matches_under_homography are exact; scale_homography within
  1e-6; the package exports JAX's geometry/__init__ names;
- train/supervision.py: the dense spvs_coarse_homography exact (with and
  without padding masks), spvs_fine_expec_homography within 1e-6;
- ops/matching.py: mutual_nearest_mask exact, ties included;
- core/capacity.py: scatter_onehot_2d exact, out-of-range and negative
  flat indices included;
- eval/matcher.py: ratio_preserving_resize equal to JAX's (cv2.resize) on
  uint8 images and within 1e-5 on float32 ones, grey and 3-channel,
  cropping and padding;
- an AST walk finds every public function and class of the JAX package
  defined in the port, but those ROADMAP.md's "Not to port" lists.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

import geoformer_tpu.geometry as jgeom  # noqa: E402
import geoformer_tpu_torch.geometry as pgeom  # noqa: E402
from geoformer_tpu.core import capacity as jcap  # noqa: E402
from geoformer_tpu.eval import matcher as jmatcher  # noqa: E402
from geoformer_tpu.geometry import homography as jh  # noqa: E402
from geoformer_tpu.models.coarse_matching import (  # noqa: E402
    CoarseMatches as JMatches,
)
from geoformer_tpu.ops import matching as jmatch  # noqa: E402
from geoformer_tpu.train import supervision as jsup  # noqa: E402
from geoformer_tpu_torch.core import capacity as pcap  # noqa: E402
from geoformer_tpu_torch.eval import matcher as pmatcher  # noqa: E402
from geoformer_tpu_torch.geometry import homography as ph  # noqa: E402
from geoformer_tpu_torch.models.coarse_matching import (  # noqa: E402
    CoarseMatches as PMatches,
)
from geoformer_tpu_torch.ops import matching as pmatch  # noqa: E402
from geoformer_tpu_torch.train import supervision as psup  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

H_PAIR = np.array([[0.97, 0.04, 5.0], [-0.03, 1.02, -3.0], [2e-5, -1e-5, 1.0]])


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_geometry_exports_the_jax_names():
    for name in ("warp_points", "compute_valid_mask", "sample_homography",
                 "scale_homography", "corner_error", "dlt_homography",
                 "ransac_homography"):
        assert hasattr(jgeom, name)
        assert callable(getattr(pgeom, name)), name


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6])
def test_disk_kernel_is_cv2s_ellipse(radius):
    want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                     (2 * radius, 2 * radius))
    got = ph._disk_kernel(radius)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got, jh._disk_kernel(radius))


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_erode_mask(radius):
    rng = np.random.default_rng(radius)
    mask = (rng.random((2, 24, 31)) < 0.85).astype(np.float32)
    mask[:, 5:15, 8:20] = 1.0
    want = np.asarray(jh.erode_mask(jnp.asarray(mask), radius))
    got = ph.erode_mask(_t(mask), radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inverse, radius", [(False, 0), (True, 0),
                                             (False, 2), (True, 4)])
def test_compute_valid_mask(inverse, radius):
    hw = (40, 56)
    H = np.array([[0.9, 0.1, 6.3], [-0.08, 0.95, 4.1], [4e-4, -3e-4, 1.0]],
                 np.float32)
    want = np.asarray(jh.compute_valid_mask(hw, jnp.asarray(H), inverse,
                                            radius))
    got = ph.compute_valid_mask(hw, _t(H), inverse, radius).numpy()
    assert got.dtype == np.float32 and got.shape == hw
    # pixels whose source lies within 1e-4 px of an edge, and (eroded) the
    # pixels whose disk reaches one
    Minv = H.astype(np.float64) if inverse else np.linalg.inv(
        H.astype(np.float64))
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    p = np.stack([xx, yy, np.ones_like(xx)], -1) @ Minv.T
    sx, sy = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    edge = ((np.abs(sx + 0.5) < 1e-4) | (np.abs(sx - (hw[1] - 0.5)) < 1e-4)
            | (np.abs(sy + 0.5) < 1e-4) | (np.abs(sy - (hw[0] - 0.5)) < 1e-4))
    if radius:
        edge = cv2.dilate(edge.astype(np.uint8), np.ones(
            (2 * radius + 1, 2 * radius + 1), np.uint8)) > 0
    assert (~edge).sum() > 0.9 * edge.size
    np.testing.assert_array_equal(got[~edge], want[~edge])
    assert 0.2 < want.mean() < 1.0


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_and_inverse(r):
    rng = np.random.default_rng(r)
    x = rng.normal(size=(2, 3, 5, 3 * r * r)).astype(np.float32)
    got = ph.pixel_shuffle(_t(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.pixel_shuffle(
        jnp.asarray(x), r)))
    assert got.shape == (2, 3 * r, 5 * r, 3)
    back = ph.pixel_shuffle_inv(_t(got), r).numpy()
    np.testing.assert_array_equal(back, np.asarray(jh.pixel_shuffle_inv(
        jnp.asarray(got), r)))
    np.testing.assert_array_equal(back, x)
    with pytest.raises(ValueError):
        ph.pixel_shuffle(_t(x[..., :-1]), r)
    with pytest.raises(ValueError):
        ph.pixel_shuffle_inv(_t(got[:, :-1]), r)


@pytest.mark.parametrize("masked", [False, True])
def test_mutual_matches_under_homography(masked):
    rng = np.random.default_rng(3)
    k1 = rng.uniform(0, 200, (60, 2)).astype(np.float32)
    k2 = np.asarray(jh.warp_points(jnp.asarray(k1), jnp.asarray(
        H_PAIR, jnp.float32)))
    k2 = (k2 + rng.normal(0, 1.5, k2.shape))[rng.permutation(60)[:50]]
    k2 = np.concatenate([k2, rng.uniform(0, 200, (20, 2))]).astype(
        np.float32)
    v1 = v2 = None
    if masked:
        v1 = rng.random(60) < 0.8
        v2 = rng.random(70) < 0.8
    H = H_PAIR.astype(np.float32)
    jm, jok = jh.mutual_matches_under_homography(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(H), 3.0,
        None if v1 is None else jnp.asarray(v1),
        None if v2 is None else jnp.asarray(v2))
    pm, pok = ph.mutual_matches_under_homography(
        _t(k1), _t(k2), _t(H), 3.0, None if v1 is None else _t(v1),
        None if v2 is None else _t(v2))
    assert pm.dtype == torch.int32
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    assert 10 < int(pok.sum()) < 60


def test_scale_homography():
    H = H_PAIR.astype(np.float32)
    for sx, sy in ((0.5, 0.5), (1.25, 0.8), (2.0, 3.0)):
        want = np.asarray(jh.scale_homography(jnp.asarray(H), sx, sy))
        got = ph.scale_homography(_t(H), sx, sy).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _homography_pair(b, hw):
    rng = np.random.default_rng(11)
    Hs = []
    for _ in range(b):
        src = np.array([[0, 0], [0, hw[0]], [hw[1], 0], [hw[1], hw[0]]],
                       np.float32)
        dst = src + rng.uniform(-8, 8, (4, 2)).astype(np.float32)
        Hs.append(cv2.getPerspectiveTransform(src, dst))
    H = np.stack(Hs).astype(np.float32)
    return H, np.linalg.inv(H).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_spvs_coarse_homography_dense(masked):
    hw, b = (64, 96), 2
    H01, H10 = _homography_pair(b, hw)
    m0 = m1 = None
    if masked:
        m0 = np.ones((b, 8, 12), np.float32)
        m0[:, :, 10:] = 0
        m1 = np.ones((b, 8, 12), np.float32)
        m1[:, 7:] = 0
    want = np.asarray(jsup.spvs_coarse_homography(
        jnp.asarray(H01), jnp.asarray(H10), hw, 8,
        None if m0 is None else jnp.asarray(m0),
        None if m1 is None else jnp.asarray(m1)))
    got = psup.spvs_coarse_homography(
        _t(H01), _t(H10), hw, 8, None if m0 is None else _t(m0),
        None if m1 is None else _t(m1)).numpy()
    assert got.shape == (b, 96, 96)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 40


def test_spvs_fine_expec_homography():
    rng = np.random.default_rng(5)
    b, m, gw0, gw1 = 2, 30, 12, 10
    i_ids = rng.integers(0, 8 * gw0, (b, m)).astype(np.int32)
    j_ids = rng.integers(0, 8 * gw1, (b, m)).astype(np.int32)
    H01, _ = _homography_pair(b, (64, 96))
    ones = np.ones((b, m), bool)
    jm = JMatches(jnp.zeros((b, 0, 0)), jnp.asarray(i_ids),
                  jnp.asarray(j_ids), jnp.asarray(ones),
                  jnp.zeros((b, m)))
    pm = PMatches(torch.zeros(b, 0, 0), _t(i_ids).long(), _t(j_ids).long(),
                  _t(ones), torch.zeros(b, m))
    want = np.asarray(jsup.spvs_fine_expec_homography(
        jm, jnp.asarray(H01), gw0, gw1))
    got = psup.spvs_fine_expec_homography(pm, _t(H01), gw0,
                                          gw1).numpy()
    assert got.shape == (b, m, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mutual_nearest_mask():
    rng = np.random.default_rng(2)
    conf = rng.random((2, 20, 24)).astype(np.float32)
    conf[0, 3, :] = conf[0, 3].max()        # a row of ties
    conf[1, :, 5] = 0.999                   # a column of ties
    for thr in (0.0, 0.5, 0.99):
        want = np.asarray(jmatch.mutual_nearest_mask(jnp.asarray(conf), thr))
        got = pmatch.mutual_nearest_mask(_t(conf), thr).numpy()
        np.testing.assert_array_equal(got, want)


def test_scatter_onehot_2d():
    rows = np.array([-1, 0, 5, 0, 1, 2, -9, 1], np.int32)
    cols = np.array([0, 4, 0, 1, 2, 3, 0, 2], np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1, 1, 1], bool)
    for shape in ((2, 3), (3, 4)):
        want = np.asarray(jcap.scatter_onehot_2d(
            shape, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(valid)))
        got = pcap.scatter_onehot_2d(shape, _t(rows), _t(cols),
                                     _t(valid)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_hw, target_hw, channels", [
    ((48, 64), (60, 60), 0), ((90, 70), (40, 50), 0),
    ((64, 48), (32, 24), 0), ((33, 47), (80, 64), 3),
])
def test_ratio_preserving_resize(src_hw, target_hw, channels):
    rng = np.random.default_rng(sum(src_hw))
    shape = src_hw + ((channels,) if channels else ())
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    want = jmatcher.ratio_preserving_resize(u8, target_hw)
    got = pmatcher.ratio_preserving_resize(u8, target_hw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    f32 = rng.random(shape).astype(np.float32)
    want = jmatcher.ratio_preserving_resize(f32, target_hw)
    got = pmatcher.ratio_preserving_resize(f32, target_hw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# public names of the JAX package that ROADMAP.md's "Not to port" lists,
# each with its reason
NOT_PORTED = {
    "core/cache.py": {"enable_compile_cache"},
    "core/platform.py": {"force_cpu", "respect_platform_env"},
    "utils/profiling.py": {"BlockProfiler", "xprof_trace"},
    "core/mesh.py": {"make_mesh", "batch_sharding", "replicated"},
    "core/spmd.py": {"replicate", "shard_dim"},
    "utils/plotting.py": {"make_matching_figure", "make_geo_window_figure"},
    "ops/pallas_attention.py": {"box_window_attention",
                                "box_attention_reference"},
    "train/checkpoint.py": {"load_variables", "load_params"},
}


def test_every_public_jax_function_has_a_counterpart():
    """An AST walk: each public top-level function or class of a
    geoformer_tpu module is defined in the port (in the mirroring module
    or elsewhere), or listed in NOT_PORTED."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent

    def defined(path):
        return {n.name for n in ast.parse(path.read_text()).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}

    port = set()
    for path in (root / "geoformer_tpu_torch").rglob("*.py"):
        port |= defined(path)
    missing = {}
    for path in sorted((root / "geoformer_tpu").rglob("*.py")):
        rel = path.relative_to(root / "geoformer_tpu").as_posix()
        names = {n for n in defined(path) if not n.startswith("_")}
        gone = names - port - NOT_PORTED.get(rel, set())
        if gone:
            missing[rel] = sorted(gone)
    assert not missing, missing
    roadmap = (root / "ROADMAP.md").read_text()
    listed = roadmap[roadmap.index("*Not to port.*"):]
    listed = listed[:listed.index("*The port benchmark*")]
    for rel, names in NOT_PORTED.items():
        assert rel.split("/")[-1] in listed or all(n in listed
                                                   for n in names), rel
