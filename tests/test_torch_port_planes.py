"""The port's posed-RGBD data path against the JAX package's: the plane
renderer (data/planes.py), the corpus builder (data/depth_corpus.py) and
the MegaDepth-layout reader and stream (data/megadepth.py).

- room_scene draws the same planes from the same rng.
- render_planes at 96x128 against the JAX one (cv2.warpPerspective): the
  image within 1/255 on >= 99.5 % of the pixels, the depth equal (1e-6
  relative) where both render a plane, and the pixels where one renders
  and the other does not at most 0.5 %. (cv2 5 warps float images
  without cv2 4's 1/32-pixel rounding of positions; the port follows
  cv2 5 to ~5e-5.)
- A scene built by the JAX script (cv2's JPEG, h5py's HDF5), read by the
  port's MegaDepthScene: every field of every pair equal to the JAX
  reader's, at a size that resizes (160x120 views read at 128).
- scene_balanced_stream: the same pairs in the same order, 3 batches.
- The port's build_scene against the JAX script's with the same seed: the
  index npz equal field for field, and the depth maps (read back by the
  port) as the renderer test's bars; the images differ by JPEG encoders.

Both builders take their textures from the port's build of
cpp/synthgen.cpp (the JAX script's own loader would run `make` in cpp/),
the same source and draws as the JAX corpus.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")
pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import render_depth_corpus as jrender  # noqa: E402

from geoformer_tpu.data import megadepth as JM  # noqa: E402
from geoformer_tpu.data import native as jnative  # noqa: E402
from geoformer_tpu.data import planes as JP  # noqa: E402
from geoformer_tpu.data.synthetic import mixed_texture_bank  # noqa: E402
from geoformer_tpu_torch.data import depth_corpus as PC  # noqa: E402
from geoformer_tpu_torch.data import megadepth as PM  # noqa: E402
from geoformer_tpu_torch.data import native as pnative  # noqa: E402
from geoformer_tpu_torch.data import planes as PP  # noqa: E402
from geoformer_tpu_torch.data.hdf5 import read_dataset  # noqa: E402

HW = (120, 160)
N_CAMS = 4


def _same_planes(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(x, y) for x, y in zip(pa, pb))
        for pa, pb in zip(a, b))


@pytest.mark.parametrize("cluttered", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_room_scene_draws_the_same_planes(seed, cluttered):
    tex = np.random.default_rng(9).random((6, 8, 12)).astype(np.float32)
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    assert _same_planes(JP.room_scene(rj, tex, cluttered=cluttered),
                        PP.room_scene(rp, tex, cluttered=cluttered))
    assert rj.random() == rp.random()                 # same draws consumed


def _render_bars(img_j, img_p, dep_j, dep_p):
    assert (np.abs(img_j - img_p) <= 1 / 255).mean() >= 0.995
    both = (dep_j > 0) & (dep_p > 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(dep_p[both], dep_j[both], rtol=1e-6)
    assert ((dep_j > 0) != (dep_p > 0)).mean() <= 0.005


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_planes_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    tex = mixed_texture_bank(rng, (128, 192), 6)
    planes = JP.room_scene(rng, tex, cluttered=True)
    K = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]])
    T = JP.look_at([rng.uniform(-1, 1), 0.1, 0.2],
                   [rng.uniform(-.5, .5), 0, 8])
    img_j, dep_j = JP.render_planes(K, T, planes, (96, 128),
                                    return_depth=True)
    img_p, dep_p = PP.render_planes(K, T, planes, (96, 128),
                                    return_depth=True)
    _render_bars(img_j, img_p, dep_j, dep_p)
    assert img_p.dtype == np.float32 and dep_p.dtype == np.float32


@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    """Two scenes built by the JAX script, its textures from the port's
    generator build."""
    root = tmp_path_factory.mktemp("jax_corpus")
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "native_textures_mixed",
               pnative.native_textures_mixed)
    for k, seed in enumerate((3, 5)):
        jrender.build_scene(str(root), str(root / "index"), f"s{k}", seed,
                            n_cams=N_CAMS, hw=HW, cluttered=True)
    mp.undo()
    return root


def test_the_reader_matches_the_jax_reader(jax_corpus):
    kw = dict(img_resize=128, depth_pad=160)
    for name in ("s0", "s1"):
        npz = str(jax_corpus / "index" / f"{name}.npz")
        js = JM.MegaDepthScene(npz, str(jax_corpus), **kw)
        ps = PM.MegaDepthScene(npz, str(jax_corpus), **kw)
        assert len(ps) == len(js) == 6
        for i in range(len(js)):
            ref, got = js.get(i), ps.get(i)
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the pair was resized: content 128x96 with its padding mask
    assert got["mask0"].shape == (16, 16) and got["mask0"][12:].sum() == 0
    np.testing.assert_allclose(got["scale0"], [1.25, 1.25])


def test_the_stream_draws_the_same_pairs(jax_corpus):
    kw = dict(img_resize=128, depth_pad=160)
    args = (str(jax_corpus / "index"), str(jax_corpus), 2, 67)
    js = JM.scene_balanced_stream(*args, **kw)
    ps = PM.scene_balanced_stream(*args, **kw)
    for _ in range(3):
        ref, got = next(js), next(ps)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_build_scene_matches_the_jax_script(jax_corpus, tmp_path):
    n_pairs = PC.build_scene(str(tmp_path), str(tmp_path / "index"), "s1",
                             5, n_cams=N_CAMS, hw=HW, cluttered=True)
    assert n_pairs == 6 and "native" in PC.TEXTURES_USED
    ref = np.load(jax_corpus / "index" / "s1.npz", allow_pickle=True)
    got = np.load(tmp_path / "index" / "s1.npz", allow_pickle=True)
    assert set(got.files) == set(ref.files)
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for dpath, ipath in zip(ref["depth_paths"], ref["image_paths"]):
        dj = read_dataset(str(jax_corpus / dpath))
        dp = read_dataset(str(tmp_path / dpath))
        ij = cv2.imread(str(jax_corpus / ipath), cv2.IMREAD_GRAYSCALE)
        ip = cv2.imread(str(tmp_path / ipath), cv2.IMREAD_GRAYSCALE)
        assert dp.dtype == np.float32 and ip.shape == HW
        both = (dj > 0) & (dp > 0)
        np.testing.assert_allclose(dp[both], dj[both], rtol=1e-6)
        assert ((dj > 0) != (dp > 0)).mean() <= 0.005
        # two JPEG encoders at q95 on the same render
        assert np.abs(ij.astype(int) - ip.astype(int)).mean() < 2.0


def test_build_runs_scenes_in_parallel_processes(tmp_path):
    train, val = PC.build(str(tmp_path), n_scenes=1, n_val_scenes=1,
                          n_cams=2, cluttered=True)
    assert (train, val) == (1, 1)
    assert sorted(p.name for p in (tmp_path / "index").iterdir()) == \
        ["scene0000.npz"]
    assert sorted(p.name for p in (tmp_path / "index_val").iterdir()) == \
        ["val0000.npz"]
    assert "native" in PC.TEXTURES_USED
