"""The port's ScanNet reader and 16-bit PNG decode against the JAX package
and cv2.

The test writes a ScanNet-shaped tree with cv2 (the layout the JAX reader
reads: ``<root>/train/sceneXXXX_YY/{color/<f>.jpg, depth/<f>.png,
pose/<f>.txt}``, an npz index of (scene, sub, frame0, frame1) names with
overlap scores, and an npz of per-scene intrinsics that leaves one scene
out): colour JPEGs at two sizes (one upscaled and one downscaled to
640x480), 16-bit depth PNGs in millimetres at three compression levels
(so several of the PNG row filters), and cam-to-world poses. Everything
must be equal bit for bit: the port's decode of each 16-bit PNG to
``cv2.imread(path, cv2.IMREAD_UNCHANGED)``, and every array of
``ScanNetDataset.get`` and ``batch_stream`` to the JAX reader's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from geoformer_tpu.data import scannet as jsn  # noqa: E402
from geoformer_tpu_torch.data import scannet as tsn  # noqa: E402
from geoformer_tpu_torch.eval import image_io  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

# (scene, sub) -> colour image size (w, h)
SCENES = {(0, 0): (224, 168), (7, 2): (704, 528)}
FRAMES = (0, 20, 40)


def _pose(rng):
    a = rng.normal(size=3)
    th = np.linalg.norm(a)
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3)
    return T


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    rng = np.random.default_rng(0)
    intr = {}
    names = []
    for (scene, sub), (w, h) in SCENES.items():
        sname = f"scene{scene:04d}_{sub:02d}"
        sdir = root / "train" / sname
        for d in ("color", "depth", "pose"):
            (sdir / d).mkdir(parents=True)
        for i, f in enumerate(FRAMES):
            lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
            bgr = (cv2.resize(lo, (w, h), interpolation=cv2.INTER_CUBIC)
                   .clip(0, 1) * 255).astype(np.uint8)
            cv2.imwrite(str(sdir / "color" / f"{f}.jpg"), bgr)
            depth = (500 + np.cumsum(rng.integers(0, 40, (480, 640)), 1)
                     ).astype(np.uint16)
            depth[rng.random((480, 640)) < 0.05] = 0     # holes
            cv2.imwrite(str(sdir / "depth" / f"{f}.png"), depth,
                        [cv2.IMWRITE_PNG_COMPRESSION, (0, 3, 9)[i]])
            np.savetxt(str(sdir / "pose" / f"{f}.txt"), _pose(rng))
        if scene == 0:        # scene 7 has no intrinsics: the identity
            intr[sname] = np.array([[577.6, 0, 319.5], [0, 578.7, 239.5],
                                    [0, 0, 1]])
        for a in FRAMES:
            for b in FRAMES:
                if a < b:
                    names.append((scene, sub, a, b))
    scores = np.linspace(0.2, 0.9, len(names))       # the first two drop
    np.savez(root / "index.npz", name=np.array(names), score=scores)
    np.savez(root / "intrinsics.npz", **intr)
    return root


def _datasets(root):
    args = (str(root), str(root / "index.npz"), str(root / "intrinsics.npz"))
    return jsn.ScanNetDataset(*args), tsn.ScanNetDataset(*args)


def _assert_equal(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_depth_png_decode_equals_cv2_unchanged(tree):
    paths = sorted((tree / "train").rglob("depth/*.png"))
    assert len(paths) == len(SCENES) * len(FRAMES)
    for p in paths:
        ref = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        got = image_io.read_unchanged(str(p))
        assert ref.dtype == np.uint16 and got.dtype == np.uint16
        np.testing.assert_array_equal(got, ref, err_msg=str(p))


def test_unchanged_png_of_every_filter_and_8_bits(tmp_path):
    rng = np.random.default_rng(1)
    for i, img in enumerate((
            rng.integers(0, 65536, (33, 47)).astype(np.uint16),
            np.cumsum(rng.integers(0, 9, (40, 31)), 0).astype(np.uint16),
            rng.integers(0, 256, (21, 26)).astype(np.uint8))):
        for level in (0, 1, 6, 9):
            p = str(tmp_path / f"{i}_{level}.png")
            cv2.imwrite(p, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            got = image_io.read_unchanged(p)
            assert got.dtype == ref.dtype == img.dtype
            np.testing.assert_array_equal(got, ref)


def test_formats_still_refused(tree, tmp_path):
    depth = str(next((tree / "train").rglob("depth/*.png")))
    with pytest.raises(ValueError, match="16-bit"):
        image_io.read_gray(depth)
    rgb = str(tmp_path / "rgb.png")
    cv2.imwrite(rgb, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(ValueError, match="colour type 2"):
        image_io.read_unchanged(rgb)
    jpg = str(next((tree / "train").rglob("color/*.jpg")))
    with pytest.raises(ValueError, match="grey PNGs only"):
        image_io.read_unchanged(jpg)


def test_dataset_get_equals_jax(tree):
    jds, tds = _datasets(tree)
    assert len(tds) == len(jds) == 2 * 3 - 2
    np.testing.assert_array_equal(tds.names, jds.names)
    for i in range(len(jds)):
        got = tds.get(i)
        _assert_equal(got, jds.get(i))
        assert got["image0"].shape == (480, 640, 1)
    # the scene without intrinsics reads the identity
    assert any(np.array_equal(tds.get(i)["K0"], np.eye(3))
               for i in range(len(tds)))


def test_batch_stream_equals_jax(tree):
    jds, tds = _datasets(tree)
    js, ts = jsn.batch_stream(jds, 3, seed=5), tsn.batch_stream(tds, 3, seed=5)
    for _ in range(2):
        _assert_equal(next(ts), next(js))


def test_missing_frame_raises(tree):
    _, tds = _datasets(tree)
    tds.names = np.array([(0, 0, 0, 99)])
    with pytest.raises(FileNotFoundError):
        tds.get(0)
