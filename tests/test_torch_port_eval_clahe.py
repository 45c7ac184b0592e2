"""The port's CLAHE and retinal enhancement against cv2 and the JAX package.

``eval/clahe.clahe`` is held to ``cv2.createCLAHE(2.0, (8, 8)).apply`` and
``eval/matcher.enhance_retinal`` to the JAX ``enhance_retinal`` (cv2
inside), exactly, on smooth and noisy fixtures of odd sizes (sides that the
8x8 grid divides, one that it does not, neither), a fundus-like image, and
flat, saturated and two-level images. Measured: equal on every pixel (no
pixel moves through float rounding in OpenCV's interpolation).
"""

import warnings

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

from geoformer_tpu.eval import matcher as j_matcher  # noqa: E402
from geoformer_tpu_torch.eval import matcher  # noqa: E402
from geoformer_tpu_torch.eval.clahe import clahe  # noqa: E402

SIZES = [(8, 8), (9, 9), (16, 12), (61, 77), (64, 64), (257, 199),
         (100, 803), (480, 640)]


def _smooth(hw, seed, sigma=3.0):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, hw, dtype=np.uint8),
                           (0, 0), sigma)
    return cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)


def _fundus(size=300, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    img = (r < 0.46 * size) * (0.5 + 0.1 * rng.standard_normal((size, size))
                               + 0.2 * np.sin(xx / 9.0))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_clahe_equals_cv2(hw, kind):
    img = (_smooth(hw, sum(hw)) if kind == "smooth" else
           np.random.default_rng(1).integers(0, 256, hw, dtype=np.uint8))
    ref = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(img)
    np.testing.assert_array_equal(clahe(img, 2.0, (8, 8)), ref)


@pytest.mark.parametrize("clip,grid", [(4.0, (8, 8)), (1.0, (4, 6)),
                                       (0.0, (8, 8))])
def test_clahe_other_limits_and_grids(clip, grid):
    img = _smooth((90, 131), 5)
    ref = cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(img)
    np.testing.assert_array_equal(clahe(img, clip, grid), ref)


@pytest.mark.parametrize("hw", [(61, 77), (480, 640), (257, 199)])
def test_enhance_retinal_equals_the_jax_one(hw):
    img = _smooth(hw, 7, sigma=2.0)
    np.testing.assert_array_equal(matcher.enhance_retinal(img),
                                  j_matcher.enhance_retinal(img))


def test_enhance_retinal_on_a_fundus_image():
    img = _fundus()
    got = matcher.enhance_retinal(img)
    np.testing.assert_array_equal(got, j_matcher.enhance_retinal(img))
    assert got.std() > img.std() * 0.5


@pytest.mark.parametrize("name", ["flat", "saturated", "black",
                                  "two-level"])
def test_enhance_retinal_on_degenerate_images(name):
    rng = np.random.default_rng(3)
    img = {"flat": np.full((50, 70), 7, np.uint8),
           "saturated": np.full((50, 70), 255, np.uint8),
           "black": np.zeros((33, 41), np.uint8),
           "two-level": np.where(rng.random((40, 40)) < 0.5, 0,
                                 255).astype(np.uint8)}[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # 0 / 0 as JAX
        got = matcher.enhance_retinal(img)
        ref = j_matcher.enhance_retinal(img)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(clahe(img),
                                  cv2.createCLAHE(2.0, (8, 8)).apply(img))


def test_load_gray_enhanced_equals_the_jax_one(tmp_path):
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, _fundus(320, 2))
    for imsize in (None, 256):
        got, sc = matcher.load_gray(path, imsize, enhanced=True)
        ref, rsc = j_matcher.load_gray(path, imsize, enhanced=True)
        assert sc == rsc and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1 / 255 + 1e-7


def test_clahe_rejects_what_is_no_grey_uint8_image():
    with pytest.raises(ValueError):
        clahe(np.zeros((8, 8), np.float32))
