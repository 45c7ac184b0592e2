"""The port's image files, resize, metrics and host warp against the JAX
package and cv2.

cv2 is the oracle for reading files (the JAX package calls
cv2.imread(IMREAD_GRAYSCALE) and cv2.resize); the port may not import it.
Fixtures are written into tmp_path at test time: PNGs by a small encoder
below (every row filter, every colour type) and by cv2, PGM/PPM and JPEG
by cv2 (the JPEG decoder's own tests are tests/test_torch_port_jpeg.py).

Tolerances: decoding is exact for grey and colour files alike (the port
uses libpng's and cv2's own fixed-point grey weights; measured exact on
every fixture). resize_linear_u8 is held to cv2.resize within 1 grey level
(an f32 bilinear resize would miss cv2's fixed-point rounding by about
that); it reproduces cv2's arithmetic, and every size here measured exact. load_gray within 1/255 of the JAX load_gray, the
scale factors exactly. Metrics, resize_shape and the host warp exactly.
"""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from geoformer_tpu.data import native as j_native  # noqa: E402
from geoformer_tpu.data.synthetic import load_image_dir as j_load_image_dir  # noqa: E402
from geoformer_tpu.eval import matcher as j_matcher  # noqa: E402
from geoformer_tpu.eval import metrics as j_metrics  # noqa: E402
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.data.synthetic import (  # noqa: E402
    base_image_stream,
    load_image_dir,
)
from geoformer_tpu_torch.eval import matcher, metrics  # noqa: E402
from geoformer_tpu_torch.eval.image_io import (  # noqa: E402
    UnreadableImage,
    read_gray,
    read_size,
)
from geoformer_tpu_torch.geometry.homography import (  # noqa: E402
    sample_homography,
    sample_homography_draws,
)
from geoformer_tpu_torch.ops.image_warp import warp_image  # noqa: E402
from geoformer_tpu_torch.ops.resize import resize_linear_u8  # noqa: E402

HOLDOUT = sorted((Path(__file__).resolve().parent.parent / "data"
                  / "holdout_photos").glob("*.png"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(px: np.ndarray, colour: int, filters) -> bytes:
    """An 8-bit PNG of px [h, w, channels] with the given row filters."""
    h, w = px.shape[:2]
    px = px.reshape(h, w, -1).astype(np.int32)
    zero = np.zeros((1, px.shape[2]), np.int32)
    rows = []
    for r in range(h):
        cur = px[r]
        up = px[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([zero, cur[:-1]])
        upleft = np.concatenate([zero, up[:-1]])
        pred = [0 * cur, left, up, (left + up) >> 1,
                _paeth(left, up, upleft)][filters[r]]
        rows.append(bytes([filters[r]])
                    + ((cur - pred) & 255).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


# ---------------------------------------------------------------- metrics --

@pytest.mark.parametrize("errors", [
    [0.5, 2.0, np.nan, 7.5, 0.0, 12.0, 3.0], [], [np.nan, np.nan],
    list(np.random.default_rng(0).exponential(3.0, 50))])
def test_metrics_equal_the_jax_ones(errors):
    th = (1, 3, 5, 10)
    np.testing.assert_array_equal(metrics.cal_error_auc(errors, th),
                                  j_metrics.cal_error_auc(errors, th))
    np.testing.assert_array_equal(metrics.correctness(errors, th),
                                  j_metrics.correctness(errors, th))
    rng = np.random.default_rng(1)
    p1, p2 = rng.random((9, 2)) * 100, rng.random((9, 2)) * 100
    H = np.array([[1.1, 0.02, 3.0], [-0.01, 0.95, -2.0], [1e-4, 2e-4, 1.0]])
    np.testing.assert_array_equal(metrics.reproj_dists(p1, p2, H),
                                  j_metrics.reproj_dists(p1, p2, H))


# --------------------------------------------------------------- decoding --

def test_holdout_photos_decode_exactly():
    assert len(HOLDOUT) == 2
    for p in HOLDOUT:
        ref = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        got = read_gray(str(p))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        assert read_size(str(p)) == ref.shape


@pytest.mark.parametrize("colour,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_every_filter_and_colour_type(tmp_path, colour, channels):
    rng = np.random.default_rng(colour)
    h, w = 41, 57
    smooth = np.cumsum(rng.integers(-3, 4, (h, w, channels)), 1) + 128
    px = np.clip(smooth, 0, 255).astype(np.uint8)
    px[:5] = rng.integers(0, 256, (5, w, channels))   # noisy rows too
    px[7:9] = 77                                      # grey-equal RGB rows
    filters = np.arange(h) % 5                        # every filter, in turn
    path = tmp_path / f"c{colour}.png"
    path.write_bytes(encode_png(px, colour, filters))
    ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(read_gray(str(path)), ref)
    assert read_size(str(path)) == (h, w)


@pytest.mark.parametrize("ext", ["png", "ppm", "pgm"])
def test_files_written_by_cv2(tmp_path, ext):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (47, 63, 3), dtype=np.uint8)
    src = img[..., 1] if ext == "pgm" else img
    path = str(tmp_path / f"a.{ext}")
    assert cv2.imwrite(path, src)
    np.testing.assert_array_equal(read_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert read_size(path) == (47, 63)


def test_pnm_header_with_a_comment(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (5, 6, 3), np.uint8)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n6 5\n255\n" + img.tobytes())
    np.testing.assert_array_equal(read_gray(str(path)),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_unsupported_and_damaged_files_raise(tmp_path):
    """A format cv2 reads and the port does not raises ValueError naming
    it; a file cv2 cannot read either (cv2.imread gives None) raises
    UnreadableImage, a ValueError."""
    img = np.random.default_rng(5).integers(0, 256, (16, 16), np.uint8)
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive JPEG") as e:
        read_gray(jpg)
    assert not isinstance(e.value, UnreadableImage)
    with pytest.raises(ValueError, match="progressive JPEG"):
        read_size(jpg)
    data = encode_png(img[..., None], 0, [1] * 16)
    cut = tmp_path / "cut.png"
    cut.write_bytes(data[:len(data) // 2])
    assert cv2.imread(str(cut), cv2.IMREAD_GRAYSCALE) is None
    with pytest.raises(UnreadableImage, match="truncated"):
        read_gray(str(cut))
    bad = bytearray(data)
    bad[40] ^= 0xFF
    (tmp_path / "crc.png").write_bytes(bytes(bad))
    assert cv2.imread(str(tmp_path / "crc.png"), cv2.IMREAD_GRAYSCALE) is None
    with pytest.raises(UnreadableImage, match="CRC"):
        read_gray(str(tmp_path / "crc.png"))
    (tmp_path / "text.png").write_bytes(b"not an image at all")
    with pytest.raises(UnreadableImage):
        read_gray(str(tmp_path / "text.png"))
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), img.astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="16-bit"):
        read_gray(str(deep))
    (tmp_path / "ascii.pgm").write_bytes(b"P2\n1 1\n255\n7\n")
    with pytest.raises(ValueError, match="ASCII"):
        read_gray(str(tmp_path / "ascii.pgm"))
    with pytest.raises(FileNotFoundError):
        read_gray(str(tmp_path / "missing.png"))


# ----------------------------------------------------------------- resize --

@pytest.mark.parametrize("src,dst", [
    ((427, 640), (480, 640)), ((240, 320), (480, 640)),
    ((480, 640), (240, 320)), ((600, 800), (480, 632)),
    ((61, 77), (37, 101)), ((33, 47), (100, 100)), ((5, 7), (3, 2)),
    ((97, 131), (97, 131))])
def test_resize_linear_u8_matches_cv2(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    noise = rng.integers(0, 256, src, dtype=np.uint8)
    smooth = cv2.GaussianBlur(noise, (0, 0), 2)
    for img in (noise, smooth):
        got = resize_linear_u8(img, dst).astype(int)
        ref = cv2.resize(img, dst[::-1]).astype(int)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1


def test_resize_shape_equals_the_jax_one():
    for wo, ho in ((640, 480), (800, 600), (1000, 750), (333, 517),
                   (479, 481), (64, 40)):
        for imsize in (None, 0, -1, 240, 480, 1000):
            assert matcher.resize_shape(wo, ho, imsize) == \
                j_matcher.resize_shape(wo, ho, imsize)
            assert matcher.resize_shape(wo, ho, imsize, 16, False) == \
                j_matcher.resize_shape(wo, ho, imsize, 16, False)


def test_load_gray_matches_the_jax_one(tmp_path):
    rng = np.random.default_rng(6)
    cases = [("a.png", (427, 640)), ("b.ppm", (600, 800)),
             ("c.png", (300, 200)), ("d.jpg", (450, 600))]
    for name, hw in cases:
        img = cv2.GaussianBlur(rng.integers(0, 256, hw + (3,), np.uint8),
                               (0, 0), 1.5)
        path = str(tmp_path / name)
        cv2.imwrite(path, img)
        for imsize in (480, 240, None):
            got, sc = matcher.load_gray(path, imsize)
            ref, rsc = j_matcher.load_gray(path, imsize)
            assert got.dtype == np.float32 and got.shape == ref.shape
            assert sc == rsc
            assert np.abs(got - ref).max() <= 1 / 255 + 1e-7
    got, sc = matcher.load_gray(str(tmp_path / "a.png"), 480, enhanced=True)
    ref, rsc = j_matcher.load_gray(str(tmp_path / "a.png"), 480,
                                   enhanced=True)
    assert sc == rsc and np.abs(got - ref).max() <= 1 / 255 + 1e-7
    with pytest.raises(FileNotFoundError):
        matcher.load_gray(str(tmp_path / "missing.png"), 480)


# -------------------------------------------------------- host warp, data --

def test_native_warp_equals_the_jax_one(monkeypatch):
    """The JAX wrapper runs on the port's build of the same source (the JAX
    binding would build into cpp/); the port's wrapper must give the same
    bits. Against the port's warp_image (f32 positions, where native_warp
    maps in f64) the measured gap is a few 1e-6 (bound 1e-4)."""
    monkeypatch.setattr(j_native, "_LIB", native.load_library())
    hw = (48, 64)
    base = native.native_textures(3, *hw, seed=11)
    Hs = sample_homography(sample_homography_draws(
        3, hw, torch.Generator().manual_seed(11)), hw).numpy()
    got = native.native_warp(base, Hs)
    np.testing.assert_array_equal(got, j_native.native_warp(base, Hs))
    ref = warp_image(torch.from_numpy(base[..., None]),
                     torch.from_numpy(Hs))[..., 0].numpy()
    assert np.abs(got - ref).max() <= 1e-4
    with pytest.raises(ValueError):
        native.native_warp(base, Hs[:2])


def test_load_image_dir_matches_the_jax_one(tmp_path):
    """JPEG, PNG and PPM files are read; a damaged file that cv2 cannot
    read is skipped by both packages; a progressive JPEG (read by cv2, not
    by the port) raises."""
    rng = np.random.default_rng(8)
    (tmp_path / "sub").mkdir()
    for name, hw in (("a.png", (50, 70)), ("sub/b.ppm", (90, 60)),
                     ("c.png", (64, 80)), ("sub/e.jpg", (70, 90)),
                     ("f.jpg", (40, 100))):
        img = cv2.GaussianBlur(rng.integers(0, 256, hw + (3,), np.uint8),
                               (0, 0), 1.0)
        cv2.imwrite(str(tmp_path / name), img)
    data = (tmp_path / "c.png").read_bytes()
    (tmp_path / "d.png").write_bytes(data[:len(data) // 2])   # damaged
    got = load_image_dir(str(tmp_path), (64, 80))
    ref = j_load_image_dir(str(tmp_path), (64, 80))
    assert got.shape == ref.shape == (5, 64, 80)
    np.testing.assert_array_equal(got, ref)
    assert load_image_dir(str(tmp_path / "empty"), (64, 80)) is None
    cv2.imwrite(str(tmp_path / "g.jpg"), np.zeros((8, 8), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        load_image_dir(str(tmp_path), (64, 80))


def test_base_image_stream_mixes_images_and_bank(tmp_path):
    """The JAX stream's draws with numpy's default_rng(seed): the image
    bank alone at fraction 1, the per-sample mix below it."""
    rng = np.random.default_rng(9)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i}.png"),
                    rng.integers(0, 256, (48, 64), np.uint8))
    imgs = load_image_dir(str(tmp_path), (48, 64))
    stream = base_image_stream((48, 64), 4, seed=2, image_dir=str(tmp_path))
    r = np.random.default_rng(2)
    for _ in range(2):
        np.testing.assert_array_equal(next(stream),
                                      imgs[r.integers(0, 3, size=4)])
    bank = native.native_textures_mixed(8, 48, 64, 2)
    stream = base_image_stream((48, 64), 4, seed=2, image_dir=str(tmp_path),
                               image_fraction=0.5, bank_size=8)
    r = np.random.default_rng(2)
    for _ in range(3):
        use = r.random(4) < 0.5
        want = bank[r.integers(0, 8, size=4)].copy()
        if use.any():
            want[use] = imgs[r.integers(0, 3, size=int(use.sum()))]
        np.testing.assert_array_equal(next(stream), want)
