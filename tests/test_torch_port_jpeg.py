"""The port's JPEG decoder and encoder against cv2 (libjpeg-turbo).

Fixtures are written at test time by ``cv2.imencode`` (no binary file in the
repository). Each decode must equal ``cv2.imdecode(..., IMREAD_GRAYSCALE)``
(or ``cv2.imread`` of the same bytes in a file, where the two differ)
exactly: grey and colour inputs, qualities 30-100, sampling 4:4:4, 4:2:2
and 4:2:0, restart intervals, optimised Huffman tables, sizes from 1x1 to
769x1023, EXIF orientations, a file cut inside its scan. Unsupported
variants raise ValueError, damaged files UnreadableImage.

For the encoder: cv2 decodes the port's files to exactly what the port
decodes, and at q95 the port's file decodes within 1 grey level (mean
absolute difference) of cv2's own file of the same image.
"""

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from geoformer_tpu_torch.eval import image_io, jpeg  # noqa: E402
from geoformer_tpu_torch.eval.image_io import UnreadableImage  # noqa: E402


def _image(hw, colour: bool, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = tuple(hw) + ((3,) if colour else ())
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if min(hw) > 2:
        img = cv2.GaussianBlur(img, (0, 0), 1.5)
    return img


def _encode(img, params=()) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _assert_decodes_as_cv2(data: bytes) -> None:
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    got = jpeg.decode_gray(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


Q = cv2.IMWRITE_JPEG_QUALITY
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (37, 53), (769, 1023)])
@pytest.mark.parametrize("colour", [False, True])
def test_sizes(hw, colour):
    _assert_decodes_as_cv2(_encode(_image(hw, colour, sum(hw)), (Q, 95)))


@pytest.mark.parametrize("quality", [30, 75, 90, 95, 100])
@pytest.mark.parametrize("colour", [False, True])
def test_qualities(quality, colour):
    _assert_decodes_as_cv2(_encode(_image((37, 53), colour, quality),
                                   (Q, quality)))


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("hw", [(7, 13), (37, 53), (120, 161)])
def test_chroma_sampling(sampling, hw):
    img = _image(hw, True, 3)
    _assert_decodes_as_cv2(_encode(img, (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         SAMPLING[sampling])))


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("colour", [False, True])
def test_restart_intervals(interval, colour):
    img = _image((45, 70), colour, interval)
    data = _encode(img, (cv2.IMWRITE_JPEG_RST_INTERVAL, interval))
    assert b"\xff\xdd" in data
    _assert_decodes_as_cv2(data)


@pytest.mark.parametrize("colour", [False, True])
def test_optimised_huffman_tables(colour):
    img = _image((64, 90), colour, 7)
    data = _encode(img, (cv2.IMWRITE_JPEG_OPTIMIZE, 1, Q, 85))
    assert data != _encode(img, (Q, 85))
    _assert_decodes_as_cv2(data)


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       colour=st.booleans(), quality=st.integers(10, 100))
def test_random_sizes(h, w, colour, quality):
    _assert_decodes_as_cv2(_encode(_image((h, w), colour, h * w),
                                   (Q, quality)))


def _exif(orientation: int, big_endian: bool) -> bytes:
    e = ">" if big_endian else "<"
    tiff = ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", [3, 6, 8])
@pytest.mark.parametrize("big_endian", [False, True])
def test_exif_orientation(tmp_path, orientation, big_endian):
    """An APP1 segment spliced in after SOI: cv2 turns the image, and
    read_size reports the turned size."""
    data = _encode(_image((30, 47), True, orientation))
    data = data[:2] + _exif(orientation, big_endian) + data[2:]
    path = tmp_path / "o.jpg"
    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert ref.shape == ((47, 30) if orientation in (6, 8) else (30, 47))
    np.testing.assert_array_equal(image_io.read_gray(str(path)), ref)
    assert image_io.read_size(str(path)) == ref.shape
    _assert_decodes_as_cv2(data)


def test_every_orientation_is_turned_as_cv2_turns_it(tmp_path):
    base = _encode(_image((9, 14), False, 0))
    for o in range(1, 9):
        path = tmp_path / f"{o}.jpg"
        path.write_bytes(base[:2] + _exif(o, False) + base[2:])
        np.testing.assert_array_equal(
            image_io.read_gray(str(path)),
            cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), err_msg=str(o))


@pytest.mark.parametrize("fraction", [0.3, 0.6, 0.95])
@pytest.mark.parametrize("restart", [0, 2])
def test_a_file_cut_inside_its_scan_reads_as_cv2_reads_it(tmp_path,
                                                          fraction, restart):
    """cv2.imread reads a JPEG cut short inside its entropy-coded data
    (libjpeg's file source inserts an EOI): the MCU under way is completed
    with zero bits, the rest is flat grey. cv2.imdecode refuses the same
    bytes; the port reads files as cv2.imread does."""
    data = _encode(_image((48, 64), True, 5),
                   (cv2.IMWRITE_JPEG_RST_INTERVAL, restart) if restart
                   else ())
    sos = data.index(b"\xff\xda")
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:sos + int((len(data) - sos) * fraction)])
    ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert ref is not None and (ref == 128).any()
    np.testing.assert_array_equal(image_io.read_gray(str(path)), ref)


def test_unsupported_variants_raise_value_error(tmp_path):
    img = _image((24, 40), True, 9)
    prog = _encode(img, (cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    with pytest.raises(ValueError, match="progressive") as e:
        jpeg.decode_gray(prog)
    assert not isinstance(e.value, UnreadableImage)
    base = bytearray(_encode(img))
    sof = base.index(b"\xff\xc0")
    for marker, what in ((0xC3, "lossless"), (0xC9, "arithmetic")):
        other = bytearray(base)
        other[sof + 1] = marker
        with pytest.raises(ValueError, match=what):
            jpeg.decode_gray(bytes(other))
    deep = bytearray(base)
    deep[sof + 4] = 12                            # sample precision
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_gray(bytes(deep))
    path = tmp_path / "p.jpg"
    path.write_bytes(prog)
    with pytest.raises(ValueError, match="progressive"):
        image_io.read_gray(str(path))


def test_damaged_files_raise_unreadable_image(tmp_path):
    data = _encode(_image((32, 32), False, 2))
    cases = {"header.jpg": data[:100], "soi.jpg": b"\x00" + data[1:],
             "empty.jpg": data[:2] + b"\xff\xd9"}
    sos = data.index(b"\xff\xda")
    cases["nosof.jpg"] = data[:data.index(b"\xff\xc0")] + data[sos:]
    for name, bad in cases.items():
        path = tmp_path / name
        path.write_bytes(bad)
        assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is None, name
        with pytest.raises(UnreadableImage):
            image_io.read_gray(str(path))


def test_read_size_reads_the_header(tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(_encode(_image((123, 77), True, 4)))
    assert image_io.read_size(str(path)) == (123, 77)


# ---------------------------------------------------------------- encoder --

@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (64, 80), (241, 317)])
def test_cv2_decodes_the_port_encoder_as_the_port_does(hw):
    img = _image(hw, False, hw[1])
    data = jpeg.encode_gray(img, 95)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(jpeg.decode_gray(data), ref)


@pytest.mark.parametrize("hw", [(64, 80), (241, 317)])
def test_the_encoder_at_q95_is_within_one_level_of_cv2(hw):
    rng = np.random.default_rng(11)
    img = _image(hw, False, 12)
    img = np.clip(img + rng.normal(0, 12, hw), 0, 255).astype(np.uint8)
    ours = jpeg.decode_gray(jpeg.encode_gray(img, 95))
    theirs = cv2.imdecode(np.frombuffer(_encode(img, (Q, 95)), np.uint8),
                          cv2.IMREAD_GRAYSCALE)
    assert np.abs(ours.astype(int) - theirs).mean() <= 1.0
    assert np.abs(ours.astype(int) - img).mean() <= 2.0


def test_the_quality_table_is_libjpeg_scaling():
    np.testing.assert_array_equal(jpeg.quality_table(50), jpeg.K1_LUMA)
    assert jpeg.quality_table(100).max() == 1
    assert jpeg.quality_table(1).max() == 255
    q95 = jpeg.quality_table(95)
    np.testing.assert_array_equal(q95, np.clip((jpeg.K1_LUMA * 10 + 50)
                                               // 100, 1, 255))


def test_encoder_rejects_what_is_no_grey_uint8_image():
    with pytest.raises(ValueError):
        jpeg.encode_gray(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        jpeg.encode_gray(np.zeros((4, 4), np.float32))
