"""Image files to uint8 grey arrays, with zlib and numpy only.

Stands in for ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, which the JAX
package calls (eval/matcher.py, eval/hpatches.py, eval/fire.py,
eval/isc.py, data/synthetic.py); the port has no cv2. Three formats are
read:

- PNG, 8 bits a sample, not interlaced: grey, grey+alpha, RGB and RGBA,
  all five row filters. As cv2 (through libpng) does, alpha is dropped
  and RGB becomes grey by libpng's fixed-point weights,
  ``(9797 R + 19234 G + 3737 B) >> 15``.
- Binary PGM and PPM (P5, P6) with maxval 255, as HPatches ships them; RGB
  becomes grey by cv2's weights, ``(4899 R + 9617 G + 1868 B + 8192) >> 14``.
- Baseline JPEG (eval/jpeg.py): the Y component, as libjpeg gives it for
  grey output, turned by the EXIF orientation.

A file that cv2 reads and the port does not raises ValueError naming the
format: progressive, arithmetic-coded, lossless, 12-bit and CMYK JPEGs;
16-bit, palette and interlaced PNGs; ASCII or 16-bit PNM; GIF, BMP, TIFF,
WebP. A file that cv2 cannot read either (truncated PNG or PNM, a bad CRC,
a JPEG cut inside its headers, bad markers, not an image) raises
UnreadableImage, a ValueError, so that a caller can skip it as the JAX
package skips a file for which cv2.imread returns None.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples a pixel
_PNG_COLOUR_NAMES = {3: "palette"}
JPEG_SOI = b"\xff\xd8"


class UnreadableImage(ValueError):
    """A file that cv2.imread cannot read either: damaged or no image."""


def read_gray(path: str) -> np.ndarray:
    """[h, w] uint8 grey image of a PNG, PGM, PPM or JPEG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return _decode_png(data, path)
    if data[:2] in (b"P5", b"P6"):
        return _decode_pnm(data, path)
    if data.startswith(JPEG_SOI):
        from geoformer_tpu_torch.eval import jpeg

        return jpeg.decode_gray(data, path)
    raise _not_decoded(data, path)


def read_size(path: str) -> Tuple[int, int]:
    """(h, w) of a PNG, PGM, PPM or JPEG file (as read_gray would return
    it) from its header alone."""
    with open(path, "rb") as f:
        head = f.read(65536)
    if head.startswith(PNG_SIGNATURE):
        if head[12:16] != b"IHDR" or len(head) < 24:
            raise UnreadableImage(f"{path}: PNG without a leading IHDR "
                                  "chunk")
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    if head[:2] in (b"P5", b"P6"):
        w, h, _, _ = _pnm_header(head, path)
        return h, w
    if head.startswith(JPEG_SOI):
        from geoformer_tpu_torch.eval import jpeg

        try:
            return jpeg.read_size(head, path)
        except UnreadableImage:
            if len(head) < 65536:
                raise
        with open(path, "rb") as f:            # headers beyond 64 KiB
            return jpeg.read_size(f.read(), path)
    raise _not_decoded(head, path)


def _not_decoded(data: bytes, path: str) -> ValueError:
    if data[:2] in (b"P1", b"P2", b"P3", b"P4"):
        name = f"ASCII or bitmap PNM ({data[:2].decode()})"
    else:
        for magic, name in ((b"GIF8", "GIF"), (b"BM", "BMP"),
                            (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                            (b"RIFF", "WebP")):
            if data.startswith(magic):
                break
        else:
            return UnreadableImage(f"{path}: not an image file the port "
                                   "or cv2 reads")
    return ValueError(f"{path}: {name} is not a format the port decodes "
                      "(PNG, binary PGM/PPM, baseline JPEG)")


# ------------------------------------------------------------------ PNG ---

def _png_chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise UnreadableImage(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise UnreadableImage(f"{path}: truncated PNG ({kind!r} chunk)")
        body = data[pos + 8:end - 4]
        crc, = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise UnreadableImage(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _decode_png(data: bytes, path: str) -> np.ndarray:
    chunks = _png_chunks(data, path)
    kind, ihdr = next(chunks)
    if kind != b"IHDR" or len(ihdr) != 13:
        raise UnreadableImage(f"{path}: PNG without a leading IHDR chunk")
    w, h, depth, colour, method, filt, interlace = struct.unpack(
        ">IIBBBBB", ihdr)
    if colour not in _PNG_CHANNELS:
        name = _PNG_COLOUR_NAMES.get(colour, f"colour type {colour}")
        raise ValueError(f"{path}: {name} PNG is not decoded by the port")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not decoded by the "
                         "port (8 bits a sample only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not decoded by the port")
    if method or filt or w == 0 or h == 0:
        raise UnreadableImage(f"{path}: invalid PNG header")
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise UnreadableImage(
            f"{path}: corrupt PNG image data ({e})") from None
    bpp = _PNG_CHANNELS[colour]
    if len(raw) != h * (1 + w * bpp):
        raise UnreadableImage(f"{path}: PNG image data holds {len(raw)} "
                              f"bytes, expected {h * (1 + w * bpp)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise UnreadableImage(f"{path}: PNG row filter {int(ftype.max())}")
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), ftype)
    if colour in (0, 4):                      # grey; alpha is dropped
        return np.ascontiguousarray(px[..., 0])
    rgb = px[..., :3].astype(np.uint32)
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2])
            >> 15).astype(np.uint8)


def _unfilter(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of [h, w, bpp] bytes.

    A byte's predictor reads its left (a), upper (b) and upper-left (c)
    neighbours after reconstruction, so the Average and Paeth filters are
    recurrences along the row as well as down the image. The pixels are
    reconstructed one anti-diagonal (r + x constant) at a time: all inputs
    of a pixel lie on earlier anti-diagonals, so each step is one numpy
    pass over at most min(h, w) pixels, for any mix of row filters."""
    h, w, bpp = filt.shape
    out = np.zeros((h + 1, w + 1, bpp), np.int32)    # row 0, column 0 = 0
    f = filt.astype(np.int32)
    rows_all = np.arange(h)
    for d in range(h + w - 1):
        r = rows_all[max(0, d - w + 1):min(h, d + 1)]
        x = d - r
        a = out[r + 1, x]
        b = out[r, x + 1]
        c = out[r, x]
        t = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


# ------------------------------------------------------------------ PNM ---

def _pnm_header(data: bytes, path: str):
    """(w, h, maxval, offset of the raster) of a binary PGM/PPM."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise UnreadableImage(f"{path}: invalid PNM header")
        fields.append(int(data[start:pos]))
    if pos >= len(data) or not data[pos:pos + 1].isspace():
        raise UnreadableImage(f"{path}: invalid PNM header")
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: PNM with maxval {maxval} is not decoded "
                         "by the port (255 only)")
    if w == 0 or h == 0:
        raise UnreadableImage(f"{path}: invalid PNM header")
    return w, h, maxval, pos + 1


def _decode_pnm(data: bytes, path: str) -> np.ndarray:
    w, h, _, off = _pnm_header(data, path)
    ch = 3 if data[:2] == b"P6" else 1
    n = w * h * ch
    if len(data) < off + n:
        raise UnreadableImage(f"{path}: truncated PNM ({len(data) - off} "
                              f"of {n} raster bytes)")
    px = np.frombuffer(data, np.uint8, n, off).reshape(h, w, ch)
    if ch == 1:
        return px[..., 0].copy()
    rgb = px.astype(np.uint32)
    return ((4899 * rgb[..., 0] + 9617 * rgb[..., 1] + 1868 * rgb[..., 2]
             + 8192) >> 14).astype(np.uint8)
