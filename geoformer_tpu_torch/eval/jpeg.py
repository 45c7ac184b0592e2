"""Baseline JPEG: a grey decoder and a grey encoder, in numpy.

The decoder stands in for ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` on
JPEG files (libjpeg-turbo asked for ``JCS_GRAYSCALE``). For a YCbCr file
that output is the decoded Y component alone: Cb and Cr are entropy-decoded
to advance the bitstream and then dropped, with no upsampling and no colour
conversion. What it reads:

- baseline and extended sequential Huffman coding (SOF0, SOF1), 8-bit
  samples, 1 or 3 components with any sampling factors (Y at the largest),
  interleaved or one scan a component;
- restart intervals (DRI, RSTn), several DHT/DQT segments, 8- and 16-bit
  quantisation tables;
- the EXIF Orientation tag (APP1) 1-8, applied as cv2 applies it;
- a file cut short inside its entropy-coded data, as libjpeg reads a file
  (the MCU under way is completed with zero bits, every later MCU of the
  interval is left at zero: flat grey 128).

The entropy decoder is the only sequential part: a Python loop over
symbols with one table lookup on the next 16 bits per symbol (code and
magnitude bits fused where they fit in 16). Dequantisation, de-zigzag and
libjpeg's ``JDCT_ISLOW`` integer IDCT (jidctint.c: CONST_BITS 13,
PASS1_BITS 2, rounding descales; results clamped around +128 as its SIMD
version does) run vectorised over all blocks.

Progressive, arithmetic-coded, lossless, hierarchical, 12-bit, RGB-coded
and 2- or 4-component (CMYK) files raise ValueError naming what they are;
a file that is no JPEG structure cv2 could read raises UnreadableImage.

``encode_gray`` writes a grey baseline file: libjpeg's quality scaling of
the Annex K luminance table, the standard Huffman tables, a JFIF APP0
segment, no restart markers, the bitstream built and packed in numpy.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from geoformer_tpu_torch.eval.image_io import JPEG_SOI as SOI
from geoformer_tpu_torch.eval.image_io import UnreadableImage

# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED_SOF = {
    0xC2: "progressive JPEG", 0xC3: "lossless JPEG",
    0xC5: "hierarchical JPEG", 0xC6: "hierarchical progressive JPEG",
    0xC7: "hierarchical lossless JPEG", 0xC9: "arithmetic-coded JPEG",
    0xCA: "arithmetic-coded progressive JPEG",
    0xCB: "arithmetic-coded lossless JPEG",
    0xCD: "arithmetic-coded hierarchical JPEG",
    0xCE: "arithmetic-coded hierarchical progressive JPEG",
    0xCF: "arithmetic-coded hierarchical lossless JPEG",
}


def _unsupported(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what} is not decoded by the port "
                      "(baseline or extended sequential Huffman, 8-bit, "
                      "1 or 3 components)")


# ------------------------------------------------------------ markers ---

def _next_segment(data: bytes, pos: int, path: str):
    """(marker, body offset, body length, offset after the segment) of the
    next marker segment at or after pos; (None, ...) at the end of the
    data or EOI. Raises UnreadableImage where a segment is cut short."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:       # libjpeg skips garbage
            pos += 1
        while pos < n and data[pos] == 0xFF:       # fill bytes
            pos += 1
        if pos >= n:
            return None, 0, 0, n
        m = data[pos]
        pos += 1
        if m == 0xD9:
            return None, 0, 0, pos
        if m == 0x01 or 0xD0 <= m <= 0xD8:
            continue                                # no length field
        if pos + 2 > n:
            raise UnreadableImage(f"{path}: truncated JPEG header")
        length = (data[pos] << 8) | data[pos + 1]
        if length < 2 or pos + length > n:
            raise UnreadableImage(f"{path}: truncated JPEG header")
        return m, pos + 2, length - 2, pos + length


def _entropy_data(data: bytes, pos: int):
    """The entropy-coded data from pos: (unstuffed bytes of each restart
    interval, offset of the marker that ends it, or len(data)). A run of
    0xFF bytes before 0x00 is one 0xFF data byte, as libjpeg reads it."""
    segs = []
    cur = bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            cur += data[pos:]
            segs.append(bytes(cur))
            return segs, n
        cur += data[pos:j]
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1
        if k >= n:
            segs.append(bytes(cur))
            return segs, n
        m = data[k]
        if m == 0x00:
            cur.append(0xFF)
            pos = k + 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos = k + 1
        else:
            segs.append(bytes(cur))
            return segs, k - 1


class _Header:
    """What the marker segments before the first scan (and between scans)
    say about the frame."""

    def __init__(self):
        self.width = self.height = 0
        self.components: List[Tuple[int, int, int, int]] = []  # id, h, v, tq
        self.qt: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, Tuple[bytes, bytes]] = {}   # (BITS, HUFFVAL)
        self.ac: Dict[int, Tuple[bytes, bytes]] = {}
        self.restart = 0
        self.orientation = 1
        self.adobe_transform: Optional[int] = None
        self.jfif = False
        self.sof = False


def _parse_segment(hd: _Header, m: int, body: bytes, path: str) -> None:
    if m in _UNSUPPORTED_SOF:
        raise _unsupported(path, _UNSUPPORTED_SOF[m])
    if m in (0xC0, 0xC1):
        if hd.sof:
            raise UnreadableImage(f"{path}: JPEG with two frame headers")
        if len(body) < 6:
            raise UnreadableImage(f"{path}: invalid JPEG frame header")
        prec, h, w, nc = struct.unpack(">BHHB", body[:6])
        if prec != 8:
            raise _unsupported(path, f"{prec}-bit JPEG")
        if nc in (2, 4):
            raise _unsupported(path, f"{nc}-component JPEG"
                               + (" (CMYK)" if nc == 4 else ""))
        if nc not in (1, 3) or len(body) < 6 + 3 * nc or w == 0 or h == 0:
            raise UnreadableImage(f"{path}: invalid JPEG frame header")
        comps = []
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                raise UnreadableImage(f"{path}: invalid JPEG frame header")
            comps.append((cid, hs, vs, tq))
        hd.width, hd.height, hd.components, hd.sof = w, h, comps, True
    elif m == 0xC4:
        _parse_dht(hd, body, path)
    elif m == 0xDB:
        _parse_dqt(hd, body, path)
    elif m == 0xDD:
        if len(body) < 2:
            raise UnreadableImage(f"{path}: invalid JPEG DRI segment")
        hd.restart = (body[0] << 8) | body[1]
    elif m == 0xCC:
        raise _unsupported(path, "arithmetic-coded JPEG")
    elif m == 0xE0 and body.startswith(b"JFIF\x00"):
        hd.jfif = True
    elif m == 0xE1 and body.startswith(b"Exif\x00\x00"):
        if hd.orientation == 1:
            hd.orientation = _exif_orientation(body[6:])
    elif m == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
        hd.adobe_transform = body[11]


def _parse_dht(hd: _Header, body: bytes, path: str) -> None:
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise UnreadableImage(f"{path}: invalid JPEG Huffman table")
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = body[pos + 1:pos + 17]
        total = sum(counts)
        if tc > 1 or th > 3 or total > 256 or pos + 17 + total > len(body):
            raise UnreadableImage(f"{path}: invalid JPEG Huffman table")
        values = body[pos + 17:pos + 17 + total]
        (hd.dc if tc == 0 else hd.ac)[th] = (counts, values)
        pos += 17 + total


def _parse_dqt(hd: _Header, body: bytes, path: str) -> None:
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or pos + 1 + size > len(body):
            raise UnreadableImage(f"{path}: invalid JPEG quantisation table")
        dtype = ">u2" if pq else np.uint8
        zz = np.frombuffer(body, dtype, 64, pos + 1).astype(np.int64)
        natural = np.empty(64, np.int64)
        natural[ZIGZAG] = zz
        hd.qt[tq] = natural
        pos += 1 + size


def _exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in a TIFF block, or 1."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd, = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    count, = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        off = ifd + 2 + 12 * i
        if off + 12 > len(tiff):
            return 1
        tag, typ, n = struct.unpack(e + "HHI", tiff[off:off + 8])
        if tag == 0x0112 and typ == 3 and n == 1:
            v, = struct.unpack(e + "H", tiff[off + 8:off + 10])
            return v if 1 <= v <= 8 else 1
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The image as cv2 shows a file with this EXIF Orientation."""
    if orientation >= 5:
        img = img.T
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, axes) if axes else img)


# ------------------------------------------------------------ Huffman ---

def _code_table(counts: bytes, values: bytes):
    """(code length, symbol) of every 16-bit peek: the canonical code
    (Annex C) whose bits lead the peek; length 17, symbol 0 where no code
    does (libjpeg's answer to a bad code)."""
    length = np.full(65536, 17, np.int64)
    symbol = np.zeros(65536, np.int64)
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            lo = code << (16 - bits)
            hi = (code + 1) << (16 - bits)
            if hi > 65536:
                raise UnreadableImage("invalid JPEG Huffman table")
            length[lo:hi] = bits
            symbol[lo:hi] = values[k]
            code += 1
            k += 1
        code <<= 1
    return length, symbol


def _extend(bits: np.ndarray, s: np.ndarray) -> np.ndarray:
    """JPEG's EXTEND: s magnitude bits to a signed value."""
    half = np.where(s > 0, 1 << np.maximum(s - 1, 0), 1)
    return np.where((s > 0) & (bits < half), bits - (1 << s) + 1, bits)


@functools.lru_cache(maxsize=8)
def _dc_lut(counts: bytes, values: bytes) -> List[int]:
    """Per 16-bit peek: ``(value + 65536) << 5 | bits`` when the code and
    its magnitude bits fit in the peek, else ``-(length | s << 5)``."""
    length, s = _code_table(counts, values)
    s = np.minimum(s, 16)
    v = np.arange(65536)
    fits = length + s <= 16
    bits = (v >> np.maximum(16 - length - s, 0)) & ((1 << s) - 1)
    fused = ((_extend(bits, s) + 65536) << 5) | (length + s)
    return np.where(fits, fused, -(length | (s << 5))).tolist()


@functools.lru_cache(maxsize=8)
def _ac_lut(counts: bytes, values: bytes) -> List[int]:
    """Per 16-bit peek: ``(value + 32768) << 10 | run << 5 | bits`` of a
    coefficient whose code and magnitude bits fit in the peek; else
    ``-(length | kind << 5)`` with kind 1 EOB (and bad codes), 2 ZRL, and
    4 + symbol for a coefficient read on the slow path."""
    length, sym = _code_table(counts, values)
    r, s = sym >> 4, sym & 15
    v = np.arange(65536)
    fits = length + s <= 16
    bits = (v >> np.maximum(16 - length - s, 0)) & ((1 << s) - 1)
    fused = ((_extend(bits, s) + 32768) << 10) | (r << 5) | (length + s)
    kind = np.where(s == 0, np.where(r == 15, 2, 1), 4 + sym)
    kind = np.where(length == 17, 1, kind)
    out = np.where((s > 0) & fits & (length < 17), fused,
                   -(length | (kind << 5)))
    return out.tolist()


def _words(seg: bytes, blocks_per_mcu: int) -> Tuple[List[int], int]:
    """32-bit big-endian words at every byte offset of an unstuffed
    interval, with zero bits beyond its end (enough for the MCU under way
    when the data runs out: 64 symbols of at most 32 bits a block), and
    its length in bits."""
    pad = 256 * blocks_per_mcu + 8
    a = np.frombuffer(seg + bytes(pad), np.uint8).astype(np.uint32)
    w = (a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]
    return w.tolist(), 8 * len(seg)


def _decode_interval(w: List[int], nbits: int, units, dcl, acl,
                     pred: List[int], out: List[int]) -> None:
    """Decode the MCUs of one restart interval (or a whole scan).

    units: per MCU, a list of (component slot, block index or -1) in the
    order the blocks are coded; -1 marks a block that is decoded and
    dropped. dcl/acl: the LUTs per slot. Each kept coefficient goes to out
    as ``(block << 7 | zigzag index) << 16 | value + 32768``; pred holds
    the DC predictor of each slot. Once the decoder has read past the
    data, the rest of the interval stays zero, as libjpeg leaves it."""
    p = 0
    for mcu in units:
        if p > nbits:
            return
        for slot, blk in mcu:
            e = dcl[slot][(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if e >= 0:
                p += e & 31
                pred[slot] += (e >> 5) - 65536
            else:
                e = -e
                p += e & 31
                s = e >> 5
                if s:
                    bits = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    pred[slot] += bits if bits >= 1 << (s - 1) \
                        else bits - (1 << s) + 1
            al = acl[slot]
            k = 1
            if blk < 0:                      # decoded to advance, dropped
                while k < 64:
                    e = al[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if e > 0:
                        p += e & 31
                        k += ((e >> 5) & 31) + 1
                        continue
                    e = -e
                    p += e & 31
                    kind = e >> 5
                    if kind == 1:
                        break
                    if kind == 2:
                        k += 16
                        continue
                    p += (kind - 4) & 15
                    k += ((kind - 4) >> 4) + 1
                continue
            base = blk << 23
            out.append(base | (pred[slot] + 32768))
            while k < 64:
                e = al[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if e > 0:
                    p += e & 31
                    k += (e >> 5) & 31
                    out.append(base + (k << 16) + (e >> 10))
                    k += 1
                    continue
                e = -e
                p += e & 31
                kind = e >> 5
                if kind == 1:
                    break
                if kind == 2:
                    k += 16
                    continue
                sym = kind - 4
                s = sym & 15
                bits = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                k += sym >> 4
                out.append(base + (k << 16) + 32768
                           + (bits if bits >= 1 << (s - 1)
                              else bits - (1 << s) + 1))
                k += 1


# ---------------------------------------------------------------- IDCT ---

def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's JDCT_ISLOW of [n, 64] zigzag-free (natural order)
    quantised coefficients with a [64] natural-order table: [n, 8, 8]
    uint8 samples."""
    CB, P1 = 13, 2
    F = {"0_298": 2446, "0_390": 3196, "0_541": 4433, "0_765": 6270,
         "0_899": 7373, "1_175": 9633, "1_501": 12299, "1_847": 15137,
         "1_961": 16069, "2_053": 16819, "2_562": 20995, "3_072": 25172}

    def one_d(x, shift_in, descale):
        """The 1-D pass over axis -2 (x[..., u, :]) of int64 data."""
        x0, x1, x2, x3, x4, x5, x6, x7 = (x[:, i] for i in range(8))
        z1 = (x2 + x6) * F["0_541"]
        tmp2 = z1 + x6 * -F["1_847"]
        tmp3 = z1 + x2 * F["0_765"]
        tmp0 = (x0 + x4) << CB
        tmp1 = (x0 - x4) << CB
        if shift_in:
            tmp0 = tmp0 + shift_in
            tmp1 = tmp1 + shift_in
        t10, t13 = tmp0 + tmp3, tmp0 - tmp3
        t11, t12 = tmp1 + tmp2, tmp1 - tmp2
        o0, o1, o2, o3 = x7, x5, x3, x1
        z1 = o0 + o3
        z2 = o1 + o2
        z3 = o0 + o2
        z4 = o1 + o3
        z5 = (z3 + z4) * F["1_175"]
        o0 = o0 * F["0_298"]
        o1 = o1 * F["2_053"]
        o2 = o2 * F["3_072"]
        o3 = o3 * F["1_501"]
        z1 = z1 * -F["0_899"]
        z2 = z2 * -F["2_562"]
        z3 = z3 * -F["1_961"] + z5
        z4 = z4 * -F["0_390"] + z5
        o0 = o0 + z1 + z3
        o1 = o1 + z2 + z4
        o2 = o2 + z2 + z3
        o3 = o3 + z1 + z4
        rows = (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                t13 - o0, t12 - o1, t11 - o2, t10 - o3)
        return np.stack([r >> descale for r in rows], axis=1)

    x = coef.reshape(-1, 8, 8).astype(np.int64) * quant.reshape(8, 8)
    # pass 1 down the columns: DESCALE by CONST_BITS - PASS1_BITS; adding
    # the rounding constant inside tmp0/tmp1 reaches every output
    ws = one_d(x, 1 << (CB - P1 - 1), CB - P1)
    # pass 2 along the rows: DESCALE by CONST_BITS + PASS1_BITS + 3
    out = one_d(ws.transpose(0, 2, 1), 1 << (CB + P1 + 3 - 1),
                CB + P1 + 3).transpose(0, 2, 1)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# -------------------------------------------------------------- decode ---

def read_size(data: bytes, path: str = "<bytes>") -> Tuple[int, int]:
    """(h, w) as cv2 shows the file (after the EXIF rotation), from the
    segments before the first scan."""
    hd = _Header()
    pos = 2
    if not data.startswith(SOI):
        raise UnreadableImage(f"{path}: not a JPEG file (no SOI marker)")
    while True:
        m, off, ln, pos = _next_segment(data, pos, path)
        if m is None or m == 0xDA:
            break
        _parse_segment(hd, m, data[off:off + ln], path)
    if not hd.sof:
        raise UnreadableImage(f"{path}: JPEG without a frame header")
    h, w = hd.height, hd.width
    return (w, h) if hd.orientation >= 5 else (h, w)


def _check_colour(hd: _Header, path: str) -> None:
    if len(hd.components) == 3:
        ids = tuple(c[0] for c in hd.components)
        rgb = (hd.adobe_transform == 0 if hd.adobe_transform is not None
               else (not hd.jfif and ids == (82, 71, 66)))
        if rgb:
            raise _unsupported(path, "RGB-coded JPEG")
    hmax = max(c[1] for c in hd.components)
    vmax = max(c[2] for c in hd.components)
    if (hd.components[0][1], hd.components[0][2]) != (hmax, vmax):
        raise _unsupported(path, "JPEG whose luma is subsampled")


def decode_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """[h, w] uint8: what cv2.imread(IMREAD_GRAYSCALE) gives for a
    baseline JPEG file's bytes."""
    if not data.startswith(SOI):
        raise UnreadableImage(f"{path}: not a JPEG file (no SOI marker)")
    hd = _Header()
    out: List[int] = []
    pos, scans = 2, 0
    while True:
        try:
            m, off, ln, nxt = _next_segment(data, pos, path)
        except UnreadableImage:
            if not scans:
                raise
            break                    # cut inside a later header: stop
        if m is None:
            break
        body = data[off:off + ln]
        if m != 0xDA:
            _parse_segment(hd, m, body, path)
            pos = nxt
            continue
        if not hd.sof:
            raise UnreadableImage(f"{path}: JPEG scan before its frame")
        if not scans:
            _check_colour(hd, path)
        segs, pos = _entropy_data(data, nxt)
        _decode_scan(hd, _scan_components(hd, body, path), segs, out, path)
        scans += 1
    if not scans:
        raise UnreadableImage(f"{path}: JPEG with no image data")
    comps = hd.components
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    W, H = hd.width, hd.height
    _, yh, yv, yq = comps[0]
    ybw = -(-W // (8 * hmax)) * yh          # Y blocks a row (MCU-padded)
    ybh = -(-H // (8 * vmax)) * yv
    coef = np.zeros((ybh * ybw, 64), np.int64)
    if out:
        a = np.asarray(out, np.int64)
        coef[a >> 23, ZIGZAG[np.minimum((a >> 16) & 127, 63)]] = \
            (a & 0xFFFF) - 32768
    if yq not in hd.qt:
        raise UnreadableImage(f"{path}: JPEG without quantisation table "
                              f"{yq}")
    px = idct_islow(coef, hd.qt[yq]).reshape(ybh, ybw, 8, 8)
    img = px.transpose(0, 2, 1, 3).reshape(ybh * 8, ybw * 8)[:H, :W]
    return orient(np.ascontiguousarray(img), hd.orientation)


def _scan_components(hd: _Header, sos: bytes, path: str):
    """[(component index, DC table, AC table)] of a scan header; a table
    that no DHT defined is the standard luminance one where its index is 0
    (libjpeg-turbo's default for motion-JPEG frames)."""
    ns = sos[0] if sos else 0
    ids = [c[0] for c in hd.components]
    if ns < 1 or len(sos) < 1 + 2 * ns + 3:
        raise UnreadableImage(f"{path}: invalid JPEG scan header")
    out = []
    for i in range(ns):
        cid, t = sos[1 + 2 * i], sos[2 + 2 * i]
        td, ta = t >> 4, t & 15
        if td not in hd.dc and td == 0:
            hd.dc[0] = (bytes(DC_BITS), bytes(DC_VALS))
        if ta not in hd.ac and ta == 0:
            hd.ac[0] = (bytes(AC_BITS), bytes(AC_VALS))
        if cid not in ids or td not in hd.dc or ta not in hd.ac:
            raise UnreadableImage(f"{path}: invalid JPEG scan header")
        out.append((ids.index(cid), td, ta))
    return out


def _decode_scan(hd: _Header, scomps, segs, out: List[int],
                 path: str) -> None:
    """Decode one scan's restart intervals into out (Y blocks only)."""
    comps = hd.components
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    W, H = hd.width, hd.height
    mcux = -(-W // (8 * hmax))
    mcuy = -(-H // (8 * vmax))
    ybw = mcux * comps[0][1]
    try:
        dcl = [_dc_lut(*hd.dc[d]) for _, d, _ in scomps]
        acl = [_ac_lut(*hd.ac[a]) for _, _, a in scomps]
    except UnreadableImage as e:
        raise UnreadableImage(f"{path}: {e}") from None
    if len(scomps) == 1:
        ci = scomps[0][0]
        _, hs, vs, _ = comps[ci]
        cw = -(-(-(-W * hs // hmax)) // 8)
        ch = -(-(-(-H * vs // vmax)) // 8)
        if ci == 0:
            units = [[(0, by * ybw + bx)] for by in range(ch)
                     for bx in range(cw)]
        else:
            units = [[(0, -1)]] * (cw * ch)
    else:
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = []
                for slot, (ci, _, _) in enumerate(scomps):
                    _, hs, vs, _ = comps[ci]
                    for v in range(vs):
                        for h in range(hs):
                            blk = ((my * vs + v) * ybw + mx * hs + h
                                   if ci == 0 else -1)
                            mcu.append((slot, blk))
                units.append(mcu)
    step = hd.restart or len(units)
    for i, seg in enumerate(segs):
        chunk = units[i * step:(i + 1) * step]
        if not chunk:
            break
        w, nbits = _words(seg, len(chunk[0]))
        _decode_interval(w, nbits, chunk, dcl, acl, [0] * len(scomps), out)


# -------------------------------------------------------------- encode ---

# ITU-T T.81 Annex K: the luminance quantisation table (natural order) and
# the standard luminance Huffman tables.
K1_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_VALS = list(range(12))
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]


def quality_table(quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of the Annex K luminance table
    (baseline: entries clamped to 1..255), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((K1_LUMA * scale + 50) // 100, 1, 255)


def _encoder_codes(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) arrays indexed by symbol of a canonical table."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            code[vals[k]], size[vals[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, size


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def _category(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's magnitude category)."""
    a = np.abs(v)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))) + 1,
                    0).astype(np.int64)


def _magnitude_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << s) - 1)


def encode_gray(img: np.ndarray, quality: int = 95) -> bytes:
    """A baseline grey JFIF file of a [h, w] uint8 image."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8 or 0 in img.shape:
        raise ValueError(f"encode_gray: a non-empty [h, w] uint8 image, "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape
    qt = quality_table(quality)
    # pad to whole blocks by edge replication, as libjpeg does
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    x = np.pad(img.astype(np.float64) - 128.0, ((0, ph - h), (0, pw - w)),
               mode="edge")
    blocks = x.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
    blocks = blocks.reshape(-1, 8, 8)
    c = _dct_matrix()
    f = (c @ blocks @ c.T).reshape(-1, 64) / qt
    q = (np.sign(f) * np.floor(np.abs(f) + 0.5)).astype(np.int64)
    zz = q[:, ZIGZAG]                           # zigzag order
    nb = len(zz)

    dc_code, dc_size = _encoder_codes(DC_BITS, DC_VALS)
    ac_code, ac_size = _encoder_codes(AC_BITS, AC_VALS)
    # one token a DC, a nonzero AC (with its run), a ZRL, an EOB; each
    # token is (sort key, code << s | magnitude bits, total length)
    diff = np.diff(zz[:, 0], prepend=0)
    s = _category(diff)
    keys = [np.arange(nb) * 1024]
    words = [(dc_code[s] << s) | _magnitude_bits(diff, s)]
    lens = [dc_size[s] + s]

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    first = np.r_[True, blk[1:] != blk[:-1]] if len(blk) else \
        np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    nzrl = run // 16
    run = run % 16
    s = _category(v)
    sym = (run << 4) | s
    keys.append(blk * 1024 + k * 8 + 1)
    words.append((ac_code[sym] << s) | _magnitude_bits(v, s))
    lens.append(ac_size[sym] + s)
    zr = np.repeat(np.arange(len(blk)), nzrl)
    keys.append(blk[zr] * 1024 + k[zr] * 8)
    words.append(np.full(len(zr), ac_code[0xF0]))
    lens.append(np.full(len(zr), ac_size[0xF0]))
    last = np.zeros(nb, np.int64)
    if len(blk):
        np.maximum.at(last, blk, k)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 1024 + 1000)
    words.append(np.full(len(eob), ac_code[0x00]))
    lens.append(np.full(len(eob), ac_size[0x00]))

    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    word = np.concatenate(words)[order]
    ln = np.concatenate(lens)[order]
    # bits, most significant first: bit j of a token of length L is
    # (word >> (L - 1 - j)) & 1
    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    tok = np.repeat(np.arange(len(ln)), ln)
    j = np.arange(total) - start[tok]
    bits = ((word[tok] >> (ln[tok] - 1 - j)) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    scan = np.packbits(bits)
    ff = np.nonzero(scan == 0xFF)[0]
    scan = np.insert(scan, ff + 1, 0).astype(np.uint8)

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    app0 = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    dqt = bytes([0]) + bytes(qt[ZIGZAG].astype(np.uint8).tolist())
    sof = struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0])
    dht = (bytes([0x00]) + bytes(DC_BITS) + bytes(DC_VALS)
           + bytes([0x10]) + bytes(AC_BITS) + bytes(AC_VALS))
    sos = bytes([1, 1, 0x00, 0, 63, 0])
    return (SOI + seg(0xE0, app0) + seg(0xDB, dqt) + seg(0xC0, sof)
            + seg(0xC4, dht) + seg(0xDA, sos) + scan.tobytes() + b"\xff\xd9")
