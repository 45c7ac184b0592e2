"""TensorBoard event files, written and read with the standard library.

The JAX loop logs through tensorboardX's SummaryWriter; the port writes
the same records itself, so that it needs no ``tensorboard`` package:

- the TFRecord framing: a little-endian u64 length, its masked CRC-32C,
  the payload, and the payload's masked CRC-32C;
- ``Event`` protos encoded by hand: the first carries ``file_version``
  "brain.Event:2", the others a ``Summary`` with one value at a step: a
  scalar (``simple_value``) or an image (PNG bytes, made with zlib), with
  an optional ``summary_description`` in the value's metadata;
- files named ``events.out.tfevents.<unix time>.<host>``, as tensorboardX
  names them.

read_events parses such a file back (and checks every CRC); TensorBoard
itself reads what EventWriter writes.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import List, Optional

import numpy as np

# --------------------------------------------------------------- CRC-32C --

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------- proto bytes --

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    """Event: wall_time (1, double), step (2, int64), then ``body``."""
    return (_key(1, 1) + struct.pack("<d", wall_time) + _key(2, 0)
            + _varint(step) + body)


def _summary_value(tag: str, value: bytes,
                   description: Optional[str]) -> bytes:
    """Summary (field 5 of Event) holding one Value: tag (1), the value's
    own field, metadata (9) with summary_description (3)."""
    v = _len_field(1, tag.encode()) + value
    if description:
        v += _len_field(9, _len_field(3, description.encode()))
    return _len_field(5, _len_field(1, v))


def encode_png(img: np.ndarray) -> bytes:
    """8-bit PNG of a [H, W] grey or [H, W, 3] RGB uint8 image (no row
    filter)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


class EventWriter:
    """Appends Event records to a new event file under ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{str(time.time())[:10]}."
            f"{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._write(_event(time.time(), 0,
                           _len_field(3, b"brain.Event:2")))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._file.write(header + struct.pack("<I", masked_crc32c(header))
                         + event + struct.pack("<I", masked_crc32c(event)))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, _summary_value(
            tag, _key(2, 5) + struct.pack("<f", float(value)), None)))

    def add_image(self, tag: str, img: np.ndarray, step: int,
                  description: Optional[str] = None) -> None:
        """img: [H, W, 3] (or [H, W]) uint8, stored as PNG."""
        h, w = img.shape[:2]
        image = (_key(1, 0) + _varint(h) + _key(2, 0) + _varint(w)
                 + _key(3, 0) + _varint(3 if img.ndim == 3 else 1)
                 + _len_field(4, encode_png(img)))
        self._write(_event(time.time(), step, _summary_value(
            tag, _len_field(4, image), description)))

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------- reader --

def _fields(buf: bytes):
    """(field, wire type, value) of each field of a proto message: ints for
    varints, bytes for length-delimited and fixed-width fields."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"proto wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _parse_value(buf: bytes) -> dict:
    out = {}
    for field, _, v in _fields(buf):
        if field == 1:
            out["tag"] = v.decode()
        elif field == 2:
            out["simple_value"] = struct.unpack("<f", v)[0]
        elif field == 4:
            img = {}
            for f, _, x in _fields(v):
                img[{1: "height", 2: "width", 3: "colorspace",
                     4: "png"}.get(f, f)] = x
            out["image"] = img
        elif field == 9:
            for f, _, x in _fields(v):
                if f == 3:
                    out["description"] = x.decode()
    return out


def read_events(path: str) -> List[dict]:
    """The events of a file: dicts with wall_time, step, and file_version
    or values (a list of dicts with tag and simple_value or image, and
    description where there is one). Raises ValueError on a bad CRC."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        payload = data[i + 12:i + 12 + n]
        (pcrc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc32c(header) or pcrc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad CRC in the record at byte {i}")
        i += 16 + n
        ev = {"wall_time": 0.0, "step": 0}
        for field, _, v in _fields(payload):
            if field == 1:
                ev["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                ev["step"] = v
            elif field == 3:
                ev["file_version"] = v.decode()
            elif field == 5:
                ev["values"] = [_parse_value(x) for f, _, x in _fields(v)
                                if f == 1]
        events.append(ev)
    return events
