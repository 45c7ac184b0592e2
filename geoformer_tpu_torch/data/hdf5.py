"""A reader and a writer for the HDF5 files of the depth corpora.

The depth maps of MegaDepth-layout corpora are HDF5 files with one
dataset (``/depth``), written by h5py. This module reads and writes them
with numpy and zlib alone, for a machine without h5py. It reads what h5py
writes by default (libver 'earliest'):

- superblock version 0 or 1 at offset 0, 8-byte offsets and lengths;
- version-1 object headers, with continuation blocks;
- groups kept in a symbol table (v1 B-tree of symbol-table nodes and a
  local heap);
- datasets of little-endian float32, float64, uint8, uint16 or int32,
  with a contiguous layout or a chunked one indexed by a v1 B-tree (any
  depth), through the shuffle and deflate filters.

Anything else raises ValueError naming the feature: a user block,
superblocks 2 and 3, version-2 object headers and the messages of
libver 'latest', groups kept in link messages or a fractal heap, compact
layouts and other chunk indexes, other filters, big-endian or other
datatypes. A file cut short raises ValueError too.

write_datasets writes datasets, in nested groups, into a new file in the
same format (contiguous, or chunked with deflate at a gzip level), which
h5py reads: the depth maps (write_dataset, one root dataset) and the
localization exports (eval/localization.export_h5: float32 keypoints and
scores, int32 matches0, one group per image or pair).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, GROUP_K, CHUNK_K = 4, 16, 32          # HDF5's default B-tree ranks

# header message types
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE, MSG_FILL = 0x1, 0x2, 0x3, 0x5
MSG_LAYOUT, MSG_LINK, MSG_FILTERS, MSG_CONTINUATION = 0x8, 0x6, 0xB, 0x10
MSG_SYMBOL_TABLE = 0x11
FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2


def _fail(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what} is not read by this HDF5 reader")


class _File:
    def __init__(self, data: bytes, path: str):
        self.data = data
        self.path = path

    def bytes(self, addr: int, n: int) -> bytes:
        if addr == UNDEF or addr + n > len(self.data):
            raise ValueError(f"{self.path}: truncated or corrupt HDF5 file "
                             f"(wants {n} bytes at {addr})")
        return self.data[addr:addr + n]

    def u(self, addr: int, n: int) -> int:
        return int.from_bytes(self.bytes(addr, n), "little")


def _superblock(f: _File) -> int:
    """Parse the superblock; returns the root object header's address."""
    if f.data[:8] != SIGNATURE:
        raise ValueError(f"{f.path}: not an HDF5 file (no signature at 0; "
                         "a user block is not read either)")
    version = f.u(8, 1)
    if version not in (0, 1):
        raise _fail(f.path, f"superblock version {version}")
    if f.u(13, 1) != 8 or f.u(14, 1) != 8:
        raise _fail(f.path, "offsets or lengths other than 8 bytes")
    # the root group's symbol table entry follows the four addresses
    return f.u(24 + (4 if version == 1 else 0) + 40, 8)


def _messages(f: _File, addr: int) -> List[Tuple[int, bytes]]:
    """(type, body) of every message of a version-1 object header."""
    if f.u(addr, 1) != 1:
        raise _fail(f.path, f"object header version {f.u(addr, 1)}")
    n_msgs = f.u(addr + 2, 2)
    blocks = [(addr + 16, f.u(addr + 8, 4))]
    out = []
    while blocks:
        pos, size = blocks.pop(0)
        end = pos + size
        while pos + 8 <= end and len(out) < n_msgs:
            mtype, msize = f.u(pos, 2), f.u(pos + 2, 2)
            body = f.bytes(pos + 8, msize)
            if mtype == MSG_CONTINUATION:
                blocks.append(struct.unpack("<QQ", body[:16]))
            out.append((mtype, body))
            pos += 8 + msize
    return out


def _group_entries(f: _File, msgs) -> Dict[str, int]:
    """Name -> object header address of a symbol-table group."""
    types = [m for m, _ in msgs]
    if MSG_SYMBOL_TABLE not in types:
        if MSG_LINK in types or MSG_LINK_INFO in types:
            raise _fail(f.path, "a group kept in link messages or a "
                        "fractal heap (libver 'latest')")
        raise ValueError(f"{f.path}: the object is not a group")
    body = dict(msgs)[MSG_SYMBOL_TABLE]
    btree, heap = struct.unpack("<QQ", body[:16])
    if f.bytes(heap, 4) != b"HEAP":
        raise ValueError(f"{f.path}: corrupt local heap")
    heap_data = f.u(heap + 24, 8)
    heap_size = f.u(heap + 8, 8)
    names = f.bytes(heap_data, heap_size)
    out = {}
    for snod in _btree_children(f, btree, 0):
        if f.bytes(snod, 4) != b"SNOD":
            raise ValueError(f"{f.path}: corrupt symbol table node")
        for i in range(f.u(snod + 6, 2)):
            e = snod + 8 + 40 * i
            off = f.u(e, 8)
            name = names[off:names.index(b"\0", off)].decode()
            out[name] = f.u(e + 8, 8)
    return out


def _btree_children(f: _File, addr: int, node_type: int, rank: int = 0):
    """Leaf children of a v1 B-tree: SNOD addresses (type 0) or
    (chunk offsets, stored size, filter mask, address) (type 1)."""
    if f.bytes(addr, 4) != b"TREE":
        raise ValueError(f"{f.path}: corrupt B-tree node")
    if f.u(addr + 4, 1) != node_type:
        raise ValueError(f"{f.path}: B-tree node of type {f.u(addr + 4, 1)}")
    level, used = f.u(addr + 5, 1), f.u(addr + 6, 2)
    key = 8 if node_type == 0 else 8 + 8 * (rank + 1)
    pos = addr + 24
    for _ in range(used):
        child = f.u(pos + key, 8)
        if level > 0:
            yield from _btree_children(f, child, node_type, rank)
        elif node_type == 0:
            yield child
        else:
            size, mask = f.u(pos, 4), f.u(pos + 4, 4)
            offs = struct.unpack(f"<{rank}Q", f.bytes(pos + 8, 8 * rank))
            yield offs, size, mask, child
        pos += key + 8


def _dataspace(path: str, body: bytes) -> Tuple[int, ...]:
    version, rank = body[0], body[1]
    if version != 1:
        raise _fail(path, f"dataspace version {version}")
    return struct.unpack(f"<{rank}Q", body[8:8 + 8 * rank])


def _datatype(path: str, body: bytes) -> np.dtype:
    cls, bits0, size = body[0] & 0xF, body[1], struct.unpack(
        "<I", body[4:8])[0]
    if bits0 & 1:
        raise _fail(path, "big-endian data")
    if cls == 1:
        offset, prec = struct.unpack("<HH", body[8:12])
        ieee = {4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}
        got = (prec, body[12], body[13], body[14], body[15],
               struct.unpack("<I", body[16:20])[0])
        if size in ieee and offset == 0 and got == ieee[size]:
            return np.dtype(f"<f{size}")
    elif cls == 0 and size in ((4,) if bits0 & 8 else (1, 2)):
        offset, prec = struct.unpack("<HH", body[8:12])
        if offset == 0 and prec == 8 * size:
            return np.dtype(f"<{'i' if bits0 & 8 else 'u'}{size}")
    raise _fail(path, f"datatype class {cls} of {size} bytes (reads "
                "float32, float64, uint8, uint16, int32)")


def _filters(path: str, body: bytes) -> List[int]:
    """The filter ids of a version-1 pipeline message, in order."""
    version, n = body[0], body[1]
    if version != 1:
        raise _fail(path, f"filter pipeline version {version}")
    pos = 8
    ids = []
    for _ in range(n):
        fid, name_len, _, n_cd = struct.unpack("<HHHH", body[pos:pos + 8])
        pos += 8 + -(-name_len // 8) * 8 + 4 * n_cd + 4 * (n_cd % 2)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
            raise _fail(path, f"filter {fid} (reads deflate and shuffle)")
        ids.append(fid)
    return ids


def _unfilter(path: str, raw: bytes, filters: List[int], mask: int,
              itemsize: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        if filters[i] == FILTER_DEFLATE:
            try:
                raw = zlib.decompress(raw)
            except zlib.error as e:
                raise ValueError(f"{path}: corrupt deflate chunk ({e})")
        else:
            n = len(raw) // itemsize
            head = np.frombuffer(raw, np.uint8, n * itemsize)
            raw = head.reshape(itemsize, n).T.tobytes() + raw[n * itemsize:]
    return raw


def read_dataset(path: str, name: str = "/depth") -> np.ndarray:
    """The dataset ``name`` of the HDF5 file at ``path`` as a numpy array
    (its own dtype and shape)."""
    with open(path, "rb") as fh:
        f = _File(fh.read(), path)
    addr = _superblock(f)
    for part in [p for p in name.split("/") if p]:
        entries = _group_entries(f, _messages(f, addr))
        if part not in entries:
            raise KeyError(f"{path}: no object {name!r}")
        addr = entries[part]
    msgs = _messages(f, addr)
    found = dict(msgs)
    for need in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT):
        if need not in found:
            raise ValueError(f"{path}: {name!r} is not a dataset")
    shape = _dataspace(path, found[MSG_DATASPACE])
    dtype = _datatype(path, found[MSG_DATATYPE])
    filters = _filters(path, found[MSG_FILTERS]) if MSG_FILTERS in found \
        else []
    lay = found[MSG_LAYOUT]
    if lay[0] != 3:
        raise _fail(path, f"data layout version {lay[0]}")
    count = int(np.prod(shape))
    if lay[1] == 1:                                     # contiguous
        data_addr, size = struct.unpack("<QQ", lay[2:18])
        if data_addr == UNDEF:
            return np.zeros(shape, dtype)
        if size != count * dtype.itemsize:
            raise ValueError(f"{path}: contiguous size {size} for {shape}")
        return np.frombuffer(f.bytes(data_addr, size), dtype).reshape(shape)
    if lay[1] != 2:
        raise _fail(path, "a compact data layout" if lay[1] == 0
                    else f"data layout class {lay[1]}")
    rank = lay[2] - 1
    btree = struct.unpack("<Q", lay[3:11])[0]
    chunk = struct.unpack(f"<{rank}I", lay[11:11 + 4 * rank])
    out = np.zeros(shape, dtype)
    if btree == UNDEF:
        return out
    for offs, size, mask, caddr in _btree_children(f, btree, 1, rank):
        raw = _unfilter(path, f.bytes(caddr, size), filters, mask,
                        dtype.itemsize)
        if len(raw) != int(np.prod(chunk)) * dtype.itemsize:
            raise ValueError(f"{path}: chunk of {len(raw)} bytes")
        block = np.frombuffer(raw, dtype).reshape(chunk)
        dst = tuple(slice(o, min(o + c, s))
                    for o, c, s in zip(offs, chunk, shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


# ---------------------------------------------------------------- writer --

def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _object_header(msgs: List[Tuple[int, bytes, int]]) -> bytes:
    """A version-1 object header of (type, body, flags) messages."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(m)), fl) + _pad8(m)
                    for t, m, fl in msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _datatype_msg(dtype: np.dtype) -> bytes:
    if dtype.kind == "f":
        prec = 8 * dtype.itemsize
        exp_loc, exp_size, mant, bias = ((23, 8, 23, 127) if prec == 32
                                         else (52, 11, 52, 1023))
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, prec - 1, 0,
                           dtype.itemsize, 0, prec, exp_loc, exp_size, 0,
                           mant, bias)
    signed = 0x08 if dtype.kind == "i" else 0
    return struct.pack("<BBBBIHH", 0x10, signed, 0, 0, dtype.itemsize, 0,
                       8 * dtype.itemsize)


def _chunk_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """At most 2 * CHUNK_K chunks, so the index is one B-tree node: the
    first axis split into up to that many pieces."""
    first = -(-shape[0] // min(shape[0], 2 * CHUNK_K))
    return (first,) + tuple(shape[1:])


def _dataset_header(arr: np.ndarray, gzip: Optional[int], put) -> bytes:
    """The object header of one dataset whose data ``put`` places: empty
    arrays contiguous at the undefined address (as h5py writes them),
    else contiguous, or with ``gzip`` chunked and deflated."""
    rank = arr.ndim
    space = struct.pack("<BBB5x", 1, rank, 1) + struct.pack(
        f"<{2 * rank}Q", *arr.shape, *arr.shape)
    msgs = [(MSG_DATASPACE, space, 0), (MSG_DATATYPE,
                                        _datatype_msg(arr.dtype), 1)]
    if gzip is None or arr.size == 0:
        data = put(arr.tobytes()) if arr.size else UNDEF
        msgs.append((MSG_FILL, struct.pack("<BBBB", 2, 2, 0, 0), 1))
        msgs.append((MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data,
                                             arr.nbytes), 0))
        return _object_header(msgs)
    level = int(gzip)
    if not 0 <= level <= 9:
        raise ValueError(f"write_datasets: gzip level {gzip}")
    chunk = _chunk_shape(arr.shape)
    entries = []
    for start in range(0, arr.shape[0], chunk[0]):
        block = np.zeros(chunk, arr.dtype)
        part = arr[start:start + chunk[0]]
        block[:len(part)] = part
        blob = zlib.compress(block.tobytes(), level)
        offs = (start,) + (0,) * rank
        entries.append((offs, len(blob), put(blob)))
    keys = b"".join(struct.pack("<II", size, 0)
                    + struct.pack(f"<{rank + 1}Q", *offs)
                    + struct.pack("<Q", addr)
                    for offs, size, addr in entries)
    last = (entries[-1][0][0] + chunk[0],) + tuple(chunk[1:]) + (0,)
    keys += struct.pack("<II", 0, 0) + struct.pack(f"<{rank + 1}Q", *last)
    key_size = 8 + 8 * (rank + 1)
    ctree = put(b"TREE" + struct.pack("<BBHQQ", 1, 0, len(entries), UNDEF,
                                      UNDEF) + keys
                + b"\0" * ((2 * CHUNK_K - len(entries)) * (key_size + 8)))
    msgs.append((MSG_FILL, struct.pack("<BBBB", 2, 3, 0, 0), 1))
    msgs.append((MSG_LAYOUT, struct.pack(
        f"<BBBQ{rank + 1}I", 3, 2, rank + 1, ctree, *chunk,
        arr.dtype.itemsize), 0))
    msgs.append((MSG_FILTERS, struct.pack("<BB6x", 1, 1)
                 + struct.pack("<HHHH", FILTER_DEFLATE, 8, 1, 1)
                 + b"deflate\0" + struct.pack("<I4x", level), 1))
    return _object_header(msgs)


_TREE_BYTES = 24 + 8 * (2 * GROUP_K + 1) + 8 * 2 * GROUP_K
_SNOD_BYTES = 8 + 40 * 2 * LEAF_K


def _group(children: Dict[str, int], put, out: bytearray) -> Tuple[int, int,
                                                                   int]:
    """Write a symbol-table group of ``children`` (name -> object header
    address): its local heap, symbol-table nodes of up to 2 * LEAF_K
    entries in name order, and a v1 B-tree over them of as many levels as
    its 2 * GROUP_K-wide nodes need. Returns (header, B-tree, heap)
    addresses."""
    names = sorted(children, key=lambda n: n.encode())
    heap_blob = bytearray(_pad8(b"\0"))            # "" at offset 0
    offsets = {}
    for n in names:
        offsets[n] = len(heap_blob)
        heap_blob += _pad8(n.encode() + b"\0")
    heap_data = put(bytes(heap_blob))
    # free-list offset 1: HDF5's "no free block" (H5HL_FREE_NULL)
    heap = put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_blob), 1,
                                     heap_data))
    # level 0: (node address, heap offset of its largest name)
    level = []
    for i in range(0, max(len(names), 1), 2 * LEAF_K):
        part = names[i:i + 2 * LEAF_K]
        body = b"".join(struct.pack("<QQI4x16x", offsets[n], children[n], 0)
                        for n in part)
        snod = put(b"SNOD" + struct.pack("<BxH", 1, len(part)) + body
                   + b"\0" * (_SNOD_BYTES - 8 - len(body)))
        level.append((snod, offsets[part[-1]] if part else 0))
    depth = 0
    while True:
        nodes = [level[i:i + 2 * GROUP_K]
                 for i in range(0, len(level), 2 * GROUP_K)]
        out.extend(b"\0" * (-len(out) % 8))
        first = len(out)
        addrs = [first + k * _TREE_BYTES for k in range(len(nodes))]
        for k, kids in enumerate(nodes):
            left = addrs[k - 1] if k else UNDEF
            right = addrs[k + 1] if k + 1 < len(nodes) else UNDEF
            body = struct.pack("<Q", 0) + b"".join(
                struct.pack("<QQ", child, key) for child, key in kids)
            out.extend(b"TREE" + struct.pack("<BBHQQ", 0, depth, len(kids),
                                             left, right) + body
                       + b"\0" * (_TREE_BYTES - 24 - len(body)))
        level = [(a, kids[-1][1]) for a, kids in zip(addrs, nodes)]
        if len(level) == 1:
            break
        depth += 1
    tree = level[0][0]
    header = put(_object_header([(MSG_SYMBOL_TABLE,
                                  struct.pack("<QQ", tree, heap), 0)]))
    return header, tree, heap


WRITE_DTYPES = ("<f4", "<f8", "|u1", "<u2", "<i4")


def write_datasets(path: str, datasets: Dict[str, np.ndarray],
                   gzip: Optional[int] = None) -> None:
    """Write a new HDF5 file holding every ``name -> array`` of
    ``datasets`` (float32, float64, uint8, uint16 or int32, at least 1-D;
    empty arrays too), each contiguous or, with ``gzip`` (a level 0-9),
    chunked and deflated. A ``/`` in a name makes nested groups, as h5py's
    create_group and create_dataset do; a name may not be both a group and
    a dataset."""
    tree: dict = {}
    for name, array in datasets.items():
        arr = np.asarray(array)
        dtype = arr.dtype.newbyteorder("<")
        if dtype.str not in WRITE_DTYPES or arr.ndim == 0:
            raise ValueError(f"write_datasets: {name!r} {arr.dtype} "
                             f"{arr.shape} (writes float32, float64, uint8, "
                             "uint16 and int32 arrays of rank >= 1)")
        parts = [p for p in name.split("/") if p]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"write_datasets: {p!r} in {name!r} is a "
                                 "dataset")
        if not parts or parts[-1] in node:
            raise ValueError(f"write_datasets: {name!r} is empty or "
                             "written twice")
        node[parts[-1]] = np.ascontiguousarray(arr.astype(dtype,
                                                          copy=False))
    out = bytearray(96)                          # superblock, filled last

    def put(blob: bytes) -> int:
        out.extend(b"\0" * (-len(out) % 8))
        addr = len(out)
        out.extend(blob)
        return addr

    def write(node) -> Tuple[int, int, int]:
        kids = {n: (write(sub)[0] if isinstance(sub, dict)
                    else put(_dataset_header(sub, gzip, put)))
                for n, sub in node.items()}
        return _group(kids, put, out)

    root, rtree, rheap = write(tree)
    struct.pack_into("<8sBBBBBBBxHHI", out, 0, SIGNATURE, 0, 0, 0, 0, 0,
                     8, 8, LEAF_K, GROUP_K, 0)
    struct.pack_into("<QQQQ", out, 24, 0, UNDEF, len(out), UNDEF)
    struct.pack_into("<QQI4xQQ", out, 56, 0, root, 1, rtree, rheap)
    with open(path, "wb") as fh:
        fh.write(out)


def write_dataset(path: str, name: str, array,
                  gzip: Optional[int] = None) -> None:
    """Write ``array`` (float32, float64, uint8 or uint16, at least 1-D and
    not empty) as the dataset ``name`` under the root group of a new HDF5
    file: contiguous, or with ``gzip`` (a level 0-9) chunked and deflated.
    """
    arr = np.asarray(array)
    dtype = arr.dtype.newbyteorder("<")
    if dtype.str not in ("<f4", "<f8", "|u1", "<u2") or arr.ndim == 0 \
            or arr.size == 0:
        raise ValueError(f"write_dataset: {arr.dtype} {arr.shape} (writes "
                         "non-empty float32, float64, uint8, uint16 arrays)")
    leaf = name.strip("/")
    if not leaf or "/" in leaf:
        raise ValueError(f"write_dataset: {name!r} is not a root dataset")
    write_datasets(path, {leaf: arr}, gzip=gzip)
