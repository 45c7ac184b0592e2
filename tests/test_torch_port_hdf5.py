"""The port's HDF5 reader and writer (data/hdf5.py) against h5py.

Files written by h5py read back bit for bit (contiguous; chunked with
gzip 1 as the depth renderer writes them; shuffle + gzip; float32,
float64, uint8 and uint16; shapes that are not a multiple of the chunk;
a chunk index deep enough to need inner B-tree nodes; nested groups;
int32). Files that the port writes read back equal through h5py: one
root dataset (write_dataset) or many in nested groups (write_datasets:
the localization exports' layout, float32 and int32, empty datasets,
groups large enough for a multi-level B-tree of symbol-table nodes).
Truncated files, big-endian data, the version-2 superblock (libver
'latest'), compact layouts, other filters and a user block raise
ValueError.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from geoformer_tpu_torch.data.hdf5 import (  # noqa: E402
    read_dataset,
    write_dataset,
    write_datasets,
)

RNG = np.random.default_rng(0)
DEPTH = (RNG.random((120, 160)) * 10).astype(np.float32)


def _array(dtype, shape):
    x = RNG.random(shape) * (200 if np.dtype(dtype).kind == "u" else 50)
    return x.astype(dtype)


H5PY_CASES = {
    "contiguous": (DEPTH, {}),
    "gzip1_renderer": (DEPTH, dict(compression="gzip", compression_opts=1)),
    "shuffle_gzip": (DEPTH, dict(compression="gzip", shuffle=True)),
    "f64_ragged_chunks": (_array(np.float64, (37, 53)),
                          dict(chunks=(8, 16), compression="gzip")),
    "u16_ragged_chunks": (_array(np.uint16, (33, 41)),
                          dict(chunks=(10, 10), shuffle=True)),
    "u8_contiguous": (_array(np.uint8, (17, 19)), {}),
    "f32_3d": (_array(np.float32, (5, 30, 7)),
               dict(chunks=(2, 8, 7), compression="gzip")),
    "deep_chunk_index": (_array(np.float32, (300, 300)),
                         dict(chunks=(10, 10), compression="gzip",
                              compression_opts=1)),
}


@pytest.mark.parametrize("case", list(H5PY_CASES))
def test_reads_what_h5py_writes(tmp_path, case):
    data, kw = H5PY_CASES[case]
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("/depth", data=data, **kw)
    got = read_dataset(path, "/depth")
    assert got.dtype == data.dtype and got.shape == data.shape
    assert got.tobytes() == data.tobytes()


def test_reads_a_nested_dataset(tmp_path):
    path = str(tmp_path / "u.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("/a/b/depth", data=DEPTH, compression="gzip")
        f.create_dataset("/other", data=np.arange(3.0))
    np.testing.assert_array_equal(read_dataset(path, "/a/b/depth"), DEPTH)
    with pytest.raises(KeyError):
        read_dataset(path, "/a/missing")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8,
                                   np.uint16])
@pytest.mark.parametrize("gzip", [None, 1, 9])
def test_h5py_reads_what_the_port_writes(tmp_path, dtype, gzip):
    data = _array(dtype, (70, 45))
    path = str(tmp_path / "w.h5")
    write_dataset(path, "/depth", data, gzip=gzip)
    with h5py.File(path, "r") as f:
        ds = f["depth"]
        assert ds.dtype == data.dtype and ds.shape == data.shape
        assert (ds.compression == "gzip") == (gzip is not None)
        np.testing.assert_array_equal(ds[()], data)
    np.testing.assert_array_equal(read_dataset(path), data)


def test_the_renderers_depth_round_trips(tmp_path):
    """A 480x640 depth map as the corpus writes it (gzip 1): h5py and the
    port read the same bits, and the file is as small as h5py's."""
    depth = np.zeros((480, 640), np.float32)
    depth[40:400, 30:600] = RNG.random((360, 570)) * 8 + 1
    ours, theirs = str(tmp_path / "p.h5"), str(tmp_path / "h.h5")
    write_dataset(ours, "/depth", depth, gzip=1)
    with h5py.File(theirs, "w") as f:
        f.create_dataset("/depth", data=depth, compression="gzip",
                         compression_opts=1)
    with h5py.File(ours, "r") as f:
        assert f["depth"][()].tobytes() == depth.tobytes()
    assert read_dataset(theirs).tobytes() == depth.tobytes()
    assert (tmp_path / "p.h5").stat().st_size < \
        1.1 * (tmp_path / "h.h5").stat().st_size


def _h5py_file(tmp_path, **kw):
    path = str(tmp_path / "x.h5")
    file_kw = kw.pop("file_kw", {})
    with h5py.File(path, "w", **file_kw) as f:
        f.create_dataset("/depth", **kw)
    return path


@pytest.mark.parametrize("what,make", [
    ("big-endian", lambda p: _h5py_file(p, data=DEPTH.astype(">f4"))),
    ("superblock version", lambda p: _h5py_file(
        p, data=DEPTH, file_kw=dict(libver="latest"))),
    ("filter 3", lambda p: _h5py_file(p, data=DEPTH, fletcher32=True)),
    ("compact", lambda p: _h5py_file(
        p, data=np.arange(4.0, dtype=np.float32),
        dcpl=_compact_dcpl())),
    ("datatype class", lambda p: _h5py_file(p, data=np.arange(4, dtype="<i8"))),
    ("user block", lambda p: _h5py_file(
        p, data=DEPTH, file_kw=dict(userblock_size=512))),
])
def test_unsupported_features_raise_value_error(tmp_path, what, make):
    path = make(tmp_path)
    with pytest.raises(ValueError, match=what):
        read_dataset(path)


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def test_a_truncated_file_raises_value_error(tmp_path):
    path = tmp_path / "t.h5"
    write_dataset(str(path), "/depth", DEPTH, gzip=1)
    data = path.read_bytes()
    for cut in (10, 200, len(data) // 2, len(data) - 8):
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError):
            read_dataset(str(path))
    path.write_bytes(b"not an hdf5 file at all")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        read_dataset(str(path))


def test_write_rejects_what_it_cannot_write(tmp_path):
    for bad in (np.zeros((3, 3), np.int32), np.zeros(0, np.float32),
                np.float32(1.0)):
        with pytest.raises(ValueError):
            write_dataset(str(tmp_path / "b.h5"), "/depth", bad)
    with pytest.raises(ValueError):
        write_dataset(str(tmp_path / "b.h5"), "/a/depth", DEPTH)


def _h5py_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(
            o, h5py.Dataset) else out.__setitem__(n, None))
    return out


@pytest.mark.parametrize("n_groups", [3, 300])
def test_h5py_reads_what_write_datasets_writes(tmp_path, n_groups):
    """hloc-style exports: <image>/keypoints, <image>/scores and
    <pair>/matches0 (int32, empty for a pair without matches), image names
    with '/' in them; 300 groups need two B-tree levels at the root."""
    data = {}
    for i in range(n_groups):
        k = i % 7
        data[f"db/{i}.jpg/keypoints"] = _array(np.float32, (k, 2))
        data[f"db/{i}.jpg/scores"] = np.ones(k, np.float32)
        data[f"db{i}.jpg_q.jpg/matches0"] = (
            np.arange(k, dtype=np.int32) - 1)
    path = str(tmp_path / "x.h5")
    write_datasets(path, data)
    got = _h5py_tree(path)
    assert {k for k, v in got.items() if v is not None} == set(data)
    for k, v in data.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(read_dataset(path, k), v)
    assert got["db"] is None and got["db/0.jpg"] is None


def test_write_datasets_gzip_and_reads_h5py_int32(tmp_path):
    path = str(tmp_path / "g.h5")
    data = {"a/depth": DEPTH, "b": _array(np.uint16, (9, 4))}
    write_datasets(path, data, gzip=4)
    with h5py.File(path, "r") as f:
        assert f["a/depth"].compression == "gzip"
        np.testing.assert_array_equal(f["a/depth"][()], DEPTH)
        np.testing.assert_array_equal(f["b"][()], data["b"])
    theirs = str(tmp_path / "h.h5")
    m0 = np.array([3, -1, 0, 7], np.int32)
    with h5py.File(theirs, "w") as f:
        f.create_dataset("p/matches0", data=m0)
    got = read_dataset(theirs, "p/matches0")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, m0)


def test_write_datasets_rejects_what_it_cannot_write(tmp_path):
    path = str(tmp_path / "b.h5")
    for bad in ({"x": np.zeros(3, np.int64)}, {"x": np.float32(1.0)},
                {"a": DEPTH, "a/b": DEPTH}, {"/": DEPTH}):
        with pytest.raises(ValueError):
            write_datasets(path, bad)
