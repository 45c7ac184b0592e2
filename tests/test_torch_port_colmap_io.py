"""The port's COLMAP I/O (eval/colmap_io.py) against the JAX package's.

The same seeded cameras, images (with observations, and one without) and
points written by both packages give the same bytes, binary and text,
and each package reads the other's files to the same values. Databases
filled by both with the same cameras, images, keypoints, matches and
two-view geometries hold the same rows, table by table. camera_K and
quantize_keypoints give the same intrinsics, ids and merged centres.
"""

import sqlite3

import numpy as np
import pytest

pytest.importorskip("torch")

from geoformer_tpu.eval import colmap_io as J  # noqa: E402
from geoformer_tpu_torch.eval import colmap_io as P  # noqa: E402


def _model():
    rng = np.random.default_rng(4)
    cameras = {1: {"model_id": 1, "width": 640, "height": 480,
                   "params": np.array([520.0, 521.5, 320.0, 240.0])},
               2: {"model_id": 2, "width": 1024, "height": 768,
                   "params": np.array([800.0, 512.0, 384.0, -0.01])}}
    images = {}
    for iid in (1, 2, 3):
        q = rng.normal(size=4)
        n = 0 if iid == 3 else 5
        images[iid] = {"qvec": q / np.linalg.norm(q),
                       "tvec": rng.normal(size=3),
                       "camera_id": 1 + iid % 2, "name": f"db/{iid}.jpg",
                       "xys": rng.uniform(0, 600, (n, 2)),
                       "point3D_ids": rng.integers(-1, 9, n)}
    points = {pid: {"xyz": rng.normal(size=3),
                    "rgb": rng.integers(0, 255, 3).astype(np.uint8),
                    "error": float(rng.random()),
                    "track": [(1, pid), (2, pid + 1)]}
              for pid in range(1, 6)}
    return cameras, images, points


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_models_are_byte_equal_and_cross_read(tmp_path, ext):
    cameras, images, points = _model()
    P.write_model(cameras, images, points, str(tmp_path / "p"), ext)
    J.write_model(cameras, images, points, str(tmp_path / "j"), ext)
    for name in ("cameras", "images", "points3D"):
        assert (tmp_path / "p" / (name + ext)).read_bytes() == \
            (tmp_path / "j" / (name + ext)).read_bytes(), name
    got = P.read_model(str(tmp_path / "j"), ext)
    ref = J.read_model(str(tmp_path / "p"), ext)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            for field in r[k]:
                np.testing.assert_array_equal(np.asarray(g[k][field]),
                                              np.asarray(r[k][field]))


def _fill(mod, path):
    db = mod.ColmapDatabase(path)
    c1 = db.add_camera(1, 640, 480, [520.0, 520.0, 320.0, 240.0])
    c2 = db.add_camera(2, 800, 600, [700.0, 400.0, 300.0, 0.0])
    i1 = db.add_image("db/a.jpg", c1)
    i2 = db.add_image("q/b.jpg", c2)
    rng = np.random.default_rng(2)
    db.add_keypoints(i1, rng.uniform(0, 600, (7, 2)))
    db.add_keypoints(i2, rng.uniform(0, 600, (5, 2)))
    m = np.array([[0, 1], [3, 4], [6, 0]])
    db.add_matches(i2, i1, m)
    db.add_two_view_geometry(i2, i1, m)
    out = (db.read_keypoints(i1), db.read_matches(i1, i2))
    db.close()
    return out


def test_databases_hold_the_same_rows(tmp_path):
    got = _fill(P, str(tmp_path / "p.db"))
    ref = _fill(J, str(tmp_path / "j.db"))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    for table in ("cameras", "images", "keypoints", "descriptors", "matches",
                  "two_view_geometries"):
        rows = []
        for name in ("p.db", "j.db"):
            conn = sqlite3.connect(str(tmp_path / name))
            rows.append(conn.execute(f"SELECT * FROM {table}").fetchall())
            conn.close()
        # NaN priors compare unequal to themselves: compare their repr
        assert repr(rows[0]) == repr(rows[1]), table
    assert P.image_ids_to_pair_id(5, 2) == J.image_ids_to_pair_id(5, 2)
    assert P.pair_id_to_image_ids(J.image_ids_to_pair_id(2, 5)) == (2, 5)


def test_intrinsics_and_keypoint_quantization_equal_jax():
    for mid in range(11):
        cam = {"model_id": mid, "params": np.arange(1.0, 13.0)}
        np.testing.assert_array_equal(P.camera_K(cam), J.camera_K(cam))
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.uniform(0, 200, (60, 2)),
                          rng.uniform(0, 200, (10, 2)).repeat(3, 0)
                          + rng.normal(0, 1.0, (30, 2))])
    kp_p = {"kps": [], "kp_means": {}}
    kp_j = {"kps": [], "kp_means": {}}
    ids_p = P.quantize_keypoints(pts, kp_p, psize=48, dthres=4.0)
    ids_j = J.quantize_keypoints(pts, kp_j, psize=48, dthres=4.0)
    assert ids_p == ids_j
    assert len(set(ids_p)) < len(pts)
    np.testing.assert_array_equal(np.asarray(kp_p["kps"]),
                                  np.asarray(kp_j["kps"]))
