"""The port's localization back half and driver (eval/sfm_localize.py,
eval/localization.py, eval/localize_driver.py) against the JAX package's.

On tests/torch_port_util.localization_scene (600 points on the
localization protocol's three planes, 5 posed db cameras in an NVM and a
COLMAP database, 2 queries, an injected exact matcher with 0.2 px noise):

- quaternions, the NVM parser, both covisibility-pair builders, the
  empty-model builders and triangulate_model equal JAX's (the numpy host
  code: the same values and the same model bytes);
- export_h5 through the port's HDF5 writer: h5py reads the port's
  features and matches files equal to the JAX export's (names, groups,
  dtypes, values), nested image names included, and the port's reader
  reads JAX's;
- localize_queries and run_localization with JAX's PnP draws injected
  (tests/torch_port_util.JaxPnpDraws): every file of the run (empty
  model, pair list, h5 exports, database rows, triangulated model) equal,
  and the poses within an f32 bar: ``ok`` equal, inlier counts within 2,
  the rotations within 0.1 deg and the camera centres within 2 cm (the
  scene is in metres) of JAX's, with poses.txt in the JAX format. The
  decisions are held in f64 by tests/test_torch_port_lie_pnp.py; in f32
  the DLT refit on ~650 points (an unnormalized 12x12 normal matrix)
  differs between the two packages by up to ~1e-2 in T, and 5
  Gauss-Newton steps leave up to 0.053 deg and 7 mm (measured here); in
  f64 the same calls agree to 1e-10.
"""

import os
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from geoformer_tpu.eval import localization as JLz  # noqa: E402
from geoformer_tpu.eval import localize_driver as JD  # noqa: E402
from geoformer_tpu.eval import sfm_localize as JS  # noqa: E402
from geoformer_tpu_torch.data.hdf5 import read_dataset  # noqa: E402
from geoformer_tpu_torch.eval import localization as PLz  # noqa: E402
from geoformer_tpu_torch.eval import localize_driver as PD  # noqa: E402
from geoformer_tpu_torch.eval import sfm_localize as PS  # noqa: E402
from torch_port_util import (  # noqa: E402
    JaxPnpDraws,
    close_poses,
    localization_scene,
    pose_gap,
)
from torch_port_util import one_torch_thread  # noqa: E402,F401

def _same(a, b):
    """Nested dicts/lists/arrays equal, value for value."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_quaternions_equal_jax():
    rng = np.random.default_rng(0)
    for q in rng.normal(size=(20, 4)):
        R = PS.qvec2rotmat(q)
        np.testing.assert_array_equal(R, JS.qvec2rotmat(q))
        np.testing.assert_array_equal(PS.rotmat2qvec(R), JS.rotmat2qvec(R))
    for R in (np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
              np.diag([-1.0, -1, 1])):                # trace <= 0 branches
        np.testing.assert_array_equal(PS.rotmat2qvec(R), JS.rotmat2qvec(R))


def test_nvm_pairs_and_empty_models_equal_jax(tmp_path):
    sc = localization_scene(str(tmp_path))
    _same(PS.parse_nvm(sc["nvm"]), JS.parse_nvm(sc["nvm"]))
    assert PS.covis_pairs_from_nvm(sc["nvm"], 3, str(tmp_path / "p.txt")) \
        == JS.covis_pairs_from_nvm(sc["nvm"], 3, str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_text() == \
        (tmp_path / "j.txt").read_text()
    got = PS.create_empty_model_from_nvm_and_database(
        sc["nvm"], sc["db"], str(tmp_path / "pm"))
    ref = JS.create_empty_model_from_nvm_and_database(
        sc["nvm"], sc["db"], str(tmp_path / "jm"))
    _same(got, ref)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "pm" / name).read_bytes() == \
            (tmp_path / "jm" / name).read_bytes()
    _same(PS.create_empty_model_from_reference_model(
        str(tmp_path / "jm"), str(tmp_path / "pr")),
        JS.create_empty_model_from_reference_model(
            str(tmp_path / "jm"), str(tmp_path / "jr")))
    intr = tmp_path / "intr.txt"
    intr.write_text("db00.jpg SIMPLE_RADIAL 640 480 500 320 240 0.01\n"
                    "zz.jpg PINHOLE 10 10 1 1 5 5\n")
    _, cam_ids = JS.load_ids_from_database(sc["db"])
    _same(PS.load_cameras_from_intrinsics_txt(str(intr), cam_ids),
          JS.load_cameras_from_intrinsics_txt(str(intr), cam_ids))
    _same(PS.parse_queries_with_intrinsics(sc["queries_txt"]),
          JS.parse_queries_with_intrinsics(sc["queries_txt"]))


def _matches(sc, pairs):
    """Each unordered pair once, as run_localization matches them."""
    out = {}
    for a, b in pairs:
        if (b, a) not in out:
            out[(a, b)] = sc["match"](a, b)
    return out


def test_exports_triangulation_and_covis_equal_jax(tmp_path):
    sc = localization_scene(str(tmp_path))
    pairs = JS.covis_pairs_from_nvm(sc["nvm"], 3)
    pm = _matches(sc, pairs)
    pm[("db00.jpg", "db04.jpg")] = np.zeros((0, 4))      # an empty pair
    kp, ids = PLz.collect_quantized_matches(pm)
    kp_j, ids_j = JLz.collect_quantized_matches(pm)
    _same((kp, ids), (kp_j, ids_j))
    assert PLz.names_to_pair("db/a.jpg", "q/b.jpg") == \
        JLz.names_to_pair("db/a.jpg", "q/b.jpg")
    # the h5 exports, with one image under a nested name
    kp_n = {("nested/" + k if k == "db01.jpg" else k): v
            for k, v in kp.items()}
    ids_n = {tuple("nested/" + n if n == "db01.jpg" else n for n in k): v
             for k, v in ids.items()}
    files = {}
    for tag, mod in (("p", PLz), ("j", JLz)):
        f, m = str(tmp_path / f"{tag}_f.h5"), str(tmp_path / f"{tag}_m.h5")
        mod.export_h5(kp_n, ids_n, f, m)
        files[tag] = (f, m)
    for p_file, j_file in zip(files["p"], files["j"]):
        got, ref = {}, {}
        for path, out in ((p_file, got), (j_file, ref)):
            with h5py.File(path, "r") as f:
                f.visititems(lambda n, o: out.__setitem__(
                    n, (o.dtype, o[()])) if isinstance(o, h5py.Dataset)
                    else out.__setitem__(n, "group"))
        assert got.keys() == ref.keys()
        for k in ref:
            if ref[k] == "group":
                assert got[k] == "group"
            else:
                assert got[k][0] == ref[k][0], k
                np.testing.assert_array_equal(got[k][1], ref[k][1])
                np.testing.assert_array_equal(read_dataset(j_file, k),
                                              ref[k][1])
    assert "nested/db01.jpg/keypoints" in got or \
        any(k.startswith("nested") for k in got)
    # the database and the triangulated model
    images = {im: {"width": 640, "height": 480,
                   "params": [500.0, 320.0, 240.0, 0.0]} for im in kp}
    PLz.build_colmap_database(str(tmp_path / "p.db"), images, kp, ids)
    JLz.build_colmap_database(str(tmp_path / "j.db"), images, kp, ids)
    for table in ("cameras", "images", "keypoints", "matches",
                  "two_view_geometries"):
        rows = [repr(sqlite3.connect(str(tmp_path / n)).execute(
            f"SELECT * FROM {table}").fetchall()) for n in ("p.db", "j.db")]
        assert rows[0] == rows[1], table
    cams, ims = JS.create_empty_model_from_nvm_and_database(
        sc["nvm"], sc["db"], str(tmp_path / "em"))
    tri_p = PS.triangulate_model(cams, {k: dict(v) for k, v in ims.items()},
                                 kp, ids)
    tri_j = JS.triangulate_model(cams, {k: dict(v) for k, v in ims.items()},
                                 kp, ids)
    _same(tri_p, tri_j)
    assert len(tri_p[1]) > 100
    assert PS.covis_pairs_from_model(tri_p[0], tri_p[1], 2) == \
        JS.covis_pairs_from_model(tri_j[0], tri_j[1], 2)


def test_localize_queries_with_jax_draws(tmp_path, monkeypatch):
    sc = localization_scene(str(tmp_path))
    pm = _matches(sc, JS.covis_pairs_from_nvm(sc["nvm"], 3))
    kp, ids = JLz.collect_quantized_matches(pm)
    cams, ims = JS.create_empty_model_from_nvm_and_database(
        sc["nvm"], sc["db"], str(tmp_path / "em"))
    ims, pts = JS.triangulate_model(cams, ims, kp, ids)
    qcams = JS.parse_queries_with_intrinsics(sc["queries_txt"])
    qm = {}
    for q, d in sc["query_pairs"]:
        qm.setdefault(q, {})[d] = sc["match"](q, d)
    qm["q_none.jpg"] = {"db00.jpg": np.zeros((0, 4))}     # below 6 points
    qcams["q_none.jpg"] = qcams["q00.jpg"]
    draws = JaxPnpDraws()
    draws.patch_jax(monkeypatch)
    ref = JS.localize_queries(cams, ims, pts, qcams, qm, seed=4)
    assert len(draws.draws) == 2
    got = PS.localize_queries(cams, ims, pts, qcams, qm, seed=4,
                              device="cpu",
                              sample_idx=dict(zip(sc["queries"],
                                                  draws.draws)))
    close_poses(got, ref)
    assert not got["q_none.jpg"]["ok"]
    for q, T in sc["queries"].items():
        assert got[q]["ok"]
        c = -PS.qvec2rotmat(got[q]["qvec"]).T @ got[q]["tvec"]
        assert np.linalg.norm(c - (-T[:3, :3].T @ T[:3, 3])) < 0.05
    PS.write_pose_file(got, str(tmp_path / "p.txt"))
    JS.write_pose_file(got, str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_text() == \
        (tmp_path / "j.txt").read_text()


def test_run_localization_equals_jax(tmp_path, monkeypatch):
    sc = localization_scene(str(tmp_path))
    qcams = JS.parse_queries_with_intrinsics(sc["queries_txt"])
    kw = dict(nvm_path=sc["nvm"], db_path=sc["db"],
              match_pairs_fn=sc["match"], queries=qcams,
              query_pairs=sc["query_pairs"], covis_topk=3,
              log=lambda *a: None)
    draws = JaxPnpDraws()
    draws.patch_jax(monkeypatch)
    ref = JD.run_localization(out_dir=str(tmp_path / "j"), **kw)
    draws.patch_port(monkeypatch, PS)
    got = PD.run_localization(out_dir=str(tmp_path / "p"), device="cpu",
                              **kw)
    assert not draws.draws
    close_poses(got, ref)
    for rel in ("empty_sfm/cameras.bin", "empty_sfm/images.bin",
                "empty_sfm/points3D.bin", "sfm_model/cameras.bin",
                "sfm_model/images.bin", "sfm_model/points3D.bin",
                "pairs-db-covis3.txt"):
        assert (tmp_path / "p" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes(), rel
    for name in ("keypoints.h5", "matches.h5"):
        with h5py.File(tmp_path / "p" / name, "r") as fp, \
                h5py.File(tmp_path / "j" / name, "r") as fj:
            names = []
            fj.visit(names.append)
            assert sorted(n for n in fp) == sorted(n for n in fj)
            for n in names:
                if isinstance(fj[n], h5py.Dataset):
                    np.testing.assert_array_equal(fp[n][()], fj[n][()])
    for table in ("cameras", "images", "keypoints", "matches"):
        rows = [repr(sqlite3.connect(str(tmp_path / d / "result.db"))
                     .execute(f"SELECT * FROM {table}").fetchall())
                for d in ("p", "j")]
        assert rows[0] == rows[1], table
    lines = [(tmp_path / d / "poses.txt").read_text().splitlines()
             for d in ("p", "j")]
    assert [ln.split()[0] for ln in lines[0]] == \
        [ln.split()[0] for ln in lines[1]] == sorted(sc["queries"])
    for a, b in zip(*lines):
        pa, pb = ({"qvec": np.asarray(x.split()[1:5], float),
                   "tvec": np.asarray(x.split()[5:8], float)} for x in (a, b))
        ang, dc = pose_gap(pa, pb)
        assert ang < 0.1 and dc < 0.02
    assert os.path.exists(tmp_path / "p" / "sfm_model" / "points3D.bin")
