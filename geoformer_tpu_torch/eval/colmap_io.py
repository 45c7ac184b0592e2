"""COLMAP interoperability: sqlite database, binary and text models,
camera intrinsics and keypoint quantization.

Counterpart of geoformer_tpu/eval/colmap_io.py, the same code (numpy,
sqlite3 and struct), writing the same bytes: the reference's plumbing
(eval_tool/immatch/utils/colmap/database.py:144-236,
colmap/read_write_model.py:77-505, localize_sfm_helper.py:173-215)
written against the public COLMAP file formats. Detector-free matchers
emit matches, not repeatable keypoints, so quantize_keypoints merges
nearby match endpoints into shared keypoint ids, which COLMAP-style
triangulation needs.
"""

from __future__ import annotations

import sqlite3
import struct
from typing import Dict, List, Tuple

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE INDEX IF NOT EXISTS index_name ON images(name);
"""


def image_ids_to_pair_id(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    id2 = pair_id % MAX_IMAGE_ID
    id1 = (pair_id - id2) // MAX_IMAGE_ID
    return id1, id2


def _blob(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


class ColmapDatabase:
    """Minimal COLMAP-compatible sqlite database writer/reader."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def close(self):
        self.conn.commit()
        self.conn.close()

    def add_camera(self, model: int, width: int, height: int, params,
                   prior_focal_length: bool = False, camera_id=None) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height,
             _blob(np.asarray(params, np.float64)), prior_focal_length))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int, image_id=None) -> int:
        nan = float("nan")
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, nan, nan, nan, nan, nan, nan, nan))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, kps: np.ndarray):
        kps = np.asarray(kps, np.float32)
        assert kps.ndim == 2 and kps.shape[1] in (2, 4, 6)
        self.conn.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                          (image_id, *kps.shape, _blob(kps)))

    def add_matches(self, id1: int, id2: int, matches: np.ndarray):
        matches = np.asarray(matches, np.uint32)
        assert matches.ndim == 2 and matches.shape[1] == 2
        if id1 > id2:
            matches = matches[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (image_ids_to_pair_id(id1, id2), *matches.shape, _blob(matches)))

    def add_two_view_geometry(self, id1: int, id2: int, matches: np.ndarray,
                              F=None, E=None, H=None, config: int = 2):
        matches = np.asarray(matches, np.uint32)
        if id1 > id2:
            matches = matches[:, ::-1]
        eye = np.eye(3, dtype=np.float64)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_ids_to_pair_id(id1, id2), *matches.shape, _blob(matches),
             config, _blob(np.asarray(F if F is not None else eye)),
             _blob(np.asarray(E if E is not None else eye)),
             _blob(np.asarray(H if H is not None else eye)),
             _blob(np.array([1.0, 0, 0, 0])), _blob(np.zeros(3))))

    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        r, c, data = row
        return np.frombuffer(data, np.float32).reshape(r, c)

    def read_matches(self, id1: int, id2: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (image_ids_to_pair_id(id1, id2),)).fetchone()
        r, c, data = row
        return np.frombuffer(data, np.uint32).reshape(r, c)


# ---------------------------------------------------------------- model io

def write_cameras_binary(cameras: Dict[int, dict], path: str):
    """cameras: {id: {'model_id', 'width', 'height', 'params'}}."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, c in cameras.items():
            f.write(struct.pack("<iiQQ", cid, c["model_id"], c["width"],
                                c["height"]))
            f.write(np.asarray(c["params"], np.float64).tobytes())


def read_cameras_binary(path: str) -> Dict[int, dict]:
    n_params = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4,
                9: 5, 10: 12}
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            params = np.frombuffer(f.read(8 * n_params[model_id]), np.float64)
            out[cid] = {"model_id": model_id, "width": w, "height": h,
                        "params": params}
    return out


def write_images_binary(images: Dict[int, dict], path: str):
    """images: {id: {'qvec' [4], 'tvec' [3], 'camera_id', 'name',
    'xys' [N,2], 'point3D_ids' [N]}}."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in images.items():
            f.write(struct.pack("<i", iid))
            f.write(np.asarray(im["qvec"], np.float64).tobytes())
            f.write(np.asarray(im["tvec"], np.float64).tobytes())
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            xys = np.asarray(im.get("xys", np.zeros((0, 2))), np.float64)
            ids = np.asarray(im.get("point3D_ids", np.zeros(0)), np.int64)
            f.write(struct.pack("<Q", len(xys)))
            # COLMAP stores (x, y, point3D_id) with the id as int64
            buf = b"".join(struct.pack("<ddq", x, y, int(i))
                           for (x, y), i in zip(xys, ids))
            f.write(buf)


def read_images_binary(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (iid,) = struct.unpack("<i", f.read(4))
            qvec = np.frombuffer(f.read(32), np.float64)
            tvec = np.frombuffer(f.read(24), np.float64)
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (npts,) = struct.unpack("<Q", f.read(8))
            xys = np.zeros((npts, 2))
            ids = np.zeros(npts, np.int64)
            for k in range(npts):
                x, y, pid = struct.unpack("<ddq", f.read(24))
                xys[k] = (x, y)
                ids[k] = pid
            out[iid] = {"qvec": qvec, "tvec": tvec, "camera_id": cam_id,
                        "name": name.decode(), "xys": xys,
                        "point3D_ids": ids}
    return out


def write_points3d_binary(points: Dict[int, dict], path: str):
    """points: {id: {'xyz' [3], 'rgb' [3], 'error', 'track' [(img, kp)...]}}."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, p in points.items():
            f.write(struct.pack("<Q", pid))
            f.write(np.asarray(p["xyz"], np.float64).tobytes())
            f.write(np.asarray(p.get("rgb", [0, 0, 0]), np.uint8).tobytes())
            f.write(struct.pack("<d", p.get("error", 0.0)))
            track = p.get("track", [])
            f.write(struct.pack("<Q", len(track)))
            for (img_id, kp_id) in track:
                f.write(struct.pack("<ii", img_id, kp_id))


def read_points3d_binary(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (pid,) = struct.unpack("<Q", f.read(8))
            xyz = np.frombuffer(f.read(24), np.float64)
            rgb = np.frombuffer(f.read(3), np.uint8)
            (err,) = struct.unpack("<d", f.read(8))
            (tlen,) = struct.unpack("<Q", f.read(8))
            track = [struct.unpack("<ii", f.read(8)) for _ in range(tlen)]
            out[pid] = {"xyz": xyz, "rgb": rgb, "error": err, "track": track}
    return out


# ----------------------------------------------------------- text model IO

CAMERA_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}
CAMERA_MODEL_IDS = {v: k for k, v in CAMERA_MODEL_NAMES.items()}


def camera_K(cam: dict) -> np.ndarray:
    """3x3 intrinsics from a COLMAP camera dict (distortion ignored — the
    matcher operates on undistorted/benchmark pixels)."""
    p = np.asarray(cam["params"], np.float64)
    mid = cam["model_id"]
    name = CAMERA_MODEL_NAMES[mid]
    if name == "PINHOLE" or name == "OPENCV" or name == "FULL_OPENCV" \
            or name == "OPENCV_FISHEYE" or name == "THIN_PRISM_FISHEYE":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    else:  # SIMPLE_* / RADIAL / FOV: single focal
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def write_cameras_text(cameras: Dict[int, dict], path: str):
    """COLMAP cameras.txt (read_write_model.py text-writer format)."""
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cid, c in cameras.items():
            params = " ".join(repr(float(x)) for x in c["params"])
            f.write(f"{cid} {CAMERA_MODEL_NAMES[c['model_id']]} "
                    f"{c['width']} {c['height']} {params}\n")


def read_cameras_text(path: str) -> Dict[int, dict]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            out[int(el[0])] = {
                "model_id": CAMERA_MODEL_IDS[el[1]],
                "width": int(el[2]), "height": int(el[3]),
                "params": np.array(el[4:], np.float64),
            }
    return out


def write_images_text(images: Dict[int, dict], path: str):
    """COLMAP images.txt: two lines per image (pose line + observation
    line of x y point3D_id triples)."""
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for iid, im in images.items():
            q = " ".join(repr(float(x)) for x in im["qvec"])
            t = " ".join(repr(float(x)) for x in im["tvec"])
            f.write(f"{iid} {q} {t} {im['camera_id']} {im['name']}\n")
            xys = np.asarray(im.get("xys", np.zeros((0, 2))))
            ids = np.asarray(im.get("point3D_ids", np.zeros(0)), np.int64)
            f.write(" ".join(
                f"{repr(float(x))} {repr(float(y))} {int(i)}"
                for (x, y), i in zip(xys, ids)) + "\n")


def read_images_text(path: str) -> Dict[int, dict]:
    out = {}
    with open(path) as f:
        # keep empty lines: images without observations write a blank
        # second line, and dropping it would shift the pose/obs pairing
        lines = [l.rstrip("\n").strip() for l in f
                 if not l.startswith("#")]
    for pose_line, obs_line in zip(lines[0::2], lines[1::2]):
        el = pose_line.split()
        iid = int(el[0])
        obs = obs_line.split()
        xys = np.array([obs[0::3], obs[1::3]], np.float64).T \
            if obs else np.zeros((0, 2))
        ids = np.array(obs[2::3], np.int64) if obs else np.zeros(0, np.int64)
        out[iid] = {
            "qvec": np.array(el[1:5], np.float64),
            "tvec": np.array(el[5:8], np.float64),
            "camera_id": int(el[8]), "name": el[9],
            "xys": xys, "point3D_ids": ids,
        }
    return out


def write_points3d_text(points: Dict[int, dict], path: str):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}\n")
        for pid, p in points.items():
            xyz = " ".join(repr(float(x)) for x in p["xyz"])
            rgb = " ".join(str(int(x)) for x in p.get("rgb", (0, 0, 0)))
            track = " ".join(f"{int(i)} {int(k)}"
                             for i, k in p.get("track", []))
            f.write(f"{pid} {xyz} {rgb} {repr(float(p.get('error', 0.0)))}"
                    f" {track}\n".rstrip() + "\n")


def read_points3d_text(path: str) -> Dict[int, dict]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            track = np.array(el[8:], np.int64).reshape(-1, 2)
            out[pid] = {
                "xyz": np.array(el[1:4], np.float64),
                "rgb": np.array(el[4:7], np.uint8),
                "error": float(el[7]),
                "track": [tuple(t) for t in track],
            }
    return out


def read_model(model_dir: str, ext: str = ".bin"):
    """(cameras, images, points3d) from a COLMAP model directory."""
    import os

    j = lambda n: os.path.join(model_dir, n + ext)  # noqa: E731
    if ext == ".bin":
        return (read_cameras_binary(j("cameras")),
                read_images_binary(j("images")),
                read_points3d_binary(j("points3D")))
    return (read_cameras_text(j("cameras")), read_images_text(j("images")),
            read_points3d_text(j("points3D")))


def write_model(cameras, images, points3d, model_dir: str,
                ext: str = ".bin"):
    import os

    os.makedirs(model_dir, exist_ok=True)
    j = lambda n: os.path.join(model_dir, n + ext)  # noqa: E731
    if ext == ".bin":
        write_cameras_binary(cameras, j("cameras"))
        write_images_binary(images, j("images"))
        write_points3d_binary(points3d, j("points3D"))
    else:
        write_cameras_text(cameras, j("cameras"))
        write_images_text(images, j("images"))
        write_points3d_text(points3d, j("points3D"))


# ------------------------------------------------------- keypoint merging

def quantize_keypoints(fpts: np.ndarray, kp_data: dict, psize: int = 48,
                       dthres: float = 4.0) -> List[int]:
    """Merge nearby match endpoints into shared keypoint ids
    (localize_sfm_helper.py:173-215 semantics): the image is gridded into
    psize cells; points within a cell closer than dthres to an existing
    center merge into it (running mean), otherwise become new keypoints.

    kp_data: {'kps': list of points, 'kp_means': {cell: {'means', 'kids'}}}.
    Returns the keypoint id for each input point.
    """
    fpt_ids = []
    cpts = (np.asarray(fpts) // psize * psize).astype(np.int64)
    for cpt, fpt in zip(cpts, np.asarray(fpts, np.float64)):
        cell = tuple(cpt)
        kps = kp_data["kps"]
        kp_dict = kp_data["kp_means"]
        if cell not in kp_dict:
            kid = len(kps)
            kps.append(fpt)
            kp_dict[cell] = {"means": [fpt], "kids": [kid]}
        else:
            entry = kp_dict[cell]
            centers = entry["means"]
            dist = np.linalg.norm(fpt - np.asarray(centers), axis=1)
            cid = int(np.argmin(dist))
            if dist[cid] < dthres:
                centers[cid] = (centers[cid] + fpt) / 2
                kid = entry["kids"][cid]
                kps[kid] = centers[cid]
            else:
                kid = len(kps)
                kps.append(fpt)
                centers.append(fpt)
                entry["kids"].append(kid)
        fpt_ids.append(kid)
    return fpt_ids
