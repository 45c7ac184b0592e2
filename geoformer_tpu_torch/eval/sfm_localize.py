"""Visual-localization back half: NVM parsing, empty-model construction,
covisibility pairs, triangulation and query localization.

Counterpart of geoformer_tpu/eval/sfm_localize.py (the reference's
hloc/COLMAP-delegating pipeline, eval_tool/immatch/utils/colmap/
data_parsing.py:57-257 and localize_sfm_helper.py:64-139): model files go
through eval/colmap_io, triangulation is a multi-view DLT on the host
(numpy), and query poses come from the PnP RANSAC of engine/pnp.py on the
caller's device. The output is a benchmark pose file (`name qw qx qy qz
tx ty tz`, the Aachen/RobotCar submission format).

JAX splits its key once per query; here one torch.Generator seeded with
``seed`` on the device draws every query's samples in turn, and a caller
may inject a query's samples instead (``sample_idx``).
"""

from __future__ import annotations

import os
import sqlite3
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from geoformer_tpu_torch.eval.colmap_io import (
    CAMERA_MODEL_IDS,
    camera_K,
    write_model,
)

# ------------------------------------------------------------- quaternions


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP/NVM (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), w >= 0."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q if q[0] >= 0 else -q


# ---------------------------------------------------------------- NVM files


def parse_nvm(path: str):
    """Parse an NVM_V3 reconstruction.

    Mirrors load_images_from_nvm + the point pass of covis_pairs_from_nvm
    (reference: colmap/data_parsing.py:57-80,161-196). NVM stores the
    world->cam quaternion and the camera CENTER; COLMAP tvec = -R @ center.

    Returns:
        image_names: [N] in file order (ids used by point tracks).
        images: {name: {'qvec' [4], 'tvec' [3]}}.
        points: list of {'xyz' [3], 'rgb' [3],
                         'track': [(im_id, feat_id, u, v), ...]}.
    """
    image_names: List[str] = []
    images: Dict[str, dict] = {}
    points: List[dict] = []
    with open(path) as f:
        line = next(f)
        while line == "\n" or line.startswith("NVM_V3"):
            line = next(f)
        n_images = int(line.split()[0])
        for _ in range(n_images):
            data = next(f).split()
            name = data[0]
            qvec = np.array(data[2:6], np.float64)
            center = np.array(data[6:9], np.float64)
            tvec = -qvec2rotmat(qvec) @ center
            image_names.append(name)
            images[name] = {"qvec": qvec, "tvec": tvec,
                            "focal": float(data[1])}
        line = next(f)
        while line == "\n":
            line = next(f)
        n_points = int(line.split()[0])
        for _ in range(n_points):
            data = next(f).split()
            xyz = np.array(data[0:3], np.float64)
            rgb = np.array(data[3:6], np.uint8)
            n_meas = int(data[6])
            track = []
            for j in range(n_meas):
                im_id = int(data[7 + j * 4])
                feat_id = int(data[8 + j * 4])
                u = float(data[9 + j * 4])
                v = float(data[10 + j * 4])
                track.append((im_id, feat_id, u, v))
            points.append({"xyz": xyz, "rgb": rgb, "track": track})
    return image_names, images, points


def covis_pairs_from_nvm(path: str, topk: int = 20,
                         out_txt: Optional[str] = None
                         ) -> List[Tuple[str, str]]:
    """Top-k covisibility pairs by shared-3D-point count
    (data_parsing.py:161-225 semantics, incl. the name normalization)."""
    image_names, _, points = parse_nvm(path)
    image_names = [n.lstrip("./").replace("png", "jpg")
                   for n in image_names]
    im_to_pts = defaultdict(list)
    for pid, p in enumerate(points):
        for (im_id, *_rest) in p["track"]:
            im_to_pts[im_id].append(pid)
    pt_to_ims = defaultdict(list)
    for im_id, pids in im_to_pts.items():
        for pid in pids:
            pt_to_ims[pid].append(im_id)

    pairs = []
    for im_id, name in enumerate(image_names):
        covis = defaultdict(int)
        for pid in im_to_pts.get(im_id, ()):
            for other in pt_to_ims[pid]:
                if other != im_id:
                    covis[other] += 1
        if not covis:
            continue
        ranked = sorted(covis, key=lambda i: -covis[i])[:topk]
        pairs.extend((name, image_names[i]) for i in ranked)
    if out_txt:
        os.makedirs(os.path.dirname(out_txt) or ".", exist_ok=True)
        with open(out_txt, "w") as f:
            for a, b in pairs:
                f.write(f"{a} {b}\n")
    return pairs


def covis_pairs_from_model(images: Dict[int, dict],
                           points3d: Dict[int, dict], topk: int = 20,
                           out_txt: Optional[str] = None
                           ) -> List[Tuple[str, str]]:
    """Top-k covisibility pairs from a triangulated COLMAP model
    (data_parsing.py:226-257 covis_pairs_from_reference_model) — the
    Aachen v1.1 flow, where a binary model replaces the NVM."""
    pt_to_ims = {pid: [iid for iid, _ in p.get("track", [])]
                 for pid, p in points3d.items()}
    pairs = []
    for iid, im in images.items():
        covis = defaultdict(int)
        for pid in np.asarray(im.get("point3D_ids", ())):
            if int(pid) < 0:
                continue
            for other in pt_to_ims.get(int(pid), ()):
                if other != iid:
                    covis[other] += 1
        if not covis:
            continue
        ranked = sorted(covis, key=lambda i: -covis[i])[:topk]
        pairs.extend((im["name"], images[i]["name"]) for i in ranked)
    if out_txt:
        os.makedirs(os.path.dirname(out_txt) or ".", exist_ok=True)
        with open(out_txt, "w") as f:
            for a, b in pairs:
                f.write(f"{a} {b}\n")
    return pairs


def create_empty_model_from_reference_model(ref_dir: str, out_dir: str,
                                            ext: str = ".bin"):
    """Strip observations from an existing model: posed images + cameras,
    zero points (data_parsing.py:81-99) — triangulation seed for v1.1."""
    from geoformer_tpu_torch.eval.colmap_io import read_model

    cameras, images, _ = read_model(ref_dir, ext)
    for im in images.values():
        im["xys"] = np.zeros((0, 2))
        im["point3D_ids"] = np.zeros(0, np.int64)
    write_model(cameras, images, {}, out_dir, ext)
    return cameras, images


# --------------------------------------------------- database-side parsing


def load_ids_from_database(db_path: str):
    """{name: image_id}, {name: camera_id} from a COLMAP database
    (data_parsing.py load_ids_from_database equivalent)."""
    conn = sqlite3.connect(db_path)
    rows = conn.execute(
        "SELECT name, image_id, camera_id FROM images").fetchall()
    conn.close()
    image_ids = {n: i for n, i, _ in rows}
    camera_ids = {n: c for n, _, c in rows}
    return image_ids, camera_ids


def load_cameras_from_database(db_path: str) -> Dict[int, dict]:
    conn = sqlite3.connect(db_path)
    rows = conn.execute(
        "SELECT camera_id, model, width, height, params FROM cameras"
    ).fetchall()
    conn.close()
    return {cid: {"model_id": model, "width": w, "height": h,
                  "params": np.frombuffer(params, np.float64)}
            for cid, model, w, h, params in rows}


def _iter_intrinsics_lines(path: str):
    """Yield (name, camera_dict) per `name MODEL w h params...` line — the
    Aachen intrinsics/queries text format shared by database_intrinsics.txt
    and the query lists."""
    with open(path) as f:
        for line in f:
            el = line.split()
            if not el:
                continue
            yield el[0], {
                "model_id": CAMERA_MODEL_IDS[el[1]],
                "width": int(el[2]), "height": int(el[3]),
                "params": np.array(el[4:], np.float64),
            }


def load_cameras_from_intrinsics_txt(path: str, camera_ids: Dict[str, int]
                                     ) -> Dict[int, dict]:
    """Aachen database_intrinsics.txt keyed by db camera id
    (data_parsing.py load_cameras_from_intrinsics_and_ids equivalent)."""
    return {camera_ids[name]: cam
            for name, cam in _iter_intrinsics_lines(path)
            if name in camera_ids}


def create_empty_model_from_nvm_and_database(
        nvm_path: str, db_path: str, out_dir: str,
        intrinsics_txt: Optional[str] = None, ext: str = ".bin"):
    """Posed images (from NVM) + cameras (from db / intrinsics txt) + zero
    points — the triangulation seed model (data_parsing.py:102-137)."""
    _, nvm_images, _ = parse_nvm(nvm_path)
    image_ids, camera_ids = load_ids_from_database(db_path)
    images = {}
    for raw_name, im in nvm_images.items():
        name = raw_name.lstrip("./")
        if name not in image_ids:
            continue
        images[image_ids[name]] = {
            "qvec": im["qvec"], "tvec": im["tvec"],
            "camera_id": camera_ids[name],
            "name": name.replace("png", "jpg"),  # RobotCar normalization
            "xys": np.zeros((0, 2)),
            "point3D_ids": np.zeros(0, np.int64),
        }
    if intrinsics_txt and os.path.exists(intrinsics_txt):
        cameras = load_cameras_from_intrinsics_txt(intrinsics_txt, camera_ids)
    else:
        cameras = load_cameras_from_database(db_path)
    write_model(cameras, images, {}, out_dir, ext)
    return cameras, images


# -------------------------------------------------- native triangulation


def _pose_mat(im: dict) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = qvec2rotmat(im["qvec"])
    T[:3, 3] = np.asarray(im["tvec"], np.float64)
    return T


def _triangulate_track_np(Ps: np.ndarray, uvs: np.ndarray) -> np.ndarray:
    """Multi-view linear triangulation: stack 2 rows per observation."""
    A = np.concatenate([
        np.stack([uv[0] * P[2] - P[0], uv[1] * P[2] - P[1]])
        for P, uv in zip(Ps, uvs)])
    _, _, vt = np.linalg.svd(A)
    X = vt[-1]
    return X[:3] / (X[3] if abs(X[3]) > 1e-12 else 1e-12)


def triangulate_model(
    cameras: Dict[int, dict],
    images: Dict[int, dict],
    keypoints: Dict[str, np.ndarray],
    matches_ids: Dict[Tuple[str, str], np.ndarray],
    max_reproj_px: float = 4.0,
    min_track_len: int = 2,
):
    """Framework-native replacement for hloc/COLMAP triangulation
    (reconstruct_database_pairs, localize_sfm_helper.py:99-115): link match
    ids into multi-image tracks (union-find), DLT-triangulate each track
    against the posed empty model, filter by cheirality + reprojection, and
    fill images' xys/point3D_ids + a points3D dict.

    Returns (images, points3d) — images updated in place with observations.
    """
    name_to_iid = {im["name"]: iid for iid, im in images.items()}

    # union-find over (image name, kp id)
    parent: Dict[Tuple[str, int], Tuple[str, int]] = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for (n0, n1), m in matches_ids.items():
        if n0 not in name_to_iid or n1 not in name_to_iid:
            continue
        for k0, k1 in np.asarray(m):
            union((n0, int(k0)), (n1, int(k1)))

    groups = defaultdict(list)
    for obs in parent:
        groups[find(obs)].append(obs)

    # per-image observation registration
    obs_lists: Dict[int, list] = {iid: [] for iid in images}
    points3d: Dict[int, dict] = {}
    pid = 1
    for track in groups.values():
        # one observation per image (first wins), need >= min_track_len views
        per_im = {}
        for (name, kid) in track:
            per_im.setdefault(name, kid)
        if len(per_im) < min_track_len:
            continue
        Ps, uvs, obs = [], [], []
        for name, kid in per_im.items():
            iid = name_to_iid[name]
            im = images[iid]
            K = camera_K(cameras[im["camera_id"]])
            kps = keypoints[name]
            if kid >= len(kps):
                continue
            T = _pose_mat(im)
            Ps.append(K @ T[:3, :])
            uvs.append(np.asarray(kps[kid], np.float64))
            obs.append((iid, T, K, kid))
        if len(Ps) < min_track_len:
            continue
        X = _triangulate_track_np(np.asarray(Ps), np.asarray(uvs))
        if not np.isfinite(X).all():
            continue
        # cheirality + reprojection gate in every view
        ok = True
        for (_, T, K, _), uv in zip(obs, uvs):
            pc = T[:3, :3] @ X + T[:3, 3]
            if pc[2] <= 1e-6:
                ok = False
                break
            proj = (K @ pc)[:2] / pc[2]
            if np.linalg.norm(proj - uv) > max_reproj_px:
                ok = False
                break
        if not ok:
            continue
        tr = []
        for (iid, _, _, kid), uv in zip(obs, uvs):
            tr.append((iid, len(obs_lists[iid])))
            obs_lists[iid].append((uv, pid))
        points3d[pid] = {"xyz": X, "rgb": np.zeros(3, np.uint8),
                         "error": 0.0, "track": tr}
        pid += 1

    for iid, lst in obs_lists.items():
        if lst:
            images[iid]["xys"] = np.asarray([uv for uv, _ in lst])
            images[iid]["point3D_ids"] = np.asarray(
                [p for _, p in lst], np.int64)
        else:
            images[iid]["xys"] = np.zeros((0, 2))
            images[iid]["point3D_ids"] = np.zeros(0, np.int64)
    return images, points3d


# ------------------------------------------------------ query localization


def parse_queries_with_intrinsics(path: str) -> Dict[str, dict]:
    """`name MODEL w h params...` per line (Aachen queries format)."""
    return dict(_iter_intrinsics_lines(path))


def pnp_pose(uvs, xyzs, K: np.ndarray, capacity: int, ransac_thr_px: float,
             device, generator: Optional[torch.Generator] = None,
             sample_idx: Optional[np.ndarray] = None) -> dict:
    """PnP RANSAC of one query's 2D-3D matches (the first ``capacity``),
    padded to ``capacity`` in f32 on ``device``: {'qvec', 'tvec',
    'num_inliers', 'ok'} (world->cam). ``sample_idx`` ([256, 6] indices
    into the padded points) replaces the generator's draws."""
    from geoformer_tpu_torch.engine.pnp import pnp_ransac

    uv = np.zeros((capacity, 2), np.float32)
    xyz = np.zeros((capacity, 3), np.float32)
    valid = np.zeros(capacity, bool)
    n = min(len(uvs), capacity)
    uv[:n] = np.asarray(uvs)[:n]
    xyz[:n] = np.asarray(xyzs)[:n]
    valid[:n] = True
    device = torch.device(device)
    idx = None if sample_idx is None else torch.as_tensor(
        np.asarray(sample_idx), dtype=torch.long, device=device)
    fit = pnp_ransac(torch.from_numpy(xyz).to(device),
                     torch.from_numpy(uv).to(device),
                     torch.from_numpy(K.astype(np.float32)).to(device),
                     torch.from_numpy(valid).to(device),
                     thr_px=ransac_thr_px, sample_idx=idx,
                     generator=generator)
    T = fit["T"].cpu().numpy().astype(np.float64)
    return {"qvec": rotmat2qvec(T[:3, :3]), "tvec": T[:3, 3],
            "num_inliers": int(fit["num_inliers"]), "ok": bool(fit["ok"])}


def localize_queries(
    cameras: Dict[int, dict],
    images: Dict[int, dict],
    points3d: Dict[int, dict],
    query_cams: Dict[str, dict],
    query_matches: Dict[str, Dict[str, np.ndarray]],
    ransac_thr_px: float = 12.0,
    snap_px: float = 4.0,
    capacity: int = 2048,
    seed: int = 0,
    device="cuda",
    sample_idx: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, dict]:
    """Localize each query by 2D-3D PnP RANSAC on ``device``
    (localize_sfm_helper.py:117-139).

    query_matches: {qname: {db_name: [N, 4] (xq, yq, xdb, ydb)}}; db
    endpoints snap to the db image's registered keypoints (within snap_px)
    to pick up their 3D points. sample_idx: optional {qname: [256, 6]}
    PnP samples in place of the generator's.

    Returns {qname: {'qvec', 'tvec', 'num_inliers', 'ok'}}.
    """
    name_to_iid = {im["name"]: iid for iid, im in images.items()}
    results = {}
    gen = torch.Generator(device).manual_seed(seed)
    for qname, per_db in query_matches.items():
        uvs, xyzs = [], []
        for db_name, m in per_db.items():
            iid = name_to_iid.get(db_name)
            if iid is None or len(m) == 0:
                continue
            im = images[iid]
            xys = np.asarray(im["xys"])
            pids = np.asarray(im["point3D_ids"])
            if len(xys) == 0:
                continue
            m = np.asarray(m)
            # nearest registered keypoint per db endpoint
            d = np.linalg.norm(m[:, None, 2:4] - xys[None], axis=-1)
            nn = d.argmin(1)
            keep = d[np.arange(len(m)), nn] < snap_px
            for qi, ki in zip(np.where(keep)[0], nn[keep]):
                pid = int(pids[ki])
                if pid in points3d:
                    uvs.append(m[qi, :2])
                    xyzs.append(points3d[pid]["xyz"])
        if len(uvs) < 6:
            results[qname] = {"qvec": np.array([1, 0, 0, 0.0]),
                              "tvec": np.zeros(3), "num_inliers": 0,
                              "ok": False}
            continue
        results[qname] = pnp_pose(
            uvs, xyzs, camera_K(query_cams[qname]), capacity, ransac_thr_px,
            device, gen, (sample_idx or {}).get(qname))
    return results


def write_pose_file(poses: Dict[str, dict], path: str,
                    basename_only: bool = True):
    """Benchmark submission format: `name qw qx qy qz tx ty tz` per query
    (the format hloc's localize_sfm emits for Aachen/RobotCar)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for name, p in poses.items():
            n = os.path.basename(name) if basename_only else name
            q = " ".join(f"{x:.8f}" for x in p["qvec"])
            t = " ".join(f"{x:.8f}" for x in p["tvec"])
            f.write(f"{n} {q} {t}\n")
