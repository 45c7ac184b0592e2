"""InLoc-style dense-depth localization.

Counterpart of geoformer_tpu/eval/inloc.py (the algorithm the reference's
eval_tool/immatch/eval_inloc.py:1-31 names through an absent hloc
submodule): each query is matched against RGB-D database images; the
matched db keypoints are unprojected through the db image's dense depth
into world points (no SfM model), and the query pose comes from PnP
RANSAC over the accumulated 2D-3D set, on the caller's device, with the
draws of eval/sfm_localize.localize_queries (one generator seeded with
``seed``, or injected per query). Depth maps are npz arrays (InLoc's .mat
scans convert offline); the output composes with
sfm_localize.write_pose_file.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def unproject_depth(
    uv: np.ndarray,
    depth: np.ndarray,
    K: np.ndarray,
    T_w2c: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lift 2D db-image points to 3D world points through a dense depth map.

    Args:
        uv: [N, 2] (x, y) pixel coordinates in the db image.
        depth: [H, W] metric depth (0 / non-finite = invalid), in the db
            camera frame.
        K: [3, 3] db intrinsics.
        T_w2c: [4, 4] world->camera pose of the db image.
    Returns:
        (xyz_world [N, 3], valid [N]) — nearest-pixel depth lookup with a
        validity check (inside image, finite positive depth).
    """
    h, w = depth.shape
    u = np.round(uv[:, 0]).astype(np.int64)
    v = np.round(uv[:, 1]).astype(np.int64)
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc = np.clip(u, 0, w - 1)
    vc = np.clip(v, 0, h - 1)
    d = depth[vc, uc]
    valid = inside & np.isfinite(d) & (d > 0)
    ray = np.linalg.solve(
        K, np.concatenate([uv, np.ones((len(uv), 1))], 1).T).T   # [N, 3]
    X_cam = ray * d[:, None]
    R, t = T_w2c[:3, :3], T_w2c[:3, 3]
    X_world = (X_cam - t) @ R           # R^T (X - t), row-vector form
    return X_world, valid


def localize_queries_dense(
    query_cams: Dict[str, dict],
    query_matches: Dict[str, Dict[str, np.ndarray]],
    db_scans: Dict[str, dict],
    ransac_thr_px: float = 12.0,
    min_matches: int = 6,
    capacity: int = 4096,
    seed: int = 0,
    device="cuda",
    sample_idx: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, dict]:
    """InLoc-style localization: PnP on depth-unprojected db matches.

    Args:
        query_cams: {qname: camera dict (model_id/width/height/params, as
            parse_queries_with_intrinsics returns)}.
        query_matches: {qname: {db_name: [N, 4] (xq, yq, xdb, ydb)}}.
        db_scans: {db_name: {'depth': [H, W], 'K': [3, 3], 'T_w2c': [4, 4]}}.
        sample_idx: optional {qname: [256, 6]} PnP samples.
    Returns:
        {qname: {'qvec', 'tvec', 'num_inliers', 'ok'}} (world->cam), the
        same contract as sfm_localize.localize_queries.
    """
    from geoformer_tpu_torch.eval.colmap_io import camera_K
    from geoformer_tpu_torch.eval.sfm_localize import pnp_pose

    results: Dict[str, dict] = {}
    gen = torch.Generator(device).manual_seed(seed)
    for qname, per_db in query_matches.items():
        uvs, xyzs = [], []
        for db_name, m in per_db.items():
            scan = db_scans.get(db_name)
            if scan is None or len(m) == 0:
                continue
            m = np.asarray(m, np.float64)
            xyz, ok = unproject_depth(m[:, 2:4], np.asarray(scan["depth"]),
                                      np.asarray(scan["K"]),
                                      np.asarray(scan["T_w2c"]))
            uvs.append(m[ok, :2])
            xyzs.append(xyz[ok])
        n = sum(len(u) for u in uvs)
        if n < min_matches:
            results[qname] = {"qvec": np.array([1.0, 0, 0, 0]),
                              "tvec": np.zeros(3), "num_inliers": 0,
                              "ok": False}
            continue
        results[qname] = pnp_pose(
            np.concatenate(uvs), np.concatenate(xyzs),
            camera_K(query_cams[qname]), capacity, ransac_thr_px, device,
            gen, (sample_idx or {}).get(qname))
    return results


def load_db_scans(scan_dir: str, names, depth_key: str = "depth",
                  K_key: str = "K", T_key: str = "T_w2c") -> Dict[str, dict]:
    """Load {name: scan dict} from <scan_dir>/<image_name>.npz files.

    InLoc's .mat cutout scans convert to this layout offline (depth map +
    intrinsics + world->cam pose per database image).
    """
    import os

    out = {}
    for n in names:
        p = os.path.join(scan_dir, os.path.splitext(n)[0] + ".npz")
        if not os.path.exists(p):
            continue
        z = np.load(p)
        out[n] = {"depth": z[depth_key], "K": z[K_key], "T_w2c": z[T_key]}
    return out
