"""Visual-localization export pipeline (Aachen/RobotCar/InLoc-style).

Counterpart of geoformer_tpu/eval/localization.py, the match-export half
of the reference's localize_sfm_helper (eval_tool/immatch/utils/
localize_sfm_helper.py:28-139): match endpoints merged into quantized
keypoints, hloc-layout HDF5 features and matches (written by the port's
data/hdf5.py: no h5py), and a COLMAP database.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

from geoformer_tpu_torch.data.hdf5 import write_datasets
from geoformer_tpu_torch.eval.colmap_io import (
    ColmapDatabase,
    quantize_keypoints,
)


def names_to_pair(n0: str, n1: str) -> str:
    """hloc pair naming convention."""
    return "_".join((n0.replace("/", "-"), n1.replace("/", "-")))


def collect_quantized_matches(
    pair_matches: Dict[Tuple[str, str], np.ndarray],
    psize: int = 48,
    dthres: float = 4.0,
):
    """Merge per-pair match endpoints into per-image keypoint sets.

    Args:
        pair_matches: {(name0, name1): matches [N, 4] (x0, y0, x1, y1)}.
    Returns:
        (keypoints: {name: [K, 2] float32},
         matches_ids: {(name0, name1): [N, 2] int32 keypoint-id pairs}).
    """
    kp_data: Dict[str, dict] = defaultdict(
        lambda: {"kps": [], "kp_means": {}})
    matches_ids = {}
    for (n0, n1), m in pair_matches.items():
        if len(m) == 0:
            matches_ids[(n0, n1)] = np.zeros((0, 2), np.int32)
            continue
        ids0 = quantize_keypoints(m[:, :2], kp_data[n0], psize, dthres)
        ids1 = quantize_keypoints(m[:, 2:4], kp_data[n1], psize, dthres)
        matches_ids[(n0, n1)] = np.stack(
            [np.asarray(ids0), np.asarray(ids1)], -1).astype(np.int32)
    keypoints = {n: np.asarray(d["kps"], np.float32).reshape(-1, 2)
                 for n, d in kp_data.items()}
    return keypoints, matches_ids


def export_h5(keypoints: Dict[str, np.ndarray],
              matches_ids: Dict[Tuple[str, str], np.ndarray],
              feature_path: str, match_path: str):
    """hloc-layout HDF5 export (features: <name>/keypoints and
    <name>/scores; matches: <pair>/matches0, the per-keypoint assignment,
    int32, -1 where unmatched); a / in an image name makes nested groups,
    as h5py's create_group does."""
    features = {}
    for name, kps in keypoints.items():
        features[f"{name}/keypoints"] = kps
        features[f"{name}/scores"] = np.ones(len(kps), np.float32)
    write_datasets(feature_path, features)

    matches = {}
    for (n0, n1), ids in matches_ids.items():
        m0 = np.full(len(keypoints.get(n0, ())), -1, np.int32)
        if len(ids):
            m0[ids[:, 0]] = ids[:, 1]
        matches[f"{names_to_pair(n0, n1)}/matches0"] = m0
    write_datasets(match_path, matches)


def build_colmap_database(
    db_path: str,
    images: Dict[str, dict],
    keypoints: Dict[str, np.ndarray],
    matches_ids: Dict[Tuple[str, str], np.ndarray],
    camera_model: int = 2,  # SIMPLE_RADIAL
):
    """Populate a COLMAP database with cameras, images, quantized keypoints
    and raw matches (localize_sfm_helper.py:64-109 equivalent).

    images: {name: {'width', 'height', 'params'}}.
    Returns {name: image_id}.
    """
    if os.path.exists(db_path):
        os.remove(db_path)
    db = ColmapDatabase(db_path)
    ids = {}
    for name, meta in images.items():
        cam = db.add_camera(camera_model, meta["width"], meta["height"],
                            meta["params"])
        iid = db.add_image(name, cam)
        ids[name] = iid
        kps = keypoints.get(name, np.zeros((0, 2), np.float32))
        db.add_keypoints(iid, kps + 0.5)  # COLMAP pixel-center convention
    for (n0, n1), m in matches_ids.items():
        if len(m):
            db.add_matches(ids[n0], ids[n1], m.astype(np.uint32))
            db.add_two_view_geometry(ids[n0], ids[n1], m.astype(np.uint32))
    db.close()
    return ids
