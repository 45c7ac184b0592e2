"""End-to-end visual-localization driver (Aachen/RobotCar-style).

Counterpart of geoformer_tpu/eval/localize_driver.py, the reference's
pipeline shape (eval_aachen.py + localize_sfm_helper.py:28-139: posed
empty model -> match db pairs -> triangulate -> match query pairs ->
localize -> pose file) with the port's pieces: eval/sfm_localize for
parsing, triangulation and PnP (on ``device``), eval/localization for
keypoint quantization and the h5/db exports. The matcher is injectable
(name pair -> [N, 4] matches in original pixels); cli.py `localize` wires
BatchedMatcher.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from geoformer_tpu_torch.eval.colmap_io import write_model
from geoformer_tpu_torch.eval.localization import (
    build_colmap_database,
    collect_quantized_matches,
    export_h5,
)
from geoformer_tpu_torch.eval.sfm_localize import (
    covis_pairs_from_nvm,
    create_empty_model_from_nvm_and_database,
    localize_queries,
    triangulate_model,
    write_pose_file,
)


def load_pairs_txt(path: str) -> List[Tuple[str, str]]:
    with open(path) as f:
        return [tuple(l.split()[:2]) for l in f if l.strip()]


def run_localization(
    nvm_path: str,
    db_path: str,
    out_dir: str,
    match_pairs_fn: Callable[[str, str], np.ndarray],
    queries: Dict[str, dict],
    query_pairs: Sequence[Tuple[str, str]],
    db_pairs: Optional[Sequence[Tuple[str, str]]] = None,
    intrinsics_txt: Optional[str] = None,
    covis_topk: int = 20,
    quant_psize: int = 48,
    quant_dthres: float = 4.0,
    ransac_thr_px: float = 12.0,
    max_reproj_px: float = 4.0,
    log=print,
    device="cuda",
) -> Dict[str, dict]:
    """Full pipeline; returns {query_name: pose dict} and writes
    out_dir/poses.txt in the benchmark submission format."""
    os.makedirs(out_dir, exist_ok=True)

    # 1. posed empty model (NVM poses + database ids/intrinsics)
    cameras, images = create_empty_model_from_nvm_and_database(
        nvm_path, db_path, os.path.join(out_dir, "empty_sfm"),
        intrinsics_txt)
    log(f"empty model: {len(images)} images, {len(cameras)} cameras")

    # 2. db covisibility pairs
    if db_pairs is None:
        db_pairs = covis_pairs_from_nvm(
            nvm_path, covis_topk,
            os.path.join(out_dir, f"pairs-db-covis{covis_topk}.txt"))
    log(f"{len(db_pairs)} db pairs")

    # 3. match db pairs -> quantized keypoints + match ids -> h5/db export
    pair_matches = {}
    for (a, b) in db_pairs:
        if (a, b) in pair_matches or (b, a) in pair_matches:
            continue
        pair_matches[(a, b)] = np.asarray(match_pairs_fn(a, b))
    keypoints, matches_ids = collect_quantized_matches(
        pair_matches, psize=quant_psize, dthres=quant_dthres)
    export_h5(keypoints, matches_ids,
              os.path.join(out_dir, "keypoints.h5"),
              os.path.join(out_dir, "matches.h5"))
    db_meta = {
        im["name"]: {"width": cameras[im["camera_id"]]["width"],
                     "height": cameras[im["camera_id"]]["height"],
                     "params": cameras[im["camera_id"]]["params"]}
        for im in images.values() if im["name"] in keypoints}
    build_colmap_database(os.path.join(out_dir, "result.db"), db_meta,
                          keypoints, matches_ids)

    # 4. native triangulation against the posed model
    images, points3d = triangulate_model(
        cameras, images, keypoints, matches_ids,
        max_reproj_px=max_reproj_px)
    log(f"triangulated {len(points3d)} points")
    write_model(cameras, images, points3d,
                os.path.join(out_dir, "sfm_model"))

    # 5. match query pairs and localize
    query_matches: Dict[str, Dict[str, np.ndarray]] = {}
    for (q, dbname) in query_pairs:
        query_matches.setdefault(q, {})[dbname] = np.asarray(
            match_pairs_fn(q, dbname))
    poses = localize_queries(cameras, images, points3d, queries,
                             query_matches, ransac_thr_px=ransac_thr_px,
                             snap_px=quant_dthres + 1.0, device=device)
    n_ok = sum(p["ok"] for p in poses.values())
    log(f"localized {n_ok}/{len(poses)} queries")
    write_pose_file(poses, os.path.join(out_dir, "poses.txt"))
    return poses
