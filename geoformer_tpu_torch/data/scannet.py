"""ScanNet depth-supervised dataset reader (host-side numpy).

Counterpart of geoformer_tpu/data/scannet.py: npz name/overlap lists,
640x480 grey images, depth PNGs / 1000, pose text files as world->cam
inverses, fixed intrinsics per scene. The port reads the colour JPEGs to
grey with its own decoder (eval/jpeg.py, the Y component as
``cv2.IMREAD_GRAYSCALE`` gives it), resizes as cv2's INTER_LINEAR
(ops/resize.resize_linear_u8) and reads the 16-bit depth PNGs as
``cv2.IMREAD_UNCHANGED`` does (eval/image_io.read_unchanged).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np

from geoformer_tpu_torch.eval.image_io import read_gray, read_unchanged
from geoformer_tpu_torch.ops.resize import resize_linear_u8


def _read_gray(path: str, wh=(640, 480)) -> np.ndarray:
    im = resize_linear_u8(read_gray(path), (wh[1], wh[0]))
    return im.astype(np.float32) / 255.0


def _read_depth(path: str) -> np.ndarray:
    return read_unchanged(path).astype(np.float32) / 1000.0


def _read_pose(path: str) -> np.ndarray:
    cam2world = np.loadtxt(path, dtype=np.float64)
    return np.linalg.inv(cam2world).astype(np.float32)  # world->cam


class ScanNetDataset:
    """npz index with (name [N,4], score) entries over scene frame pairs."""

    def __init__(self, root_dir: str, npz_path: str, intrinsic_path: str,
                 min_overlap_score: float = 0.4, mode: str = "train"):
        self.root = root_dir
        data = np.load(npz_path)
        names = data["name"]
        if "score" in data:
            keep = data["score"] > min_overlap_score
            names = names[keep]
        self.names = names
        self.intrinsics = dict(np.load(intrinsic_path)) \
            if intrinsic_path else {}
        self.mode = mode

    def __len__(self):
        return len(self.names)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        scene, sub, f0, f1 = self.names[idx]
        scene_name = f"scene{int(scene):04d}_{int(sub):02d}"
        sdir = os.path.join(self.root, self.mode, scene_name)
        img0 = _read_gray(os.path.join(sdir, "color", f"{f0}.jpg"))
        img1 = _read_gray(os.path.join(sdir, "color", f"{f1}.jpg"))
        depth0 = _read_depth(os.path.join(sdir, "depth", f"{f0}.png"))
        depth1 = _read_depth(os.path.join(sdir, "depth", f"{f1}.png"))
        T0 = _read_pose(os.path.join(sdir, "pose", f"{f0}.txt"))
        T1 = _read_pose(os.path.join(sdir, "pose", f"{f1}.txt"))
        T_0to1 = (T1 @ np.linalg.inv(T0)).astype(np.float32)
        K = np.asarray(self.intrinsics[scene_name],
                       np.float32).reshape(3, 3) \
            if scene_name in self.intrinsics else np.eye(3, dtype=np.float32)
        return {
            "image0": img0[..., None], "image1": img1[..., None],
            "depth0": depth0, "depth1": depth1,
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "K0": K, "K1": K,
        }


def batch_stream(ds: ScanNetDataset, batch: int, seed: int = 66
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches of ``batch`` pairs drawn uniformly with replacement
    from ``seed``."""
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(ds), batch)
        samples = [ds.get(int(i)) for i in idx]
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
