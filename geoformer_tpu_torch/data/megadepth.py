"""MegaDepth-layout posed-RGBD reader (host-side numpy).

Counterpart of geoformer_tpu/data/megadepth.py: per-scene npz index files
(pair_infos, image_paths, depth_paths, intrinsics, poses); grey images
resized longer edge to ``img_resize``, cut to a multiple of 8 and
zero-padded to a square, with a coarse padding mask (every 8th pixel);
HDF5 depth maps padded to depth_pad^2; relative pose T_0to1 = T1 @ T0^-1.
Images are decoded by eval/image_io.read_gray (PNG, PGM/PPM and JPEG,
equal to cv2.imread's grey) and resized by ops/resize.resize_linear_u8
(cv2.resize's INTER_LINEAR); depths are read by data/hdf5.read_dataset.
scene_balanced_stream draws from ``np.random.default_rng(seed)`` as the
JAX stream does, so both yield the same pairs in the same order.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from geoformer_tpu_torch.data.hdf5 import read_dataset
from geoformer_tpu_torch.eval.image_io import read_gray
from geoformer_tpu_torch.ops.resize import resize_linear_u8


def _read_gray_resized(path: str, resize: int, df: int = 8,
                       padding: bool = True):
    """(image [s, s] f32 in [0, 1], scale [2] = orig / resized (x, y),
    mask [s, s] bool) with s = ``resize``; unpadded without ``padding``."""
    im = read_gray(path)
    h, w = im.shape
    scale = resize / max(h, w)
    wn, hn = int(round(w * scale)), int(round(h * scale))
    wn, hn = (wn // df) * df, (hn // df) * df
    im = resize_linear_u8(im, (hn, wn))
    sc = np.array([w / wn, h / hn], np.float32)
    if padding:
        out = np.zeros((resize, resize), np.float32)
        out[:hn, :wn] = im.astype(np.float32) / 255.0
        mask = np.zeros((resize, resize), bool)
        mask[:hn, :wn] = True
        return out, sc, mask
    return im.astype(np.float32) / 255.0, sc, None


def _read_depth(path: str, pad_to: Optional[int] = 2000) -> np.ndarray:
    depth = np.asarray(read_dataset(path, "/depth"), np.float32)
    if pad_to:
        out = np.zeros((pad_to, pad_to), np.float32)
        h, w = depth.shape
        out[:h, :w] = depth[:pad_to, :pad_to]
        return out
    return depth


class MegaDepthScene:
    """One scene npz: its pairs with overlap above min_overlap_score, each
    loaded on request."""

    def __init__(self, npz_path: str, root_dir: str,
                 min_overlap_score: float = 0.4, img_resize: int = 640,
                 depth_pad: int = 2000, coarse_scale: int = 8):
        self.root = root_dir
        self.resize = img_resize
        self.depth_pad = depth_pad
        self.coarse_scale = coarse_scale
        data = np.load(npz_path, allow_pickle=True)
        self.image_paths = data["image_paths"]
        self.depth_paths = data["depth_paths"]
        self.intrinsics = data["intrinsics"]
        self.poses = data["poses"]
        self.pairs = [info for info in data["pair_infos"]
                      if info[1] > min_overlap_score]

    def __len__(self):
        return len(self.pairs)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        (i0, i1), _, _ = self.pairs[idx]
        img0, sc0, m0 = _read_gray_resized(
            os.path.join(self.root, self.image_paths[i0]), self.resize)
        img1, sc1, m1 = _read_gray_resized(
            os.path.join(self.root, self.image_paths[i1]), self.resize)
        depth0 = _read_depth(os.path.join(self.root, self.depth_paths[i0]),
                             self.depth_pad)
        depth1 = _read_depth(os.path.join(self.root, self.depth_paths[i1]),
                             self.depth_pad)
        K0 = self.intrinsics[i0].astype(np.float32).reshape(3, 3)
        K1 = self.intrinsics[i1].astype(np.float32).reshape(3, 3)
        T0 = self.poses[i0].astype(np.float32)
        T1 = self.poses[i1].astype(np.float32)
        T_0to1 = (T1 @ np.linalg.inv(T0)).astype(np.float32)
        s = self.coarse_scale
        return {
            "image0": img0[..., None], "image1": img1[..., None],
            "depth0": depth0, "depth1": depth1,
            "K0": K0, "K1": K1,
            "scale0": sc0, "scale1": sc1,
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "mask0": m0[::s, ::s].astype(np.float32),
            "mask1": m1[::s, ::s].astype(np.float32),
        }


def scene_balanced_stream(npz_dir: str, root_dir: str, batch: int,
                          seed: int = 66, n_samples_per_scene: int = 200,
                          shard: Tuple[int, int] = (0, 1), **scene_kw
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless scene-balanced batches: each epoch samples
    n_samples_per_scene pairs per scene with replacement and shuffles them;
    the sorted scene list is split over the shards (rank, world) by index.
    A pair that fails to load is replaced by a random one, up to 8 tries."""
    rng = np.random.default_rng(seed)
    paths = sorted(glob.glob(os.path.join(npz_dir, "*.npz")))
    rank, world = shard
    paths = [p for i, p in enumerate(paths) if i % world == rank]
    if not paths:
        raise FileNotFoundError(f"no scene npz files in {npz_dir}")
    scenes: List[MegaDepthScene] = [
        MegaDepthScene(p, root_dir, **scene_kw) for p in paths]
    scenes = [s for s in scenes if len(s) > 0]

    def get_with_retry(si, k, tries: int = 8):
        for _ in range(tries):
            try:
                return scenes[si].get(k)
            except Exception:
                si = int(rng.integers(0, len(scenes)))
                k = int(rng.integers(0, len(scenes[si])))
        raise RuntimeError("megadepth: too many consecutive read failures")

    while True:
        order = []
        for si, sc in enumerate(scenes):
            idx = rng.integers(0, len(sc), n_samples_per_scene)
            order.extend((si, int(k)) for k in idx)
        rng.shuffle(order)
        for start in range(0, len(order) - batch + 1, batch):
            samples = [get_with_retry(si, k)
                       for si, k in order[start:start + batch]]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
