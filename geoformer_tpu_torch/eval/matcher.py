"""Batched matcher: pad image pairs into a bucket, run the forward.

Counterpart of the core of geoformer_tpu/eval/matcher.py:BatchedMatcher.
Images come in as float arrays in [0, 1] (reading image files waits: the
JAX package reads them with cv2). Pairs are zero-padded into one
64-pixel-rounded shape with coarse validity masks and matched in batches of
``batch_size``; each call draws the RANSAC samples from a generator seeded
with 0, as the JAX matcher uses one fixed key per call.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from geoformer_tpu_torch.config import GeoFormerConfig
from geoformer_tpu_torch.models import GeoFormer


def bucket_shape(h: int, w: int, quant: int = 64) -> Tuple[int, int]:
    return (math.ceil(h / quant) * quant, math.ceil(w / quant) * quant)


class BatchedMatcher:
    """Batched GeoFormer matcher over padded buckets, on one device."""

    def __init__(self, config: GeoFormerConfig, model: GeoFormer,
                 batch_size: int = 4, device="cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size

    def match_batch(self, imgs0: List[np.ndarray], imgs1: List[np.ndarray],
                    return_geo: bool = False):
        """Match lists of 2-D float images (any sizes within one bucket).

        Returns per pair (mkpts0 [K, 2], mkpts1 [K, 2], mconf [K]) numpy
        arrays in the (unpadded) pixel frame; with return_geo a 4th element
        {'H', 'has_H', 'num_inliers'} holds the pair's GAM state."""
        s = self.cfg.coarse_scale
        shapes = [bucket_shape(*im.shape) for im in imgs0 + imgs1]
        H = max(h for h, _ in shapes)
        W = max(w for _, w in shapes)
        b = self.batch_size
        out = []
        for start in range(0, len(imgs0), b):
            chunk0 = imgs0[start:start + b]
            chunk1 = imgs1[start:start + b]
            i0 = np.zeros((b, H, W, 1), np.float32)
            i1 = np.zeros((b, H, W, 1), np.float32)
            m0 = np.zeros((b, H // s, W // s), np.float32)
            m1 = np.zeros((b, H // s, W // s), np.float32)
            for j, (a, c) in enumerate(zip(chunk0, chunk1)):
                i0[j, :a.shape[0], :a.shape[1], 0] = a
                i1[j, :c.shape[0], :c.shape[1], 0] = c
                m0[j, :a.shape[0] // s, :a.shape[1] // s] = 1.0
                m1[j, :c.shape[0] // s, :c.shape[1] // s] = 1.0
            gen = torch.Generator(self.device).manual_seed(0)
            with torch.no_grad():
                res = self.model(*(torch.from_numpy(x).to(self.device)
                                   for x in (i0, i1, m0, m1)), generator=gen)
            mk0 = res.fine.mkpts0.cpu().numpy()
            mk1 = res.fine.mkpts1.cpu().numpy()
            mc = res.fine.mconf.float().cpu().numpy()
            valid = res.fine.valid.cpu().numpy()
            for j in range(len(chunk0)):
                v = valid[j]
                row = (mk0[j][v], mk1[j][v], mc[j][v])
                if return_geo:
                    row += ({"H": res.geo.H[j].cpu().numpy(),
                             "has_H": bool(res.geo.has_H[j]),
                             "num_inliers": int(res.geo.num_inliers[j])},)
                out.append(row)
        return out
