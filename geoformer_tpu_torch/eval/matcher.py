"""Image loading and the batched matcher.

Counterpart of geoformer_tpu/eval/matcher.py. ``load_gray`` reads an image
file (eval/image_io.py in place of cv2.imread), resizes its shorter edge to
``imsize`` on the /8 grid (ops/resize.resize_linear_u8 in place of
cv2.resize) and returns the scale factors back to the file's frame.
``BatchedMatcher`` zero-pads pairs into one 64-pixel-rounded shape with
coarse validity masks and matches them in batches of ``batch_size``; each
call draws the RANSAC samples from a generator seeded with 0, as the JAX
matcher uses one fixed key per call. ``prewarm`` runs one forward per
shape bucket, so that first-call costs (cuDNN's algorithm search, the
allocator) land before a timed loop.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from geoformer_tpu_torch.config import GeoFormerConfig
from geoformer_tpu_torch.eval.image_io import read_gray
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.ops.resize import resize_linear_u8


def resize_shape(wo: int, ho: int, imsize: Optional[int], dfactor: int = 8,
                 use_min: bool = True) -> Tuple[int, int, Tuple[float, float]]:
    """Target (wt, ht) and the (sx, sy) scale back to (wo, ho): resize only
    when the chosen edge exceeds imsize, then floor both edges to the
    dfactor grid."""
    wt, ht = wo, ho
    edge = min(wo, ho) if use_min else max(wo, ho)
    if imsize and imsize > 0 and edge > imsize:
        s = imsize / edge
        ht, wt = int(round(ho * s)), int(round(wo * s))
    wt, ht = (wt // dfactor) * dfactor, (ht // dfactor) * dfactor
    return wt, ht, (wo / wt, ho / ht)


def load_gray(path: str, imsize: Optional[int], dfactor: int = 8,
              enhanced: bool = False
              ) -> Tuple[np.ndarray, Tuple[float, float]]:
    """([ht, wt] float32 image in [0, 1], (sx, sy)) of an image file."""
    if enhanced:
        raise NotImplementedError(
            "enhanced=True (the retinal CLAHE enhancement) is not ported "
            "yet: it comes with the FIRE driver (ROADMAP queue 1)")
    im = read_gray(path)
    ho, wo = im.shape
    wt, ht, scale = resize_shape(wo, ho, imsize, dfactor)
    im = resize_linear_u8(im, (ht, wt))
    return im.astype(np.float32) / 255.0, scale


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

    def pair_bucket(self, shape0, shape1) -> Tuple[int, int]:
        """The padded (H, W) a pair of (h, w) resized shapes lands in."""
        shapes = [bucket_shape(*shape0), bucket_shape(*shape1)]
        return (max(h for h, _ in shapes), max(w for _, w in shapes))

    def prewarm(self, pair_shapes, log=print) -> None:
        """One forward of a full batch per bucket of ``pair_shapes``
        (((h0, w0), (h1, w1)) resized shapes), each bucket's time logged."""
        buckets: Dict[Tuple[int, int], int] = {}
        for s0, s1 in pair_shapes:
            hw = self.pair_bucket(s0, s1)
            buckets[hw] = buckets.get(hw, 0) + 1
        log(f"prewarm: {len(buckets)} bucket(s): " + ", ".join(
            f"{h}x{w} (x{c})" for (h, w), c in sorted(buckets.items())))
        s = self.cfg.coarse_scale
        b = self.batch_size
        for i, (H, W) in enumerate(sorted(buckets)):
            t0 = time.time()
            img = torch.zeros((b, H, W, 1), device=self.device)
            mask = torch.ones((b, H // s, W // s), device=self.device)
            gen = torch.Generator(self.device).manual_seed(0)
            with torch.no_grad():
                res = self.model(img, img, mask, mask, generator=gen)
            res.fine.valid.cpu()
            log(f"prewarm {i + 1}/{len(buckets)}: {H}x{W} "
                f"in {time.time() - t0:.1f}s")

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
