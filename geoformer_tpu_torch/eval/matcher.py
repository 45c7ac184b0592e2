"""Image loading and the batched matcher.

Counterpart of geoformer_tpu/eval/matcher.py. ``load_gray`` reads an image
file (eval/image_io.py in place of cv2.imread), resizes its shorter edge to
``imsize`` on the /8 grid (ops/resize.resize_linear_u8 in place of
cv2.resize) and returns the scale factors back to the file's frame;
``enhance_retinal`` is the JAX package's retinal enhancement, and
``ratio_preserving_resize`` its resize-then-crop-or-pad helper.
``BatchedMatcher`` zero-pads pairs into one 64-pixel-rounded shape with
coarse validity masks and matches them in batches of ``batch_size``; each
call draws the RANSAC samples from a generator seeded with 0, as the JAX
matcher uses one fixed key per call. ``prewarm`` runs one forward per
shape bucket, so that first-call costs (cuDNN's algorithm search, the
allocator) land before a timed loop.

In a process group (core/mesh.py) the matcher runs data-parallel
(``data_parallel``, the JAX matcher's ``mesh``: each rank matches its
slice of every batch and the results are gathered to every rank in the
order of the pairs) or sequence-parallel (``seq_group``, the JAX
matcher's ``seq_mesh``: each pair's rows split over the ranks of the seq
split in force, core/mesh.seq_groups; every rank returns the same
matches).
"""

from __future__ import annotations

import copy
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from geoformer_tpu_torch.config import GeoFormerConfig
from geoformer_tpu_torch.core import dist as pdist
from geoformer_tpu_torch.core import mesh
from geoformer_tpu_torch.eval.clahe import clahe
from geoformer_tpu_torch.eval.image_io import read_gray
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.ops.resize import resize_linear, resize_linear_u8
from geoformer_tpu_torch.utils.spans import span


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


def ratio_preserving_resize(im: np.ndarray, target_hw) -> np.ndarray:
    """Resize ``im`` ([h, w] or [h, w, C], uint8 or float) by the larger of
    the two scales to target_hw (ops/resize.resize_linear, cv2.resize's
    arithmetic), then centre-crop or zero-pad each axis to target_hw."""
    th, tw = target_hw
    h, w = im.shape[:2]
    s = max(th / h, tw / w)
    nh, nw = int(round(h * s)), int(round(w * s))
    tmp = resize_linear(im, (nh, nw))
    out = np.zeros((th, tw) + im.shape[2:], tmp.dtype)
    dy, dx = (th - nh) // 2, (tw - nw) // 2
    sy0, ty0 = max(-dy, 0), max(dy, 0)
    sx0, tx0 = max(-dx, 0), max(dx, 0)
    ch, cw = min(nh, th), min(nw, tw)
    out[ty0:ty0 + ch, tx0:tx0 + cw] = tmp[sy0:sy0 + ch, sx0:sx0 + cw]
    return out


def enhance_retinal(im: np.ndarray) -> np.ndarray:
    """Retinal image enhancement: normalize, CLAHE (clip 2.0, 8x8 tiles),
    gamma 1.2; uint8 in, uint8 out (the JAX function's arithmetic, with
    eval/clahe.py and a table lookup in place of cv2)."""
    x = im.astype(np.float64)
    x = (x - x.mean()) / (x.std() + 1e-6)
    x = (x - x.min()) / (x.max() - x.min()) * 255
    x = clahe(x.astype(np.uint8), 2.0, (8, 8))
    inv = 1.0 / 1.2
    table = (((np.arange(256) / 255.0) ** inv) * 255).astype(np.uint8)
    return table[x]


def load_gray(path: str, imsize: Optional[int], dfactor: int = 8,
              enhanced: bool = False
              ) -> Tuple[np.ndarray, Tuple[float, float]]:
    """([ht, wt] float32 image in [0, 1], (sx, sy)) of an image file;
    ``enhanced`` applies enhance_retinal before the resize."""
    im = read_gray(path)
    if enhanced:
        im = enhance_retinal(im)
    ho, wo = im.shape
    wt, ht, scale = resize_shape(wo, ho, imsize, dfactor)
    im = resize_linear_u8(im, (ht, wt))
    return im.astype(np.float32) / 255.0, scale


def bucket_shape(h: int, w: int, quant: int = 64) -> Tuple[int, int]:
    return (math.ceil(h / quant) * quant, math.ceil(w / quant) * quant)


class BatchedMatcher:
    """Batched GeoFormer matcher over padded buckets, on one device (a
    rank's device in a process group).

    ``data_parallel``: the batch is split over the ranks (batch_size must
    divide by the data replicas, as the JAX matcher asserts for its mesh)
    and each batch's results are gathered to every rank. ``seq_group``: the
    SeqLayout of the seq split in force (core/mesh.seq_groups); each pair
    runs with ``seq_axis`` set, its rows split over the group. The two are
    mutually exclusive."""

    def __init__(self, config: GeoFormerConfig, model: GeoFormer,
                 batch_size: int = 4, device="cuda", seq_group=None,
                 data_parallel: bool = False):
        if seq_group is not None:
            if data_parallel:
                raise ValueError("data_parallel and seq_group are mutually "
                                 "exclusive")
            if seq_group is not mesh.layout():
                raise ValueError("seq_group is not the seq split in force "
                                 "(core/mesh.seq_groups)")
            config = config.replace(seq_axis="seq")
            model = copy.copy(model)    # the same parameters, seq_axis set
            model.config = config
        if data_parallel and mesh.seq_world() > 1:
            raise ValueError("data_parallel under a seq split")
        if data_parallel and batch_size % mesh.data_world():
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{mesh.data_world()} ranks")
        self.cfg = config
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.data_parallel = data_parallel and mesh.data_world() > 1

    def _forward(self, i0, i1, m0, m1):
        """The model on a padded batch (host arrays), RANSAC drawn from a
        generator seeded with 0 for the whole batch; data-parallel: on this
        rank's slice, with its rows of the batch's draw."""
        dev = self.device
        with span("matcher.copy_in"):
            gen = torch.Generator(dev).manual_seed(0)
            arrays = [torch.from_numpy(x).to(dev) for x in (i0, i1, m0, m1)]
        with span("matcher.forward"):
            noise = None
            if self.data_parallel:
                b, h, w, _ = i0.shape
                cells = (h // self.cfg.coarse_scale) * (
                    w // self.cfg.coarse_scale)
                cap = self.cfg.match.max_matches
                n = cells if cap <= 0 or cap >= cells else cap
                sl = mesh.local_shard_slice(b)
                noise = torch.rand((b, self.cfg.geo.ransac_iters, n),
                                   generator=gen, device=dev)[sl]
                arrays = [x[sl] for x in arrays]
            with torch.no_grad():
                return self.model(*arrays, generator=gen, ransac_noise=noise)

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
        shapes = [bucket_shape(*im.shape) for im in imgs0 + imgs1]
        H = max(h for h, _ in shapes)
        W = max(w for _, w in shapes)
        b = self.batch_size
        out = []
        for start in range(0, len(imgs0), b):
            with span("matcher.call"):
                out += self._match_chunk(imgs0[start:start + b],
                                  imgs1[start:start + b], H, W, return_geo)
        return out

    def _match_chunk(self, chunk0, chunk1, H: int, W: int, return_geo: bool):
        """match_batch on one chunk of at most batch_size pairs, padded
        to (H, W)."""
        s = self.cfg.coarse_scale
        b = self.batch_size
        with span("matcher.pad"):
            i0 = np.zeros((b, H, W, 1), np.float32)
            i1 = np.zeros((b, H, W, 1), np.float32)
            m0 = np.zeros((b, H // s, W // s), np.float32)
            m1 = np.zeros((b, H // s, W // s), np.float32)
            for j, (a, c) in enumerate(zip(chunk0, chunk1)):
                i0[j, :a.shape[0], :a.shape[1], 0] = a
                i1[j, :c.shape[0], :c.shape[1], 0] = c
                m0[j, :a.shape[0] // s, :a.shape[1] // s] = 1.0
                m1[j, :c.shape[0] // s, :c.shape[1] // s] = 1.0
        res = self._forward(i0, i1, m0, m1)
        with span("matcher.copy_out"):
            got = {"mk0": res.fine.mkpts0, "mk1": res.fine.mkpts1,
                   "mc": res.fine.mconf.float(), "valid": res.fine.valid,
                   "H": res.geo.H, "has_H": res.geo.has_H,
                   "num_inliers": res.geo.num_inliers}
            got = {k: v.cpu().numpy() for k, v in got.items()}
        out = []
        with span("matcher.unpack"):
            if self.data_parallel:    # every rank's slice, in pair order
                got = pdist.all_gather_metrics(got)
            for j in range(len(chunk0)):
                v = got["valid"][j]
                row = (got["mk0"][j][v], got["mk1"][j][v], got["mc"][j][v])
                if return_geo:
                    row += ({"H": got["H"][j],
                             "has_H": bool(got["has_H"][j]),
                             "num_inliers": int(got["num_inliers"][j])},)
                out.append(row)
        return out
