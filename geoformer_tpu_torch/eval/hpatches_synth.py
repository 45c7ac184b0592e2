"""A synthetic HPatches-shaped corpus (layout and size census), on the port.

Counterpart of scripts/hpatches_synth.py. It writes an
``hpatches-sequences-release``-layout tree: 108 sequences (52 i_
illumination, 56 v_ viewpoint, the real benchmark's split), each with
1.ppm..6.ppm and the ground-truth homographies H_1_2..H_1_6, from textures
synthesized here. Sizes come from a mixed-resolution census (min edge
480..960, landscape-heavy aspects, some v_ sequences changing size between
images), so the evaluation path meets the resolution buckets the real
benchmark gives it; 540 pairs under known homographies make the standing
HPatches gate (eval/hpatches_protocol.py).

The builder draws from ``np.random.default_rng(seed)`` in the JAX
script's order, so the same seed gives the same sequence names, sizes and
homographies (the H_1_k files are equal). cv2 is replaced by numpy and the
port: eval/fire_isc_protocol.perspective_transform (OpenCV's LU, the same
bits) for getPerspectiveTransform, ``warp_perspective`` below (bilinear,
exact positions where cv2 rounds them to 1/32 px) for warpPerspective,
the port's PPM writer for imwrite; textures are data/synthetic's
procedural_texture. The images differ from the JAX builder's by fractions
of a grey level.

    python -m geoformer_tpu_torch.eval.hpatches_synth --out "$TMPDIR"/hp
    python -m geoformer_tpu_torch.cli eval hpatches --data "$TMPDIR"/hp \\
        --ckpt checkpoints/tpu_r3_main/params_final.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from geoformer_tpu_torch.data.synthetic import procedural_texture
from geoformer_tpu_torch.eval.fire_isc_protocol import perspective_transform
from geoformer_tpu_torch.eval.image_io import read_gray
from geoformer_tpu_torch.ops.resize import resize_linear_u8

# (min_edge, aspect) census: landscape-heavy with some portrait, as the real
# benchmark after its min-edge-480 resize. Aspect = w / h.
MIN_EDGES = [480, 560, 640, 720, 800, 880, 960]
ASPECTS = [4 / 3, 3 / 2, 16 / 9, 1.25, 3 / 4, 2 / 3]
ASPECT_W = [0.3, 0.25, 0.15, 0.1, 0.12, 0.08]
# an optional image bank, as the JAX script's; resolved against the
# checkout, not the working directory
TEXTURE_DIR = Path(__file__).resolve().parents[2] / "data" / "textures"


def _size(rng) -> Tuple[int, int]:
    me = int(rng.choice(MIN_EDGES))
    asp = float(rng.choice(ASPECTS, p=ASPECT_W))
    if asp >= 1:
        h, w = me, int(round(me * asp / 8) * 8)
    else:
        w, h = me, int(round(me / asp / 8) * 8)
    return h, w


def _texture(rng, hw, image_bank):
    if image_bank and rng.random() < 0.4:
        im = image_bank[int(rng.integers(len(image_bank)))]
        return resize_linear_u8(im, hw).astype(np.float32) / 255.0
    return procedural_texture(rng, hw)


def _photometric(rng, im):
    # float32 through the gamma and the gain, float64 once noise is added:
    # the JAX script's dtype flow, which the written bytes depend on
    g = float(rng.uniform(0.6, 1.6))
    im = np.clip(im, 0, 1) ** g
    im = im * float(rng.uniform(0.7, 1.2)) + float(rng.uniform(-0.1, 0.1))
    if rng.random() < 0.5:
        im = im + rng.normal(0, 0.02, im.shape)
    return np.clip(im, 0, 1)


def _corner_h(rng, hw0, hw1, mag=0.22):
    """Random perspective H mapping frame (h0, w0) -> (h1, w1) by perturbed
    corners (the standard 4-corner construction)."""
    h0, w0 = hw0
    h1, w1 = hw1
    src = np.array([[0, 0], [w0, 0], [w0, h0], [0, h0]], np.float32)
    dst = np.array([[0, 0], [w1, 0], [w1, h1], [0, h1]], np.float32)
    jitter = (rng.uniform(-mag, mag, (4, 2))
              * np.array([[w1, h1]], np.float32)).astype(np.float32)
    return perspective_transform(src, dst + jitter)


def _ppm8(im) -> np.ndarray:
    """Grey [0, 1] float -> 3-channel uint8, as the JAX script writes its
    PPM files."""
    g = (np.clip(im, 0, 1) * 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """A binary P6 PPM of an [H, W, 3] uint8 image."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes())


def warp_perspective(img: np.ndarray, H: np.ndarray,
                     out_hw: Sequence[int]) -> np.ndarray:
    """cv2.warpPerspective(img, H, (w_out, h_out)) of a float32 image onto
    an output of its own size: dst(p) = src(H^-1 p) with H^-1 in float64,
    bilinear taps in float32, zeros outside. At the source's size it
    follows data/native.native_warp's arithmetic (cpp/synthgen.cpp
    warp_one)."""
    src = np.asarray(img, np.float32)
    h, w = src.shape
    ho, wo = out_hw
    hi = np.linalg.inv(np.asarray(H, np.float64))
    y, x = np.mgrid[0:ho, 0:wo].astype(np.float64)
    d = hi[2, 0] * x + hi[2, 1] * y + hi[2, 2]
    d = np.where(d == 0, 1e-9, d)
    with np.errstate(invalid="ignore", over="ignore"):
        sx = (hi[0, 0] * x + hi[0, 1] * y + hi[0, 2]) / d
        sy = (hi[1, 0] * x + hi[1, 1] * y + hi[1, 2]) / d
    # positions off the image by more than a pixel read no tap: clip them
    # there (and NaNs with them) before the integer cast
    sx = np.nan_to_num(np.clip(sx, -2.0, w + 1.0), nan=-2.0)
    sy = np.nan_to_num(np.clip(sy, -2.0, h + 1.0), nan=-2.0)
    x0, y0 = np.floor(sx), np.floor(sy)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    one = np.float32(1)
    acc = np.zeros((ho, wo), np.float32)
    for dx, dy, wgt in ((0, 0, (one - fx) * (one - fy)),
                        (1, 0, fx * (one - fy)),
                        (0, 1, (one - fx) * fy),
                        (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        tap = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        acc += np.where(ok, wgt * tap, np.float32(0))
    return acc


def _image_bank(use_images: bool):
    bank = []
    if use_images and os.path.isdir(TEXTURE_DIR):
        for f in sorted(os.listdir(TEXTURE_DIR)):
            try:
                bank.append(read_gray(os.path.join(TEXTURE_DIR, f)))
            except (OSError, ValueError):
                continue
    return bank


def build(out_dir: str, n_i: int = 52, n_v: int = 56, seed: int = 0,
          use_images: bool = True) -> int:
    """Write the corpus under ``out_dir``; returns its number of sequences.
    The first n_i are i_synth<k>, then n_v v_synth<k>."""
    rng = np.random.default_rng(seed)
    bank = _image_bank(use_images)
    names = [f"i_synth{k:03d}" for k in range(n_i)] + \
        [f"v_synth{k:03d}" for k in range(n_v)]
    for name in names:
        seq = os.path.join(out_dir, name)
        os.makedirs(seq, exist_ok=True)
        hw0 = _size(rng)
        base = _texture(rng, hw0, bank)
        write_ppm(os.path.join(seq, "1.ppm"), _ppm8(base))
        for idx in range(2, 7):
            if name.startswith("i_"):
                # a slight warp (~1.5 % corner jitter): fixed-camera in
                # spirit, without saturating AUC@1 px by construction
                hwk = hw0
                H = _corner_h(rng, hw0, hwk, mag=0.015)
            else:
                # some v_ sequences change size between images, as in the
                # real corpus
                hwk = _size(rng) if rng.random() < 0.3 else hw0
                H = _corner_h(rng, hw0, hwk)
            im = _photometric(rng, warp_perspective(base, H, hwk))
            write_ppm(os.path.join(seq, f"{idx}.ppm"), _ppm8(im))
            np.savetxt(os.path.join(seq, f"H_1_{idx}"), H)
    return len(names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="geoformer_tpu_torch.eval.hpatches_synth",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="corpus directory (default: a new temporary one)")
    ap.add_argument("--n-i", type=int, default=52)
    ap.add_argument("--n-v", type=int, default=56)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-images", action="store_true",
                    help=f"procedural textures only (no {TEXTURE_DIR} bank)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = tempfile.mkdtemp(prefix="hpatches_synth_")
    n = build(args.out, args.n_i, args.n_v, args.seed,
              use_images=not args.no_images)
    print(f"wrote {n} sequences to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
