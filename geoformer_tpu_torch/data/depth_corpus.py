"""Render a MegaDepth-layout posed-RGBD corpus from textured-plane scenes.

Counterpart of scripts/render_depth_corpus.py: per-scene npz index files
(image_paths, depth_paths, intrinsics, poses, pair_infos) over rendered
multi-plane rooms (data/planes.py) with exact per-pixel depth and
ground-truth world->camera poses, which data/megadepth.py reads. The same
flags and seeds give the same scene names, cameras, intrinsics, poses and
pairs as the JAX script. Textures come from data/native's mixed bank
(cpp/synthgen.cpp, as the JAX corpus used), or from data/synthetic's
mixed_texture_bank where no C++ compiler is there; images are written as
JPEG at quality 95 by eval/jpeg.encode_gray, depths as HDF5 with gzip
level 1 by data/hdf5.write_dataset.

    python -m geoformer_tpu_torch.data.depth_corpus --out "$TMPDIR"/dc \\
        --n-scenes 60 --n-val-scenes 6 --cluttered
    python -m geoformer_tpu_torch.cli train-depth --npz-dir "$TMPDIR"/dc/index \\
        --root "$TMPDIR"/dc --val-npz-dir "$TMPDIR"/dc/index_val \\
        --depth-pad 640 --pallas --batch 4
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Tuple

import numpy as np

from geoformer_tpu_torch.data.hdf5 import write_dataset
from geoformer_tpu_torch.data.planes import look_at, render_planes, room_scene
from geoformer_tpu_torch.eval.jpeg import encode_gray

# the texture bank of the scenes built so far in this process: "native"
# (cpp/synthgen.cpp) or "numpy" (data/synthetic.mixed_texture_bank)
TEXTURES_USED = set()
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def scene_textures(rng: np.random.Generator, seed: int) -> np.ndarray:
    """Six 512x768 textures of a scene, as the JAX script draws them."""
    from geoformer_tpu_torch.data.native import (
        NoCompiler,
        native_textures_mixed,
    )

    try:
        tex = native_textures_mixed(6, 512, 768, seed)
        TEXTURES_USED.add("native")
    except NoCompiler:
        from geoformer_tpu_torch.data.synthetic import mixed_texture_bank

        tex = mixed_texture_bank(rng, (512, 768), 6)
        TEXTURES_USED.add("numpy")
    return np.asarray(tex)


def build_scene(root: str, index_dir: str, name: str, seed: int,
                n_cams: int = 8, hw: Tuple[int, int] = (480, 640),
                cluttered: bool = False) -> int:
    """Render one scene of ``n_cams`` views on an arc into ``root`` and its
    index into ``index_dir``; returns its number of pairs."""
    rng = np.random.default_rng(seed)
    planes = room_scene(rng, scene_textures(rng, seed), cluttered=cluttered)

    H, W = hw
    f = rng.uniform(480.0, 560.0)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    os.makedirs(os.path.join(root, "scenes", name, "imgs"), exist_ok=True)
    os.makedirs(os.path.join(root, "scenes", name, "depths"), exist_ok=True)

    target = np.array([0.0, 0.0, 8.0])
    image_paths, depth_paths, intrinsics, poses = [], [], [], []
    for i in range(n_cams):
        x = -2.2 + 4.4 * i / max(n_cams - 1, 1)
        c = np.array([x, rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.6)])
        T = look_at(c, target + np.array([rng.uniform(-0.6, 0.6),
                                          rng.uniform(-0.4, 0.4), 0]))
        img, depth = render_planes(K, T, planes, (H, W), return_depth=True)
        ipath = f"scenes/{name}/imgs/img_{i:03d}.jpg"
        dpath = f"scenes/{name}/depths/img_{i:03d}.h5"
        with open(os.path.join(root, ipath), "wb") as fh:
            fh.write(encode_gray((img * 255).astype(np.uint8), 95))
        write_dataset(os.path.join(root, dpath), "/depth", depth, gzip=1)
        image_paths.append(ipath)
        depth_paths.append(dpath)
        intrinsics.append(K.astype(np.float64).reshape(-1))
        poses.append(T.astype(np.float64))

    # pair_infos in the reference npz shape: ((i0, i1), overlap, extra);
    # the overlap decays with the index distance on the arc
    pair_infos = []
    for i in range(n_cams):
        for j in range(i + 1, min(i + 4, n_cams)):
            ov = float(max(0.0, 1.0 - 0.18 * (j - i)))
            pair_infos.append(((i, j), ov, 0))
    os.makedirs(index_dir, exist_ok=True)
    np.savez(os.path.join(index_dir, f"{name}.npz"),
             image_paths=np.array(image_paths),
             depth_paths=np.array(depth_paths),
             intrinsics=np.array(intrinsics), poses=np.array(poses),
             pair_infos=np.array(pair_infos, dtype=object))
    return len(pair_infos)


def _build_one(job) -> set:
    build_scene(*job[:4], n_cams=job[4], cluttered=job[5])
    return set(TEXTURES_USED)


def build(out: str, n_scenes: int = 60, n_val_scenes: int = 6,
          n_cams: int = 8, seed: int = 20260820,
          cluttered: bool = False) -> Tuple[int, int]:
    """The JAX script's corpus: train scenes scene0000.. from seed + 31 k,
    val scenes val0000.. from seed + 777000 + 31 k, rendered in one
    process a scene (up to the machine's CPU count) when there are
    several. Returns (train pairs, val pairs)."""
    jobs = [(out, os.path.join(out, "index"), f"scene{k:04d}",
             seed + 31 * k, n_cams, cluttered) for k in range(n_scenes)]
    jobs += [(out, os.path.join(out, "index_val"), f"val{k:04d}",
              seed + 777_000 + 31 * k, n_cams, cluttered)
             for k in range(n_val_scenes)]
    workers = min(len(jobs), os.cpu_count() or 1)
    if workers > 1:
        # one BLAS thread a worker: the workers are the parallelism
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: "1" for k in _THREAD_VARS})
        try:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
                done = list(pool.map(_build_one, jobs))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    else:
        done = [_build_one(j) for j in jobs]
    for used in done:
        TEXTURES_USED.update(used)
    # every arc of n_cams views has the same pairs
    pairs = sum(1 for i in range(n_cams)
                for _ in range(i + 1, min(i + 4, n_cams)))
    return n_scenes * pairs, n_val_scenes * pairs


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="corpus directory (default: a new temporary one)")
    ap.add_argument("--n-scenes", type=int, default=60)
    ap.add_argument("--n-val-scenes", type=int, default=6)
    ap.add_argument("--n-cams", type=int, default=8)
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--cluttered", action="store_true",
                    help="guaranteed multi-depth clutter (essential-pose "
                         "validation needs non-coplanar match sets)")
    args = ap.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="depth_corpus_")
    total, vtotal = build(out, args.n_scenes, args.n_val_scenes,
                          args.n_cams, args.seed, args.cluttered)
    print(f"wrote {args.n_scenes} train scenes ({total} pairs) + "
          f"{args.n_val_scenes} val scenes ({vtotal} pairs) to {out} "
          f"(textures: {', '.join(sorted(TEXTURES_USED))})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
