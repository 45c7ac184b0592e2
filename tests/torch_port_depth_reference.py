"""The depth gate's two CPU references (not collected by pytest).

    python tests/torch_port_depth_reference.py port --corpus DIR_P
    python tests/torch_port_depth_reference.py jax --corpus DIR_J [--batch 2]

``port``: the port's depth gate (geoformer_tpu_torch/eval/depth_gate.py)
on the CPU, on the val corpus the port renders into DIR_P: the reference
chip_smoke.py's depth phase prints beside the card's numbers
(DEPTH_CPU_REF there).

``jax``: the JAX package's own validation sweep of the same checkpoint
(geoformer_tpu.train.depth_loop.run_depth_validation with its jitted
make_depth_val_step and the device pose backend) on the val corpus the
JAX script renders (scripts/render_depth_corpus.build_scene: cv2's warps
and JPEG, h5py), the record's 32 pairs from the val stream with seed 67.
``--batch 2`` draws the same pairs in the same order as batches of 4 (the
stream yields consecutive pairs of one shuffled order) at half the
memory; only the GAM's RANSAC keys differ.

Each prints one JSON record; PERF.md keeps both. At 640x640 each pair's
forward takes seconds on a CPU and the JAX compile minutes.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def port(args):
    from geoformer_tpu_torch.eval.depth_gate import depth_gate

    return depth_gate(args.corpus, device="cpu")


def jax_sweep(args):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "scripts"))
    from render_depth_corpus import build_scene

    from geoformer_tpu.config import (
        GeoFormerConfig,
        GeoModuleConfig,
        MatchConfig,
        TrainConfig,
    )
    from geoformer_tpu.data.megadepth import scene_balanced_stream
    from geoformer_tpu.models import GeoFormer
    from geoformer_tpu.train.checkpoint import load_variables
    from geoformer_tpu.train.depth_loop import run_depth_validation
    from geoformer_tpu.train.trainer import TrainState, make_depth_val_step

    corpus = args.corpus
    t0 = time.time()
    if not os.path.isdir(os.path.join(corpus, "index_val")):
        for k in range(6):
            build_scene(corpus, os.path.join(corpus, "index_val"),
                        f"val{k:04d}", 20260820 + 777_000 + 31 * k,
                        cluttered=True)
    render_s = time.time() - t0
    cfg = GeoFormerConfig(
        match=MatchConfig(max_matches=512, force_one_match=True),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=512,
                            use_pallas=True))
    v = load_variables(str(ROOT / "checkpoints" / "tpu_r5_depth2"
                           / "params_final.npz"))
    state = TrainState(v["params"], v["batch_stats"], None,
                       jnp.zeros((), jnp.int32))
    tcfg = TrainConfig(batch_size=args.batch, image_hw=(640, 640))
    val_fn = jax.jit(make_depth_val_step(GeoFormer(cfg), tcfg))
    stream = scene_balanced_stream(
        os.path.join(corpus, "index_val"), corpus, args.batch, 67,
        min_overlap_score=0.4, img_resize=640, depth_pad=640)
    n = 32 // args.batch
    batches = [{k: jnp.asarray(x) for k, x in next(stream).items()}
               for _ in range(n)]
    t0 = time.time()
    rec = run_depth_validation(val_fn, state, batches, jax.random.key(0))
    rec.update(pairs=32, batch=args.batch, render_s=round(render_s, 1),
               validation_s=round(time.time() - t0, 1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=("port", "jax"))
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    rec = port(args) if args.which == "port" else jax_sweep(args)
    print(json.dumps({"reference": args.which, **rec}, default=float))


if __name__ == "__main__":
    main()
