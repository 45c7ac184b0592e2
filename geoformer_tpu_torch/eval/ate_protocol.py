"""The standing ATE gate of the planar SLAM engine, on the port.

Counterpart of scripts/ate_protocol.py. A seeded synthetic planar
sequence (a textured plane and an SL(3) random-walk camera sweep, from
``--seed``) is written as PNG frames with its ground-truth trajectory,
then ``cli slam`` runs the whole stack in a subprocess (matcher ->
RANSAC odometry and loop closures -> SL(3) pose-graph optimization) and
the optimized mean corner drift is held to the pinned gate of the JAX
script, 3.0 px.

    python -m geoformer_tpu_torch.eval.ate_protocol [--ckpt ...] \\
        [--bf16 --pallas] [--frames 12] [--dir DIR] [--device cpu]

The texture and the warps are the port's build of cpp/synthgen.cpp
(data/native.py), as the JAX script's are that file's, and the ground
truth comes from the port's sl3_exp. Without ``--dir`` the sequence is
written into a new temporary directory, removed after the run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent.parent
# Pinned gate of the JAX script: round 1 measured 1.43 px optimized drift
# on 8 frames; the 12-frame protocol is harder, so the gate leaves headroom
# without letting a silent 2x regression pass.
REGRESSION_GATE_PX = 3.0
# The JAX record (RESULTS.md, round 5): 0.931 px chained, 1.141 optimized.
JAX_RECORD = {"corner_drift_chained_px": 0.931,
              "corner_drift_optimized_px": 1.141}
# The port on a CPU: this module's run with --device cpu (f32).
CPU_REF = {"corner_drift_chained_px": 0.702,
           "corner_drift_optimized_px": 0.163}


def build_sequence(out: str, frames: int = 12, hw=(480, 640),
                   seed: int = 20260819) -> np.ndarray:
    """Write frame_000.png ... and gt.npz (H [K, 3, 3], frame 0 -> k) under
    ``out``; returns the ground truth. The draws are the JAX script's."""
    from geoformer_tpu_torch.data.native import native_textures, native_warp
    from geoformer_tpu_torch.engine.homography_graph import sl3_exp
    from geoformer_tpu_torch.utils.plotting import write_png

    H, W = hw
    rng = np.random.default_rng(seed)
    base = native_textures(1, H, W, seed)[0]
    Hs_gt = [np.eye(3, dtype=np.float32)]
    for _ in range(1, frames):
        xi = rng.normal(0, 0.015, 8).astype(np.float32)
        xi[4] = rng.normal(0, 12.0)
        xi[5] = rng.normal(0, 12.0)
        xi[6:] *= 1e-4
        Hs_gt.append(sl3_exp(torch.from_numpy(xi)).numpy() @ Hs_gt[-1])
    Hs_gt = np.stack(Hs_gt)
    seq = native_warp(np.repeat(base[None], frames, 0), Hs_gt)
    os.makedirs(out, exist_ok=True)
    for k in range(frames):
        write_png(os.path.join(out, f"frame_{k:03d}.png"),
                  (np.clip(seq[k], 0, 1) * 255).astype(np.uint8))
    np.savez(os.path.join(out, "gt.npz"), H=Hs_gt)
    return Hs_gt


def slam_command(seq_dir: str, ckpt: str, imsize: int, loop_stride: int = 5,
                 device: str = "cuda", bf16: bool = False,
                 pallas: bool = False) -> list:
    cmd = [sys.executable, "-m", "geoformer_tpu_torch.cli", "slam",
           "--images", seq_dir, "--glob", "frame_*.png",
           "--loop-stride", str(loop_stride), "--gt",
           os.path.join(seq_dir, "gt.npz"), "--ckpt", os.path.abspath(ckpt),
           "--imsize", str(imsize), "--device", device]
    return cmd + ["--bf16"] * bf16 + ["--pallas"] * pallas


def record(slam: dict, seed: int, frames: int, loop_stride: int) -> dict:
    """The JAX script's record of a `cli slam` JSON line."""
    drift = slam.get("corner_drift_optimized_px")
    return {
        "protocol": "ate_synthetic_planar",
        "seed": seed,
        "frames": frames,
        "loop_stride": loop_stride,
        "corner_drift_chained_px": slam.get("corner_drift_chained_px"),
        "corner_drift_optimized_px": drift,
        "gate_px": REGRESSION_GATE_PX,
        "pass": drift is not None and drift <= REGRESSION_GATE_PX,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=str(
        REPO / "checkpoints" / "tpu_r3_main" / "params_final.npz"))
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--loop-stride", type=int, default=5)
    ap.add_argument("--dir", default=None,
                    help="sequence directory (default: a temporary one)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    seq_dir = args.dir or tempfile.mkdtemp(prefix="ate_protocol_")
    try:
        build_sequence(seq_dir, args.frames, (args.height, args.width),
                       args.seed)
        cmd = slam_command(seq_dir, args.ckpt, max(args.height, args.width),
                           args.loop_stride, args.device, args.bf16,
                           args.pallas)
        print("running:", " ".join(cmd), flush=True)
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    finally:
        if args.dir is None:
            shutil.rmtree(seq_dir, ignore_errors=True)
    sys.stderr.write(r.stderr[-2000:] if r.stderr else "")
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.startswith("{")]
    if r.returncode or not lines:
        print(r.stdout[-2000:])
        return r.returncode or 1
    rec = record(json.loads(lines[-1]), args.seed, args.frames,
                 args.loop_stride)
    print(json.dumps(rec))
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
