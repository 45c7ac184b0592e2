"""`cli infer --seq-shard N` against `--seq-shard 0` on one textured pair.

Writes a textured pair of the given size (eval/synthetic.textured_pair,
seed 3) as PNGs into a temporary directory, runs `cli infer` on it in a
subprocess with `--seq-shard 0` and with `--seq-shard N` (N ranks: NCCL,
one card a rank, or gloo with `--device cpu`), and prints one JSON record:
the card, each run's match count, the match call's seconds that `infer`
prints, its wall seconds (start-up included), and the share of the
one-process matches that the N-rank run reproduces within 0.1 px.

    python -m geoformer_tpu_torch.eval.seq_shard_compare --ranks 4 \\
        [--height 1920 --width 2560] [--ckpt PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from geoformer_tpu_torch.eval.synthetic import textured_pair
from geoformer_tpu_torch.utils.plotting import write_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "checkpoints", "tpu_r3_main", "params_final.npz")


def _card(device: str) -> str:
    """The first card's name and power limit as nvidia-smi gives them."""
    if device == "cpu":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def _infer(paths, out, ranks: int, args) -> dict:
    cmd = [sys.executable, "-m", "geoformer_tpu_torch.cli", "infer",
           *paths, "--imsize", str(min(args.height, args.width)),
           "--ckpt", args.ckpt, "--bf16", "--pallas", "--seq-shard",
           str(ranks), "--out", out, "--device", args.device]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stderr[-3000:]}")
    found = re.search(r"(\d+) matches in ([\d.]+)s", r.stdout)
    return dict(matches=int(found.group(1)), match_s=float(found.group(2)),
                wall_s=round(wall, 1))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--height", type=int, default=1920)
    p.add_argument("--width", type=int, default=2560)
    p.add_argument("--ckpt", default=CKPT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name, img in zip(("a.png", "b.png"), textured_pair(
                (args.height, args.width), 3)):
            paths.append(os.path.join(tmp, name))
            write_png(paths[-1], (img * 255).astype(np.uint8))
        runs, kp = {}, {}
        for n in (0, args.ranks):
            out = os.path.join(tmp, f"m{n}.npy")
            runs[n] = _infer(paths, out, n, args)
            kp[n] = {tuple(np.round(r[:4], 1)) for r in np.load(out)}
    print(json.dumps({
        "card": _card(args.device), "hw": [args.height, args.width],
        "ranks": args.ranks, "one_process": runs[0],
        "seq_shard": runs[args.ranks],
        "reproduced": round(len(kp[0] & kp[args.ranks])
                            / max(len(kp[0]), 1), 4)}))


if __name__ == "__main__":
    main()
