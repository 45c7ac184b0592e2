"""The standing 540-pair HPatches gate, on the port.

Counterpart of scripts/hpatches_protocol.py: ``cli eval hpatches`` over
the mixed-resolution synthetic corpus of eval/hpatches_synth.py (108
sequences x 5 pairs, the real benchmark's layout and size census), with
AUC@1/3/5/10, est_failed and the end-to-end wall clock in one JSON
record, the JAX script's.

    python -m geoformer_tpu_torch.eval.hpatches_protocol [--ckpt ...] \\
        [--bf16 --pallas] [--corpus DIR] [--device cpu]

Without ``--corpus`` the corpus is built into a new temporary directory
and removed after the run; a ``--corpus`` directory that does not exist
yet is built and kept. The evaluation runs in a subprocess, as in the JAX
script; its output's tail is echoed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from geoformer_tpu_torch.eval.hpatches_synth import build

REPO = Path(__file__).resolve().parent.parent.parent


def build_corpus(path: str, seed: int = 0, n_i: int = 52,
                 n_v: int = 56) -> float:
    """Build the corpus at ``path``; returns the seconds it took."""
    print(f"building corpus at {path} ...", flush=True)
    t0 = time.time()
    n = build(path, n_i=n_i, n_v=n_v, seed=seed)
    seconds = time.time() - t0
    print(f"built {n} sequences ({5 * n} pairs) in {seconds:.1f} s",
          flush=True)
    return seconds


def run(args) -> dict:
    """The gate on an existing corpus: ``cli eval hpatches`` in a
    subprocess; returns the record."""
    scratch = tempfile.mkdtemp(prefix="hp540_")
    json_out = os.path.join(scratch, "eval.json")
    cmd = [sys.executable, "-m", "geoformer_tpu_torch.cli", "eval",
           "hpatches", "--data", os.path.abspath(args.corpus), "--ckpt",
           os.path.abspath(args.ckpt), "--json-out", json_out, "--device",
           args.device]
    if args.max_seqs:
        cmd += ["--max-seqs", str(args.max_seqs)]
    if args.max_matches:
        cmd += ["--max-matches", str(args.max_matches)]
    for flag in ("bf16", "pallas", "int8", "int8_full"):
        if getattr(args, flag):
            cmd.append("--" + flag.replace("_", "-"))
    print("running:", " ".join(cmd), flush=True)
    try:
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
        wall = time.time() - t0
        sys.stderr.write((r.stderr or "")[-3000:])
        print(r.stdout[-2500:], flush=True)
        if r.returncode:
            sys.exit(r.returncode)
        with open(json_out) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return {
        "protocol": "hpatches_synth_540",
        "config": {"bf16": args.bf16, "pallas": args.pallas,
                   "int8": args.int8, "int8_full": args.int8_full,
                   "max_matches": args.max_matches or 1024},
        "n_pairs": out.get("n_pairs"),
        "est_failed": out.get("est_failed"),
        "mean_matches": out.get("mean_matches"),
        "auc_a": out.get("auc_a"),
        "auc_i": out.get("auc_i"),
        "auc_v": out.get("auc_v"),
        "mma_i@3": (out.get("mma_i") or {}).get("3"),
        "mma_v@3": (out.get("mma_v") or {}).get("3"),
        "match_time_s": out.get("match_time"),
        "wall_clock_s": round(wall, 1),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="geoformer_tpu_torch.eval.hpatches_protocol",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt",
                    default="checkpoints/tpu_r3_main/params_final.npz")
    ap.add_argument("--corpus", default=None,
                    help="corpus directory (default: a new temporary one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the corpus builder's seed")
    ap.add_argument("--max-seqs", type=int, default=None)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8-full", action="store_true")
    ap.add_argument("--max-matches", type=int, default=None,
                    help="match capacity (default 1024)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    made = args.corpus is None
    if made:
        args.corpus = tempfile.mkdtemp(prefix="hpatches_synth_")
    try:
        if made or not os.path.isdir(args.corpus):
            build_corpus(args.corpus, seed=args.seed)
        rec = run(args)
    finally:
        if made:
            shutil.rmtree(args.corpus, ignore_errors=True)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
