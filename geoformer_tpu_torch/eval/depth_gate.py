"""The depth gate: the trained depth model's relative-pose AUC on the
rendered posed-RGBD val corpus.

The JAX record (checkpoints/tpu_r5_depth2/metrics.jsonl, last line; the
`cli train-depth --imsize 640 --batch 4 --depth-pad 640 --pallas` run on
`render_depth_corpus.py --cluttered`, seed 20260820) validated on 8
batches of 4 pairs from the val stream with seed 67 (the loop's seed 66
plus 1): pose-AUC@5/10/20 0.589 / 0.748 / 0.827, prec@5e-04 1.000, 512
matches a pair. This module renders the six val scenes with the port
(data/depth_corpus.py, unless ``--corpus`` holds them already), loads the
checkpoint into the recipe's model, draws the same val batches
(data/megadepth.py) and runs the depth validation (train/depth_loop.py:
the val step, then the on-device essential RANSAC per pair):

    python -m geoformer_tpu_torch.eval.depth_gate [--corpus DIR] \\
        [--device cpu]

It prints one JSON record, the JAX record and the CPU reference beside
it, and exits 1 when a pose AUC is more than GATE_TOL from CPU_REF on
either side, prec@5e-04 is under 0.99 or a pair has fewer than 512 matches.

The host backend (run_depth_validation(pose_backend="host"): the
reference's 5-point RANSAC on the host, eval/pose.py) is held by the same
rule to CPU_REF_HOST, and at most CPU_HOST_FAILED pairs without a pose,
in chip_smoke.py's depth phase; host_fields summarizes the estimator's
ms, RANSAC iterations and failed pairs a sweep records (pose_stats).

CPU_REF is this gate's own sweep on a CPU, on the corpus the port renders
(tests/torch_port_depth_reference.py port). The JAX record is no
two-sided bar: the JAX package's own sweep of the same checkpoint on a
CPU, on the corpus the JAX script renders with cv2, reads
0.815 / 0.861 / 0.883 (the same script, ``jax``), 0.23 above the record
at AUC@5, and this gate on that corpus 0.834 / 0.886 / 0.912. The
two-sided bar on CPU_REF sits above the record less GATE_TOL at every
AUC.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from geoformer_tpu_torch.config import (
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
    TrainConfig,
)
from geoformer_tpu_torch.data import depth_corpus
from geoformer_tpu_torch.data.megadepth import scene_balanced_stream
from geoformer_tpu_torch.eval.selfcheck import load_model
from geoformer_tpu_torch.train.depth_loop import (
    run_depth_validation,
    to_device,
)
from geoformer_tpu_torch.train.optim import make_optimizer
from geoformer_tpu_torch.train.trainer import TrainState, make_depth_val_step

REPO_DIR = Path(__file__).resolve().parent.parent.parent
CKPT = REPO_DIR / "checkpoints" / "tpu_r5_depth2" / "params_final.npz"
JAX_RECORD = {"auc@5": 0.5891861254815012, "auc@10": 0.7475432788254693,
              "auc@20": 0.8268966394127346, "prec@5e-04": 1.0}
# the port's sweep on a CPU (tests/torch_port_depth_reference.py port,
# on the corpus data/depth_corpus.py renders): the card draws the GAM's
# and the pose RANSAC's samples from other streams
CPU_REF = {"auc@5": 0.7930448249680921, "auc@10": 0.8183974124840461,
           "auc@20": 0.831073706242023}
# the same sweep with the host pose estimator, on the matches of the same
# val steps (tests/torch_port_depth_reference.py port), and its pairs
# without a pose
CPU_REF_HOST = {"auc@5": 0.7524903254583478, "auc@10": 0.8449951627291739,
                "auc@20": 0.8912475813645869}
CPU_HOST_FAILED = 0
GATE_TOL = 0.05          # per AUC, on either side of the CPU reference
AUCS = ("auc@5", "auc@10", "auc@20")
PREC_MIN = 0.99
IMSIZE, DEPTH_PAD = 640, 640
BATCHES, BATCH = 8, 4    # the loop's n_val_batches and the recipe's batch
VAL_SEED = 67            # the loop's val stream: seed 66 + 1
N_VAL_SCENES, CORPUS_SEED = 6, 20260820


def recipe_config() -> GeoFormerConfig:
    """The train-depth recipe's model (geoformer_tpu/cli.py:113-119), with
    the GAM kernels (--pallas)."""
    return GeoFormerConfig(
        match=MatchConfig(max_matches=512, force_one_match=True),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=512,
                            use_pallas=True))


def val_batches(corpus: str, device):
    """The record's val batches: BATCHES of BATCH from the stream over
    ``corpus``/index_val with seed VAL_SEED, on ``device``."""
    stream = scene_balanced_stream(
        os.path.join(corpus, "index_val"), corpus, BATCH, VAL_SEED,
        min_overlap_score=0.4, img_resize=IMSIZE, depth_pad=DEPTH_PAD)
    return [to_device(next(stream), device) for _ in range(BATCHES)]


def load_state(device) -> TrainState:
    """The trained checkpoint in the recipe's model, as a train state."""
    model = load_model(recipe_config(), str(CKPT), device)
    return TrainState(model, make_optimizer(TrainConfig().optim,
                                            model.parameters()))


def gate(rec: dict, pose_backend: str = "device") -> bool:
    """Each pose AUC of the validation record ``rec`` within GATE_TOL of the
    backend's CPU reference, prec@5e-04 at least PREC_MIN, 512 matches a
    pair and, on the host backend, at most CPU_HOST_FAILED pairs without a
    pose."""
    host = pose_backend == "host"
    ref = CPU_REF_HOST if host else CPU_REF
    return (all(abs(rec[k] - ref[k]) <= GATE_TOL for k in AUCS)
            and rec["prec@5e-04"] >= PREC_MIN
            and rec["val_num_matches"] >= 512
            and (not host or rec["failed_pairs"] <= CPU_HOST_FAILED))


def host_fields(stats: dict) -> dict:
    """The host estimator's means a pair and failed pairs, of the
    ``pose_stats`` a host-backend run_depth_validation filled."""
    return {"host_ms_per_pair": sum(stats["ms"]) / max(len(stats["ms"]), 1),
            "ransac_iters_per_pair": (sum(stats["iters"])
                                      / max(len(stats["iters"]), 1)),
            "failed_pairs": stats["failed"]}


def depth_gate(corpus: Optional[str] = None, device="cuda") -> dict:
    """The validation record of the trained checkpoint on the val corpus
    (rendered into ``corpus``, or a temporary directory, when it has no
    index_val/), with the JAX record and ``gate_pass``."""
    device = torch.device(device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="depth_gate_") as tmp:
        corpus = corpus or tmp
        if not os.path.isdir(os.path.join(corpus, "index_val")):
            t0 = time.perf_counter()
            depth_corpus.build(corpus, n_scenes=0, n_val_scenes=N_VAL_SCENES,
                               seed=CORPUS_SEED, cluttered=True)
            out["render_s"] = round(time.perf_counter() - t0, 1)
        state = load_state(device)
        vb = val_batches(corpus, device)
        val_fn = make_depth_val_step(TrainConfig(batch_size=BATCH,
                                                 image_hw=(IMSIZE, IMSIZE)))
        t0 = time.perf_counter()
        rec = run_depth_validation(val_fn, state, vb)
        out["validation_s"] = round(time.perf_counter() - t0, 1)
    rec.update(out, pairs=BATCHES * BATCH, jax_record=JAX_RECORD,
               cpu_reference=CPU_REF, gate_tol=GATE_TOL, device=str(device))
    rec["gate_pass"] = gate(rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default=None,
                    help="corpus root with index_val/ (rendered there, or "
                         "into a temporary directory, when absent)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = depth_gate(args.corpus, args.device)
    print(json.dumps(rec))
    return 0 if rec["gate_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
