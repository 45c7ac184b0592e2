"""Readings that the depth cell's limits are set from, several seeds in one
process (portbench/calibrate.py's readings, with the depth cell's fault).

    python3 portbench/calibrate_depth.py --seeds 11,12,13 \\
        --variant program [--seconds 4]

``program`` runs depth.train-b4 as the benchmark does (set-up, a short
window, the check) and prints the numbers the check reads, one JSON line a
seed: the lower readings. ``control`` runs it with TF32 on (the precision
below the configuration's float32, calibrate.control_config).
``fault-scale`` plants a fault in the depth supervision (``scale_fault``):
the GT taken without ``scale0``/``scale1``, that is at the resized
resolution against depth and intrinsics at the original one. The control
and the fault give the upper readings. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "depth.train-b4"


def scale_fault(real):
    """trainer._depth_losses with a fault planted: the batch's scale0 and
    scale1 dropped, so that the GT is taken at the resized resolution."""
    def dropped(out, batch, *a, **kw):
        return real(out, {k: v for k, v in batch.items()
                          if k not in ("scale0", "scale1")}, *a, **kw)
    return dropped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program",
                    choices=("program", "control", "fault-scale"))
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    from portbench import calibrate, run

    cell, config, mix, bench = run.load_cell(WORKLOAD)
    run._environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate_depth: needs a CUDA card", file=sys.stderr)
        return 2
    if args.variant == "control":
        config = calibrate.control_config(config)
    if args.variant == "fault-scale":
        from geoformer_tpu_torch.train import trainer

        trainer._depth_losses = scale_fault(trainer._depth_losses)
    limits = {k: float("inf") for k in run.limits_of(WORKLOAD)}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run.execute(cell, config, mix, bench, seed, args.seconds,
                          False, torch.device("cuda", 0), t_start=t0,
                          limits=limits, log=lambda m: None)
        numbers = {k: c["value"] for k, c in res["checks"].items()}
        numbers.update(res["record"])
        print(json.dumps({"variant": args.variant, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
