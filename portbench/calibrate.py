"""Readings that a cell's limits and bounds are set from, several seeds in
one process.

    python3 portbench/calibrate.py --workload bench.match-b8 \\
        --seeds 11,12,13 --variant program [--seconds 4]

``program`` runs the cell as the benchmark does (set-up, a short window at
the cell's own load, the check) and prints the numbers the check reads,
one JSON line a seed: the lower readings. ``control`` runs the same with
the program's own lower-precision path switched on: for a bf16
configuration its int8 path (``--int8-full``), for a float32 one TF32.
The ``fault-*`` variants plant a fault in the program (``plant``): in a
matching cell ``fault-half`` leaves the second half of each batch out,
``fault-drop`` drops every second fine match, ``fault-H`` moves the
returned fit by 2 pixels, ``fault-coarse`` moves every second coarse
match of each pass one cell off its pick; in a training cell
``fault-half`` takes each step on half its batch. Their readings are the
upper ones.

``windows`` measures the window alone, for the bounds: one set-up, then
``--windows`` windows of ``--seconds`` back to back, each printed with
the card's clocks, power and temperature after it. Needs a CUDA card,
like the benchmark.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MATCH_FAULTS = ("half", "drop", "H", "coarse")


def control_config(config: dict) -> dict:
    """The configuration with its control's precision: the next one below
    the stated one."""
    if config["use_bf16"]:
        return dict(config, int8_full=True)
    return dict(config, tf32=True)


def _pad(x, b: int):
    """x (a tensor, or tuples of them) padded along its first dimension to
    b with zeros (False)."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.dim() == 0 or x.shape[0] >= b:
            return x
        return torch.cat([x, x.new_zeros((b - x.shape[0],) + x.shape[1:])])
    if isinstance(x, tuple):
        items = [_pad(v, b) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def match_fault(real, kind: str):
    """GeoFormer.forward with a fault planted: ``half`` runs the first half
    of the batch and returns the rest empty; ``drop`` drops every second
    fine match; ``H`` moves the returned fit by 2 pixels along x."""
    import torch

    def forward(self, image0, image1, mask0=None, mask1=None, **kw):
        if kind == "half":
            b = image0.shape[0]
            n = b // 2
            cut = [None if t is None else t[:n]
                   for t in (image0, image1, mask0, mask1)]
            return _pad(real(self, *cut, **kw), b)
        out = real(self, image0, image1, mask0, mask1, **kw)
        if kind == "drop":
            f = out.fine
            valid = f.valid.clone()
            valid[:, 1::2] = False
            return out._replace(fine=f._replace(
                valid=valid, mconf=torch.where(valid, f.mconf,
                                               torch.zeros_like(f.mconf))))
        shift = torch.eye(3, device=out.geo.H.device, dtype=out.geo.H.dtype)
        shift[0, 2] = 2.0
        return out._replace(geo=out.geo._replace(H=shift @ out.geo.H))
    return forward


def coarse_fault(real):
    """coarse_match with a fault planted: every second match of each pass
    moved one cell along image 1's rows, off the pick."""
    def moved(f0, f1, *a, **kw):
        m = real(f0, f1, *a, **kw)
        j = m.j_ids.clone()
        j[:, 1::2] = (j[:, 1::2] + 1) % f1.shape[1]
        return m._replace(j_ids=j)
    return moved


def train_half_batch(real):
    """make_train_step with a fault planted: each step takes the first half
    of its batch and its mean over that half."""
    def broken(tcfg):
        step = real(tcfg)

        def half(state, batch, lr, sample_idx=None, generator=None):
            n = batch["image0"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, lr,
                        generator=generator)
        return half
    return broken


def plant(variant: str, matching: bool) -> None:
    """Plant the fault that ``variant`` (fault-<kind>) names."""
    kind = variant.split("-", 1)[1]
    if matching:
        from geoformer_tpu_torch.models import geoformer

        if kind == "coarse":
            geoformer.coarse_match = coarse_fault(geoformer.coarse_match)
        else:
            geoformer.GeoFormer.forward = match_fault(
                geoformer.GeoFormer.forward, kind)
    else:
        from geoformer_tpu_torch.train import trainer

        assert kind == "half", variant
        trainer.make_train_step = train_half_batch(trainer.make_train_step)


def _card_state() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def windows(cell, config, mix, seed: int, seconds: float, n: int) -> None:
    import importlib

    import torch

    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    run = driver.Run(config, mix, seed, torch.device("cuda", 0), False,
                     lambda m: None)
    t0 = time.perf_counter()
    run.setup()
    print(json.dumps({"seed": seed, "setup_s": time.perf_counter() - t0,
                      "card": _card_state()}), flush=True)
    for w in range(n):
        figures = run.window(seconds)
        print(json.dumps({"seed": seed, "window": w, "seconds": seconds,
                          "figures": figures, "card": _card_state()}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program",
                    choices=("program", "control", "windows")
                    + tuple(f"fault-{k}" for k in MATCH_FAULTS))
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    from portbench import run

    cell, config, mix, bench = run.load_cell(args.workload)
    run._environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.variant == "windows":
        for seed in seeds:
            windows(cell, config, mix, seed, args.seconds, args.windows)
        return 0
    if args.variant == "control":
        config = control_config(config)
    if args.variant.startswith("fault-"):
        plant(args.variant, mix["driver"] == "match")
    limits = {k: float("inf") for k in run.limits_of(cell["name"])}
    for seed in seeds:
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
