"""Where the time of the port's forward goes on one GPU.

    python -m geoformer_tpu_torch.eval.profile_forward [--trace PATH]

Runs the main path (bench configuration: 480x640, bf16, both GAM kernels;
random weights from seed 0; BATCH synthetic textured pairs of
eval/synthetic.py) and prints:

* the forward's time per pair: host clock around ITERS forwards, each
  ended by a synchronize;
* from torch.profiler over PROFILE_ITERS forwards: the device time
  of each stage (the record_function ranges of GeoFormer.forward), the
  device's busy and idle share of the profiled window, and the kernels
  with the most device time.

The last line is one JSON object with the same numbers. Needs a CUDA
device and raises without one; it never reports a CPU time as a device
time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

BATCH = 2           # pairs per forward, as in chip_smoke.py's main path
ITERS = 10          # timed forwards
PROFILE_ITERS = 3   # profiled forwards
STAGES = ("backbone", "coarse_transformer", "coarse_match_1", "gam",
          "coarse_match_2", "fine")


def _self_device_us(row) -> float:
    """Self device time of a profiler row across torch versions (us)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, name):
            return float(getattr(row, name))
    return 0.0


def _kernel_us(evt) -> float:
    """Device time of the kernels launched under a CPU event, children
    included (microseconds)."""
    return sum(k.duration for k in evt.kernels) + sum(
        _kernel_us(c) for c in evt.cpu_children)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models import GeoFormer

    device = torch.device("cuda", 0)
    cfg = bench_config(use_bf16=True)
    model = weights.random_init(GeoFormer(cfg), seed=0).to(device).eval()
    pairs = [textured_pair((480, 640), s) for s in range(BATCH)]
    i0 = torch.from_numpy(np.stack([a for a, _ in pairs])[..., None]).to(
        device)
    i1 = torch.from_numpy(np.stack([b for _, b in pairs])[..., None]).to(
        device)

    @torch.no_grad()
    def forward():
        gen = torch.Generator(device).manual_seed(0)
        return model(i0, i1, generator=gen)

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        forward()
        torch.cuda.synchronize()
    ms_per_pair = (time.perf_counter() - t0) * 1e3 / (ITERS * BATCH)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(PROFILE_ITERS):
            forward()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    n_fwd = PROFILE_ITERS

    # device activity: kernels, copies and sets (the GPU-side spans of the
    # stage annotations carry the stage names and are left out)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    busy_us = 0.0
    stage_us = dict.fromkeys(STAGES, 0.0)
    for e in prof.events():
        if e.device_type == cuda and e.name not in STAGES:
            busy_us += e.time_range.end - e.time_range.start
        elif e.device_type == cpu and e.name in STAGES:
            stage_us[e.name] += _kernel_us(e)
    stages = {k: (v / 1e3 / n_fwd if v else None)
              for k, v in stage_us.items()}
    # rows of device activity (kernels, copies) by their device time
    kernels = sorted(((r.key, _self_device_us(r) / 1e3 / n_fwd)
                      for r in prof.key_averages()
                      if getattr(r, "device_type", cuda) == cuda
                      and _self_device_us(r) > 0 and r.key not in STAGES),
                     key=lambda kv: -kv[1])[:15]
    if args.trace:
        prof.export_chrome_trace(args.trace)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result = {
        "card": smi, "batch": BATCH, "ms_per_pair": ms_per_pair,
        "forward_ms": ms_per_pair * BATCH,
        "profiled_forward_ms": window_ms / n_fwd,
        "device_busy_ms_per_forward": (busy_us / 1e3 / n_fwd
                                       if busy_us else None),
        "device_idle_share": (1.0 - busy_us / 1e3 / window_ms
                              if busy_us else None),
        "stage_device_ms": stages,
        "top_kernels_ms": kernels,
    }
    print(f"[profile] card={smi} batch={BATCH} "
          f"ms_per_pair={ms_per_pair:.3f} "
          f"profiled_forward_ms={window_ms / n_fwd:.3f}")
    for name in STAGES:
        ms = stages[name]
        print(f"[profile] stage={name} device_ms="
              + ("not measured" if ms is None else f"{ms:.3f}"))
    for name, ms in kernels:
        print(f"[profile] kernel={name[:90]!r} device_ms={ms:.3f}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
