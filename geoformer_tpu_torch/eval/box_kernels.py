"""Device times of the box-window kernels K1, K5 and K4 on one GPU.

    python3 geoformer_tpu_torch/eval/box_kernels.py [--root DIR] [--label NAME]

Times K5 (f32 and bf16, B=4), K1 (bf16 B=2, f32 B=2 and B=4) and K4 (f32
and bf16, B=4) at the shapes of the main paths (L = S = 4800 on the 60x80
grid, 4 heads of 64) and at three centre patterns: a homography near the
identity with rows pushed off the grid, a collapsing perspective and a zoom
by 2. Each wrapper call is timed on the device by CUDA-graph replay (the
host's time per call does not count), hot and with the L2 cache flushed
before each call. One line per case; the last line is one JSON object
with all of them.

With --root, the package ``geoformer_tpu_torch`` under DIR is timed
instead of this one, so that two versions can be compared on one card in
one run (an unpacked older commit under a directory .gitignore lists; run
old, new, new, old). Run it as a file, as above, so that the package is
imported from the root chosen. chip_smoke.py takes its centre patterns and
graph timers from here. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

GRID_HW = (60, 80)        # coarse grid of a 480x640 image
HEADS, HEAD_DIM = 4, 64   # GAM: d_model 256, 4 heads

# centre patterns besides the homography near the identity: a perspective H
# that crowds the grid's image into a corner (one key covered by ~4000
# queries, as in a train step whose untrained RANSAC fitted a
# near-degenerate H), and a zoom by 2 (each destination cell the centre of
# 4 queries)
COLLAPSED_H = [[1.0, 0.0, 320.0], [0.0, 1.0, 240.0], [0.03, 0.024, 1.0]]
ZOOM_H = [[0.5, 0.0, 160.0], [0.0, 0.5, 120.0], [0.0, 0.0, 1.0]]


def warped_centers(H, b: int, grid_hw) -> torch.Tensor:
    """Box centres as the GAM makes them: each cell's corner pixel warped
    by H (in pixels, 8 a cell), floored to a destination cell."""
    hg, wg = grid_hw
    scale = 8
    H = torch.tensor(H, dtype=torch.float64)
    ids = torch.arange(hg * wg)
    pts = torch.stack([(ids % wg) * scale, (ids // wg) * scale,
                       torch.ones_like(ids)], -1).double()
    w = pts @ H.T
    c = torch.floor((w[:, :2] / w[:, 2:]) / scale).to(torch.int32)
    return c[None].repeat(b, 1, 1)


def homography_centers(b: int, grid_hw) -> torch.Tensor:
    """Warped box centres for a known homography near the identity, with a
    few rows pushed fully and partly off the grid."""
    hg, wg = grid_hw
    centers = warped_centers([[0.95, 0.05, 12.0], [-0.04, 0.98, -6.0],
                              [1e-5, 2e-5, 1.0]], b, grid_hw)
    centers[:, :40] = torch.tensor([-10, -10], dtype=torch.int32)   # off
    centers[:, 40:80, 0] = -1                                      # partly
    centers[-1, 100:140] = torch.tensor([wg + 1, hg + 1], dtype=torch.int32)
    return centers


def centre_patterns(b: int, grid_hw=GRID_HW):
    """(name, centres) of the three patterns: the homography near the
    identity, the collapsing one and the zoom."""
    return (("homography", homography_centers(b, grid_hw)),
            ("collapsed", warped_centers(COLLAPSED_H, b, grid_hw)),
            ("zoom2", warped_centers(ZOOM_H, b, grid_hw)))


def time_graph_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of fn() over iters calls captured in one CUDA graph
    and replayed, so that the host's time per call (Python, allocations,
    launches) does not count; with flush, a write of that tensor before
    each call, whose own time is subtracted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)

    def replay_ms(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                body()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    ms = replay_ms(fn)
    return ms - replay_ms(lambda: None) if flush is not None else ms


def time_graph_cold_ms(fn, iters: int) -> float:
    """time_graph_ms with the L2 cache flushed before each call (a 256 MiB
    write)."""
    flush = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    return time_graph_ms(fn, iters, flush)


# (kernel, dtype, batch) in the order they are timed
CASES = (("K5", torch.float32, 4), ("K5", torch.bfloat16, 4),
         ("K1", torch.bfloat16, 2), ("K1", torch.float32, 2),
         ("K1", torch.float32, 4), ("K4", torch.float32, 4),
         ("K4", torch.bfloat16, 4))


def time_cases(gk, label: str) -> list:
    """One row per (case, pattern) for the kernel module gk."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for which, dtype, b in CASES:
        q, k, v, g = (torch.randn((b, GRID_HW[0] * GRID_HW[1], HEADS,
                                   HEAD_DIM), generator=gen).to(dtype=dtype,
                                                                device=dev)
                      for _ in range(4))
        g = g.float()
        for pattern, centers in centre_patterns(b):
            c = centers.to(dev)
            out, lse = gk.box_window_attention_fwd(q, k, v, c, GRID_HW, 2)
            delta = (g * out.float()).sum(-1)
            fn = {"K1": lambda: gk.box_window_attention_fwd(
                      q, k, v, c, GRID_HW, 2),
                  "K5": lambda: gk.box_window_attention_bwd_dq(
                      q, k, v, c, lse, delta, g, GRID_HW, 2),
                  "K4": lambda: gk.box_window_attention_bwd_dkv(
                      q, k, v, c, lse, delta, g, GRID_HW, 2)}[which]
            row = dict(label=label, kernel=which, dtype=str(dtype)[6:],
                       batch=b, centres=pattern,
                       device_ms=round(time_graph_ms(fn, 20), 5),
                       device_cold_ms=round(time_graph_cold_ms(fn, 10), 5))
            print(" ".join(f"{k_}={v_}" for k_, v_ in row.items()),
                  flush=True)
            rows.append(row)
        del q, k, v, g
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the geoformer_tpu_torch to time")
    ap.add_argument("--label", default="", help="label of each output line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("box_kernels needs a CUDA device")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from geoformer_tpu_torch.ops import cuda_lib
    from geoformer_tpu_torch.ops import gam_kernels as gk

    if not gk.__file__.startswith(root):
        raise RuntimeError(f"imported {gk.__file__}, not the package under "
                           f"{root}: run this file as a script")
    info = cuda_lib.build()
    cuda_lib.load_library()
    print(f"label={args.label} root={root} build_s={info.seconds:.1f} "
          f"card={torch.cuda.get_device_name(0)}", flush=True)
    rows = time_cases(gk, args.label or root)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
