#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geoformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:

1. device: card name and power limit, torch and CUDA versions, the nvcc
   build of the CUDA kernels (geoformer_tpu_torch/csrc/*.cu), TF32 off;
2. kernels: the forward kernels K1 and K2 against their plain PyTorch
   versions on the card at the inference path's shapes (B=2), in bf16 and
   f32, with the stated tolerance, and the kernel's, the plain version's
   and one library call's times beside the kernel's bound; K1 also at
   three centre patterns (eval/box_kernels.py: a homography near the
   identity with off-grid rows, a collapsing perspective, a zoom by 2),
   against the plain version with the off-grid rows' contract, the same
   bits twice, timed hot and with L2 flushed, with its load (the most
   queries in one destination tile, the pieces); K2 also with the same
   live counts packed first (the GAM's prefix mask) and at the training
   path's shape (B=4, S=512, f32); K6, the streamed match extraction,
   against the plain chunked loop at the matcher's shape (B=8 and B=4,
   L=S=5120 of a 64x80 grid with rows 60-63 masked, C=256, f32), its ms
   a call beside the plain loop's and its bound (3xTF32);
3. main path: the port's BatchedMatcher at full width, bf16, 480x640, the
   bench configuration, random weights from a seed, on a textured image and
   its warp by a known homography; the launch counts of the kernels are
   read around the run. One more request with the same weights at a low
   coarse threshold gives the GAM real inliers and a homography. Then, at
   a small size in f32, the forward through the kernels is held against
   the same forward through their plain versions on the same card;
4. backward kernels: K3, K4 and K5 against their plain backwards at the
   training path's shapes (B=4, L=4800; S=512 for K3), f32 and bf16, with
   the same numbers as phase 2 (library: the backward of
   scaled_dot_product_attention with the same boolean mask); K3 is timed
   from K2's output and row statistics, as the train step runs it, and
   also on the prefix mask; K4 and K5 also at the three centre patterns
   (for K4 the collapsing one covers one key by ~4000 queries), each
   against the plain backward, the same bits twice, timed hot and with L2
   flushed, with its load (K4: the most queries covering one key; K5: as
   K1's), and K1 there at the training path's shape (B=4, f32);
5. training path: run_training at the headline recipe (480x640, f32,
   batch 4, random weights, the procedural bank of 256 textures), one
   warm-up step and three timed ones, with the launch counts of K1-K5 read
   around it; one profiled step, whose K1, K4 and K5 calls are then timed
   alone on their own inputs, hot and cold, beside their load; one step at a
   low coarse threshold where RANSAC finds a homography and the cross
   layers' gradients go through K4/K5;
6. train parity: at 120x160 in f32 with full widths, one train step
   through the kernels against the same step through their plain versions
   on the same card (loss and every parameter gradient);
7. eval path: image files written by the script (an 8-bit PNG and a P6
   PPM of a textured pair, a 2-sequence HPatches fixture at 600x800) are
   decoded back byte for byte, then ``infer`` through the command line, the
   HPatches driver (imsize 480) and the homography fit run on the card
   with phase 3's live-GAM model (random weights, bf16, K1 and K2), with
   the launch counts read around each and the ms per pair of decoding,
   forward and fit;
8. eval trained: when checkpoints/tpu_r3_main/params_final.npz is there,
   the self-check (40 pairs of 480x640, procedural and the held-out
   photographs) through K1 and K2 in f32 and in bf16, each AUC held to its
   CPU reference; when it is not, one line says so;
9. training loop: run_training at the headline recipe with every option of
   the loop on (state checkpoints every 2 steps, validation every 2 steps,
   TensorBoard events and match figures, the sensor stack, bank refresh
   every 3 batches) for 4 steps, then resumed to 6: the restored state
   against the first run's bit for bit, the checkpoint directories, the
   metrics.jsonl steps and the event files (read back with the port's
   reader), K1-K5 at 4 launches a train step and K1/K2 at 4 (K3-K5 at 0)
   a val step, the ms of each train and val step, checkpoint save and
   restore, and bank build; one `cli train --pallas` in a subprocess; and,
   when the trained checkpoint is there, the val step on it through K1/K2
   over three RANSAC seeds, held to the same steps on the host's CPU on the
   same batch (the bar: the CPU runs' spread over the seeds, or a stated
   floor where that is narrower);
10. FIRE/ISC from JPEG: when the trained checkpoint is there, the standing
   FIRE/ISC gate's corpora (eval/fire_isc_protocol.py) built at full size
   into a temporary directory (a stated subset: 7 FIRE pairs at 1024^2, 8
   ISC pairs, 16 classification lines), every JPEG decoded, the decoder's
   round trips at q95 held to the quantisation bounds, then `cli eval
   fire`, `eval isc` and `eval isc-cls` in bf16 through K1 and K2, held
   to the gate's thresholds (FIRE mAUC >= 0.99 with no failed pair, ISC
   AUC@3 >= 0.97, EER <= 0.05), 4 launches of K1 and K2 a forward, the ms
   per pair of decoding, resizing, forward and fit; and K1 and K2 against
   their plain versions at the FIRE grid (B=1, 96x96) and a portrait ISC
   bucket (B=2, 72x64), each beside its bound;
11. released checkpoint and serving: when the trained checkpoint is
   there, a Lightning-style torch checkpoint made from it
   (eval/parity_drill.py) loaded through the converter, its weights and
   its forward held bit-equal to the npz's; a cut of the HPatches gate's
   corpus (eval/hpatches_synth.py: 6 sequences, 30 pairs, two changing
   size) built into a temporary directory; the gate module
   (eval/hpatches_protocol.py, in its own process) and the parity drill
   (`cli parity` on the torch checkpoint) in bf16 through K1 and K2, held
   to the reference README's AUC block and to each other, 4 launches of
   K1 and K2 a forward, the ms per pair by part; `cli infer --draw
   --draw-geo`, the figures read back at the canvas's size; a serving
   bundle (torch.export, 480x640, B=2) exported on the card and run in a
   fresh process that imports no model code, launching K1 and K2, its
   valid matches equal to the eager forward's with the same RANSAC noise
   and its keypoints within 1e-4 px, its ms per call beside the eager
   BatchedMatcher's.
12. depth: the depth-supervised path at the JAX record's recipe (`cli
   train-depth --imsize 640 --batch 4 --depth-pad 640 --pallas`, f32):
   the cluttered corpus's 6 val scenes and 2 train scenes rendered by the
   port (data/depth_corpus.py) into a temporary directory, its JPEG and
   HDF5 read times; run_depth_training from random weights for 4 steps
   with a 1-batch validation, K1-K5 at 4 launches a train step and K1/K2
   at 4 (K3-K5 at 0) a val step, its files, ms per step and peak memory;
   `cli train-depth` in a subprocess; the gate on the trained depth
   checkpoint (eval/depth_gate.py: 8 batches of 4 from the val stream),
   each pose AUC within 0.05 of the port's CPU sweep on the same corpus,
   with the JAX record beside it, prec@5e-04 >= 0.99 and 512 matches a
   pair, with the pose estimator's ms and host synchronisations per
   batch; the same batches through the host pose estimator
   (pose_backend="host", eval/pose.py), K1/K2 at 4 a val step, each AUC
   within 0.05 of the port's CPU sweep with that backend (CPU_REF_HOST),
   no more pairs without a pose than that sweep, its ms and RANSAC
   iterations a pair beside the card's name and power limit; the host
   estimator's fixed check on the CPU tests' synthetic sets (solution
   counts, inliers and iterations as on a CPU); K1 and K2 at the 80x80
   grid on the gate's own inputs against
   their plain versions; one depth train step of the trained checkpoint
   on a val batch, where RANSAC finds homographies and the cross layers
   get gradients through K4/K5; and K3, K4 and K5 against their plain
   backwards on that step's inputs (the 80x80 grid, 20 rows padded);
13. localization and SLAM: when the trained checkpoint is there, the
   standing ATE gate (eval/ate_protocol.py: 12 frames of 480x640, loop
   stride 5, `cli slam`, optimized corner drift <= 3.0 px) and the
   localization gate (eval/localize_protocol.py: the 3-plane scene, 8 db
   and 4 query images at 480x640, `cli localize` in the SfM mode and, on
   the same scene with the db images' depth scans, the dense mode;
   recall@(5 m, 10 deg) = 1.0 in each), the three commands in their own
   processes at once in bf16 through K1 and K2, each record beside the
   JAX record and the port's CPU run; then the planar SLAM and the SfM
   localization driver in this process on the same files: K1 and K2 at 4
   launches a forward (K3-K5 none), the ms of decoding, forward, fit,
   graph solve and PnP, the host syncs of each fit, graph solve and PnP
   query, the card's PnP (each query, the same injected samples) and
   SL(3) graph solve against the same calls on the host's CPU, and K1 and
   K2 against their plain versions on one localization pair's inputs;
14. int8 and alternates: the eval-only `--int8` and `--int8-full`
   forwards (the bench configuration, B=2, 480x640, random weights) with
   K1 and K2 at 4 launches a forward and a request at coarse threshold
   1e-6 for each, their ms per pair beside phase 3's bf16; at every
   distinct int8 product shape of the `--int8-full` forward the card's
   int32 accumulation (torch._int_mm) equal to the exact product, with the
   int8 call's ms beside the bf16 cuDNN/cuBLAS call's; when the trained
   checkpoint is there, the 40-pair self-check with `--int8` and
   `--int8-full` in bf16 through K1/K2, each AUC held to the port's CPU
   reference (the JAX TPU record beside it); the sinkhorn matcher's
   forward at full width through K1/K2 with its peak memory, and, at
   120x160 in f32, the sinkhorn and `--int8-full` forwards through the
   kernels against their plain versions; the (16, 4) ladder and plain
   LoFTR at 480x640, timed.
15. data parallelism and the engine: (a) run_training at the headline
   recipe (480x640, f32, TF32 off, max_matches 512, 256 hypotheses, 512
   inliers, K1-K5) at a global batch of 4 from seed 66 for 2 steps, on two
   ranks of 2 pairs on the one card (spawned, gloo on CUDA tensors: NCCL
   refuses two ranks on one device) against one process at batch 4: each
   step's loss and grad norm within 1e-3, the update within the train-step
   test's relative-L2 bars, the BatchNorm statistics within 1e-4 and
   equal on both ranks, K1-K5 4 times a step on each rank, rank 0 alone
   logging; the ms a step, the gradient all-reduce's ms and the peak
   memory of each rank; (b) `cli train --pallas` under `torchrun
   --nproc-per-node 1` (NCCL, world size 1) for 2 steps at 120x160; (c)
   ba_solve (plain and Huber), ba_solve_cg, optimize_pose_graph and
   align_umeyama / ate_rmse on CUDA tensors against the same calls on the
   CPU, and ba_solve_sharded / ba_solve_points_sharded on two gloo ranks
   on the card against one process, compared where the problem fixes the
   solution (camera 0 alone frozen leaves the scale free).
16. sequence parallelism (one pair's rows split over the ranks of a seq
   group, core/spmd.py), two gloo ranks on the one card: (a) the bench
   configuration's forward (bf16, K1 and K2, the trained checkpoint) of a
   textured pair at 480x640 and at 1920x2560 against one process with the
   same RANSAC uniforms: match overlap >= 0.9 with >= 90 % of the common
   keypoints within 0.05 px, has_H equal, H within 1e-2, the coarse
   transformer's features within 2e-2 of the largest and the GAM's
   within 1e-1 (bf16), K1 and K2 4 times a forward on each rank; the ms
   a pair and the peak memory of each rank beside one process's; (b) the
   headline recipe's train step (f32, TF32 off, K1-K5, random weights and
   batch 2 from seed 66, the first step at LR 0) twice on two ranks
   against one process at phase 15's bars, K1-K5 4 times a step on each
   rank; (c) `cli infer --seq-shard 2` on the one card refuses (one card
   a rank under NCCL) and `--seq-shard 1` runs.

Phases 10, 12 and 13 time K1 on their own inputs beside its plain
version and the library call (SDPA under the dense box mask); phase 12
also K4 and K5 on the depth step's inputs beside the plain backward and
SDPA's backward.

K1, K4 and K5 (a plan and then the pieces, several launches a call) and
K2 (and SDPA beside it) are timed on the device by CUDA-graph replay
(kernel_ms), beside the time per call of an eager loop by CUDA events
(call_ms), which also holds the host's time per call (the custom op's
dispatch among it) where that is the longer; K3, ~0.5-0.8 ms a call, by
the event loop.

Phases 1-7 read no data file: weights come from a seed and images from
numpy (phase 7 decodes only files it wrote). Phase 8 reads the trained
checkpoint and the held-out photographs through the port's own loaders,
phases 9, 14 and 16 the checkpoint; phase 9 writes only under a
temporary directory, as phases 10-13 do (their corpora, checkpoint,
figures, bundle, scene and sequence are made there and read back).
Phase 12 reads checkpoints/tpu_r5_depth2.
It needs only the standard library, torch and numpy. Any failure
raises, so the exit code is nonzero; with no CUDA device it stops in
phase 1. The last line of a successful run is one JSON object naming the
device; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()

# One NVIDIA H100 SXM, published dense peaks (NVIDIA data sheet). f32 on
# the CUDA cores is 67 TFLOP/s; f32 products at f32 accuracy on the tensor
# cores (3xTF32: three TF32 products each) reach 495 / 3 TFLOP/s, the rate
# of K2's and K3's f32 path.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_FLOPS_3XTF32 = 495e12 / 3

KERNEL_B = 2
GRID_HW = (60, 80)        # coarse grid of a 480x640 image
HEADS, HEAD_DIM = 4, 64   # GAM: d_model 256, 4 heads
MAX_INLIERS = 1024        # bench configuration's self-attention KV capacity
TOL = {  # kernel vs plain version on the card, max abs error
    # K1 writes out in the input type: both sides round an f32 result to
    # bf16, so they may differ by one bf16 ulp (2^-6 for |x| < 4).
    ("box_window_attention", torch.bfloat16): 2e-2,
    # f32: the same 25-term online softmax, summed in another order.
    ("box_window_attention", torch.float32): 1e-5,
    # K2 computes and writes f32 from the same inputs; only the order of
    # the 1024-term sums differs.
    ("masked_kv_attention", torch.bfloat16): 1e-4,
    ("masked_kv_attention", torch.float32): 1e-4,
}
LSE_TOL = 1e-4  # K1's f32 LSE, |lse| < 20 on in-grid rows


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(phase: str, **kw) -> None:
    fields = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[{phase}] {fields}", flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 1 ------

def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    check(torch.cuda.is_available(), "no CUDA device: the port runs on the "
          "card only (the CPU tests cover its plain versions)")
    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from geoformer_tpu_torch.ops import cuda_lib

    lib_info = cuda_lib.build()
    cuda_lib.load_library()
    ptxas = [ln.strip() for ln in lib_info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("device", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), build_s=f"{lib_info.seconds:.2f}",
        cached=lib_info.cached, lib=lib_info.path.name,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32)
    for ln in ptxas:
        log("ptxas", line=repr(ln))
    return card


# ------------------------------------------------------------ phase 2 ------

def _rand(shape, gen, dtype, device):
    return torch.randn(shape, generator=gen).to(dtype=dtype, device=device)


def phase_kernels(device):
    from geoformer_tpu_torch.ops import gam_kernels as gk

    from geoformer_tpu_torch.eval import box_kernels as bk
    gen = torch.Generator().manual_seed(0)
    b = KERNEL_B
    hg, wg = GRID_HW
    s = hg * wg
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        # ---- K1: box-window attention, L = S = 4800
        q, k, v = (_rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
                   for _ in range(3))
        centers = bk.homography_centers(b, GRID_HW).to(device)
        out, lse = gk.box_window_attention_fwd(q, k, v, centers, GRID_HW, 2)
        ref, ref_lse = gk.box_window_attention_plain(q, k, v, centers,
                                                     GRID_HW, 2)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs()
        valid = ref_lse > -1e6
        lse_valid_err = lse_err[valid].max().item()
        lse_off_equal = bool(torch.equal(lse[~valid], ref_lse[~valid]))
        off = ~valid
        off_zero = bool((out[off.any(-1)] == 0).all())
        tol = TOL[("box_window_attention", dtype)]
        log("kernels", name="box_window_attention", dtype=str(dtype),
            shape=f"q{tuple(q.shape)}", max_abs_err=f"{err:.3e}",
            tol=tol, lse_max_abs_err=f"{lse_valid_err:.3e}",
            lse_tol=LSE_TOL, offgrid_rows=int(off.any(-1).sum()),
            offgrid_out_zero=off_zero, offgrid_lse_equal=lse_off_equal)
        check(err <= tol, f"K1 {dtype}: out error {err} > {tol}")
        check(lse_valid_err <= LSE_TOL, f"K1 {dtype}: lse error "
              f"{lse_valid_err} > {LSE_TOL}")
        check(off_zero and lse_off_equal,
              f"K1 {dtype}: off-grid rows differ from the contract")
        cells = _box_cells(centers, GRID_HW, 2)
        flops = 4.0 * HEAD_DIM * HEADS * cells
        nbytes = (4 * q.numel() * q.element_size() + centers.numel() * 4
                  + lse.numel() * 4)
        bound, by = _bound(nbytes, flops, dtype)
        call_ms = time_ms(lambda: gk.box_window_attention_fwd(
            q, k, v, centers, GRID_HW, 2), 50)
        ms = bk.time_graph_ms(lambda: gk.box_window_attention_fwd(
            q, k, v, centers, GRID_HW, 2), 50)
        plain_ms = time_ms(lambda: gk.box_window_attention_plain(
            q, k, v, centers, GRID_HW, 2), 3, warmup=1)
        box = _dense_box(centers, GRID_HW, 2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             qt, kt, vt, attn_mask=box[:, None]), 5)
        del box
        log("kernels", name="box_window_attention", dtype=str(dtype),
            kernel_ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=by)
        results[("box_window_attention", dtype)] = dict(
            max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound, bound_by=by)
        for pattern, cen in bk.centre_patterns(b, GRID_HW):
            _box_fwd_case(gk, q, k, v, cen.to(device), pattern)
        del q, k, v, out, ref

        # ---- K2: masked-KV attention, L = 4800, S = 1024, one row masked
        q = _rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
        k, v = (_rand((b, MAX_INLIERS, HEADS, HEAD_DIM), gen, dtype, device)
                for _ in range(2))
        mask = (torch.rand((b, MAX_INLIERS), generator=gen) < 0.6)
        mask[-1] = False                          # RANSAC found no inliers
        mask = mask.to(device)
        results[("masked_kv_attention", dtype)] = _mka_fwd_case(
            gk, q, k, v, mask, "random")
        _mka_fwd_case(gk, q, k, v, _prefix_like(mask), "prefix")
        del q, k, v
        torch.cuda.empty_cache()
    _mka_live_sweep(gk, device, torch.bfloat16, KERNEL_B, MAX_INLIERS,
                    (0, 64, 256, 1024))
    # ---- K2 at the training path's shape: B=4, S=512, f32
    gen = torch.Generator().manual_seed(2)
    q = _rand((TRAIN_B, s, HEADS, HEAD_DIM), gen, torch.float32, device)
    k, v = (_rand((TRAIN_B, TRAIN_INLIERS, HEADS, HEAD_DIM), gen,
                  torch.float32, device) for _ in range(2))
    mask = torch.rand((TRAIN_B, TRAIN_INLIERS), generator=gen) < 0.6
    mask[-1] = False
    mask = mask.to(device)
    _mka_fwd_case(gk, q, k, v, mask, "random")
    _mka_fwd_case(gk, q, k, v, _prefix_like(mask), "prefix")
    del q, k, v
    torch.cuda.empty_cache()
    # ---- K6: the streamed extraction at the match cell's B and training's
    results[("streaming_match_extract", torch.float32)] = _extract_case(
        device, 8)
    _extract_case(device, TRAIN_B)
    torch.cuda.empty_cache()
    return results


# K6 at the matcher's shape: 480x640 padded to 512x640, a 64x80 coarse grid
# whose rows 60-63 are masked, C = 256, features f32 (TF32 off)
EXTRACT_GRID = (64, 80)
EXTRACT_C = 256
# K6's ids against the plain loop's on seeded features: both compute f32
# values ~1e-5 apart (the plain loop's own f32 error at this shape), so a
# pick may flip at a near-tie; tests/test_torch_port_cuda.py holds those
# to the plain values' top two. row_best relative to the plain loop's.
EXTRACT_FLIPS = 1e-4
EXTRACT_RB_TOL = 5e-5


def _extract_case(device, b):
    """K6 (streaming_match_extract on the card: two ops, four launches)
    against the plain chunked loop at the matcher's shape, B pairs: the
    picks, row_best and conf00, the call's device time beside the plain
    loop's and the bound (2 passes x 2 B L S C operations in 3xTF32)."""
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.ops import streaming_match as sm

    hg, wg = EXTRACT_GRID
    n = hg * wg
    gen = torch.Generator().manual_seed(7 + b)
    f0 = torch.randn((b, n, EXTRACT_C), generator=gen)
    f1 = torch.randn((b, n, EXTRACT_C), generator=gen)
    f1[:, :n // 2] = f0[:, :n // 2] + 0.3 * torch.randn(
        (b, n // 2, EXTRACT_C), generator=gen)
    f0, f1 = f0.to(device), f1.to(device)
    mask = (torch.arange(n) < 60 * wg).float().expand(b, n).to(device)

    def kernel():
        return sm.streaming_match_extract(f0, f1, 0.1, mask, mask)

    with torch.no_grad():
        gk.reset_launch_counts()
        got = kernel()
        launches = gk.LAUNCHES["streaming_match_extract"]
        with plain_kernels():
            ref = kernel()
            plain_ms = time_ms(kernel, 3, warmup=1)
        torch.cuda.synchronize()
        ms = time_ms(kernel, 20)
    rb_rel = ((got[0] - ref[0]).abs() / ref[0].abs()).max().item()
    rb_abs = (got[0] - ref[0]).abs().max().item()
    j_flips = (got[1] != ref[1]).float().mean().item()
    col_flips = (got[2] != ref[2]).float().mean().item()
    c00 = ((got[3] - ref[3]).abs() / ref[3].abs().clamp_min(1e-30)).max()
    flops = 2 * 2.0 * b * n * n * EXTRACT_C
    nbytes = 2 * f0.numel() * 4 + 2 * mask.numel() + b * n * (4 + 8) * 2
    bound, by = _bound(nbytes, flops, torch.float32, PEAK_FLOPS_3XTF32)
    log("kernels", name="streaming_match_extract", dtype="torch.float32",
        shape=f"f({b}, {n}, {EXTRACT_C}) rows>={60 * wg} masked",
        launches_a_call=launches, row_best_max_rel=f"{rb_rel:.3e}",
        rb_tol=EXTRACT_RB_TOL, j_flip_share=f"{j_flips:.2e}",
        col_flip_share=f"{col_flips:.2e}", flip_max=EXTRACT_FLIPS,
        conf00_max_rel=f"{c00.item():.3e}", kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=None,
        bound_ms=f"{bound:.4f}", bound_by=by,
        bound_share=f"{100 * bound / ms:.1f}%")
    check(launches == 1, f"K6: {launches} counts in one call")
    check(rb_rel <= EXTRACT_RB_TOL, f"K6 B={b}: row_best off by {rb_rel}")
    check(j_flips <= EXTRACT_FLIPS and col_flips <= EXTRACT_FLIPS,
          f"K6 B={b}: picks differ ({j_flips}, {col_flips})")
    return dict(max_abs_err=rb_abs, ms=ms, call_ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound, bound_by=by)


def _prefix_like(mask):
    """The same live count in each batch row, packed first, as the GAM's
    masked_select_capacity packs its inliers."""
    n = mask.sum(dim=1, keepdim=True)
    return torch.arange(mask.shape[1], device=mask.device)[None] < n


def _mka_live_sweep(gk, device, dtype, b, s, counts, backward=False):
    """K2 (or K3, from K2's statistics) on prefix masks with the same live
    count in every batch row, for the time's dependence on that count;
    each run is held against the plain version. K2 is timed by CUDA-graph
    replay (its device time is near the host's time per call)."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(3)
    l = GRID_HW[0] * GRID_HW[1]
    q = _rand((b, l, HEADS, HEAD_DIM), gen, dtype, device)
    k, v = (_rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
            for _ in range(2))
    g = _rand((b, l, HEADS, HEAD_DIM), gen, torch.float32, device)
    ms, errs = [], []
    for n in counts:
        mask = (torch.arange(s) < n)[None].expand(b, s).contiguous().to(
            device)
        if backward:
            out, st = gk.masked_kv_attention_fwd(q, k, v, mask,
                                                 return_stats=True)
            got = gk.masked_kv_attention_bwd(q, k, v, mask, g, out=out,
                                             stats=st)
            ref = gk.masked_kv_attention_bwd_plain(q, k, v, mask, g)
            errs.append(max(_rel_err(a, r) for a, r in zip(got, ref)))
            ms.append(time_ms(lambda: gk.masked_kv_attention_bwd(
                q, k, v, mask, g, out=out, stats=st), 10))
        else:
            out = gk.masked_kv_attention_fwd(q, k, v, mask)
            ref = gk.masked_kv_attention_plain(q, k, v, mask)
            errs.append((out - ref).abs().max().item())
            ms.append(bk.time_graph_ms(lambda: gk.masked_kv_attention_fwd(
                q, k, v, mask), 20))
    name = "masked_kv_attention" + ("_bwd" if backward else "")
    tol = BWD_TOL[dtype] if backward else TOL[(name, dtype)]
    log("bwd_kernels" if backward else "kernels", name=name,
        dtype=str(dtype), sweep="prefix", shape=f"q{tuple(q.shape)}"
        f"k{tuple(k.shape)}", live_keys_per_row=list(counts),
        kernel_ms=[f"{x:.4f}" for x in ms],
        err=[f"{x:.3e}" for x in errs], tol=tol,
        seconds=f"{time.perf_counter() - t0:.1f}")
    check(max(errs) <= tol, f"{name} {dtype} prefix sweep: error "
          f"{max(errs)} > {tol}")


def _mka_fwd_case(gk, q, k, v, mask, kind):
    """K2 against its plain version on one mask: the error, the rows with
    no kept key against the mean of V, and the kernel's, the plain
    version's and SDPA's times beside the bound of this mask's work."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    t0 = time.perf_counter()
    dtype = q.dtype
    b, s = mask.shape
    out = gk.masked_kv_attention_fwd(q, k, v, mask)
    ref = gk.masked_kv_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    n_keep = mask.sum(dim=1).double()
    dead = (n_keep == 0).to(device=q.device)
    mean_v = v.float().mean(dim=1, keepdim=True)                # [B, 1, H, D]
    masked_err = ((out[dead] - mean_v[dead]).abs().max().item()
                  if bool(dead.any()) else 0.0)
    tol = TOL[("masked_kv_attention", dtype)]
    log("kernels", name="masked_kv_attention", dtype=str(dtype), mask=kind,
        shape=f"q{tuple(q.shape)}k{tuple(k.shape)}",
        out_dtype=str(out.dtype), max_abs_err=f"{err:.3e}", tol=tol,
        all_masked_row_vs_mean_v=f"{masked_err:.3e}")
    check(out.dtype == torch.float32, "K2 must return f32")
    check(err <= tol, f"K2 {dtype} {kind}: error {err} > {tol}")
    check(masked_err <= tol, f"K2 {dtype} {kind}: all-masked row is not the "
          f"mean of V ({masked_err})")
    l = q.shape[1]
    flops = float((4.0 * HEAD_DIM * HEADS * l * n_keep).sum()
                  + (n_keep == 0).sum() * s * HEAD_DIM * HEADS)
    nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
              + mask.numel() + out.numel() * 4)
    bound, by = _bound(nbytes, flops, dtype, PEAK_FLOPS_3XTF32)
    # the same call with every key live, for a bound that is not this
    # mask's: every query scores every key
    bound_live, by_live = _bound(nbytes, 4.0 * HEAD_DIM * HEADS * l * s * b,
                                 dtype, PEAK_FLOPS_3XTF32)
    # device times by CUDA-graph replay, the kernel's and SDPA's alike: at
    # ~0.05 ms a call an eager loop measures the host's time per call
    # (call_ms) as much as the device's
    run = lambda: gk.masked_kv_attention_fwd(q, k, v, mask)  # noqa: E731
    ms = bk.time_graph_ms(run, 20)
    call_ms = time_ms(run, 20)
    plain_ms = time_ms(lambda: gk.masked_kv_attention_plain(q, k, v, mask), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    am = mask[:, None, None, :]
    lib_ms = bk.time_graph_ms(lambda: torch.nn.functional.
                              scaled_dot_product_attention(qt, kt, vt,
                                                           attn_mask=am), 20)
    log("kernels", name="masked_kv_attention", dtype=str(dtype), mask=kind,
        kernel_ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
        bound_by=by, live_keys=[int(n) for n in n_keep.tolist()],
        bound_all_live_ms=f"{bound_live:.4f}", bound_all_live_by=by_live,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


def _box_cells(centers, grid_hw, r) -> float:
    """In-grid cells summed over all (batch, query) boxes."""
    hg, wg = grid_hw
    cx, cy = centers[..., 0].long(), centers[..., 1].long()
    nx = (torch.minimum(cx + r, torch.tensor(wg - 1, device=cx.device))
          - torch.maximum(cx - r, torch.tensor(0, device=cx.device)) + 1)
    ny = (torch.minimum(cy + r, torch.tensor(hg - 1, device=cy.device))
          - torch.maximum(cy - r, torch.tensor(0, device=cy.device)) + 1)
    return float((nx.clamp(min=0) * ny.clamp(min=0)).sum())


def _dense_box(centers, grid_hw, r):
    hg, wg = grid_hw
    sidx = torch.arange(hg * wg, device=centers.device)
    return (((sidx % wg)[None, None] - centers[..., 0:1]).abs() <= r) & \
        (((sidx // wg)[None, None] - centers[..., 1:2]).abs() <= r)


def _gather_load(gk, centers, grid_hw) -> dict:
    """K1's and K5's work on these centres: the queries whose box meets
    the grid, the most queries in one destination tile, the tiles with
    any, and the pieces (blocks of one head) over all batch rows."""
    n, _, base = gk.box_gather_schedule(centers, grid_hw, 2)
    return dict(on_grid=int(n.sum()), max_per_tile=int(n.max()),
                tiles_with_any=int((n > 0).sum()),
                pieces=int(base[:, -1].sum()))


def _offgrid_rows(centers, grid_hw, r=2):
    """[B, L] rows whose box misses the grid."""
    hg, wg = grid_hw
    cx, cy = centers[..., 0], centers[..., 1]
    return (cx + r < 0) | (cx - r > wg - 1) | (cy + r < 0) | (cy - r > hg - 1)


def _box_fwd_case(gk, q, k, v, centers, pattern):
    """K1 alone on one centre pattern: against the plain version (out,
    in-grid LSE, the off-grid rows' contract), the same bits twice, ms hot
    and with L2 flushed, the bound, the load."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    t0 = time.perf_counter()
    dtype = q.dtype

    def run():
        return gk.box_window_attention_fwd(q, k, v, centers, GRID_HW, 2)

    got, again = run(), run()
    ref, ref_lse = gk.box_window_attention_plain(q, k, v, centers, GRID_HW, 2)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    out, lse = got
    err = (out.float() - ref.float()).abs().max().item()
    off = _offgrid_rows(centers, GRID_HW)
    lse_err = ((lse - ref_lse)[~off].abs().max().item()
               if bool((~off).any()) else 0.0)
    off_ok = bool((out[off] == 0).all()) and bool(
        torch.equal(lse[off], ref_lse[off]))
    tol = TOL[("box_window_attention", dtype)]
    cells = _box_cells(centers, GRID_HW, 2)
    nbytes = (4 * q.numel() * q.element_size() + centers.numel() * 4
              + lse.numel() * 4)
    bound, by = _bound(nbytes, 4.0 * HEAD_DIM * HEADS * cells, dtype)
    ms = bk.time_graph_ms(run, 50)
    cold_ms = bk.time_graph_cold_ms(run, 10)
    call_ms = time_ms(run, 50)
    log("kernels", name="box_window_attention", dtype=str(dtype),
        centres=pattern, shape=f"q{tuple(q.shape)}",
        max_abs_err=f"{err:.3e}", tol=tol, lse_max_abs_err=f"{lse_err:.3e}",
        lse_tol=LSE_TOL, offgrid_rows=int(off.sum()), offgrid_contract=off_ok,
        same_bits_twice=same_bits, kernel_ms=f"{ms:.4f}",
        kernel_cold_ms=f"{cold_ms:.4f}", call_ms=f"{call_ms:.4f}",
        bound_ms=f"{bound:.4f}",
        bound_by=by, **_gather_load(gk, centers, GRID_HW),
        seconds=f"{time.perf_counter() - t0:.1f}")
    check(err <= tol, f"K1 {dtype} {pattern}: out error {err} > {tol}")
    check(lse_err <= LSE_TOL, f"K1 {dtype} {pattern}: lse error {lse_err}")
    check(off_ok, f"K1 {dtype} {pattern}: off-grid rows break the contract")
    check(same_bits, f"K1 {dtype} {pattern}: two calls differ")


def _bound(nbytes: float, flops: float, dtype, f32_peak=PEAK_FLOPS[
        torch.float32]):
    """The larger of bytes over the memory rate and operations over the
    dtype's peak; f32_peak is the f32 rate of the kernel's path."""
    peak = f32_peak if dtype == torch.float32 else PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------------ phase 3 ------

MAIN_HW = (480, 640)
MAIN_B = 2          # pairs per request
REQUESTS = 3
SMALL_HW = (120, 160)
# The JAX package's parity bar (__graft_entry__.py): match sets overlap
# >= 0.9, every keypoint of the common matches within 0.05 px.
PARITY = dict(overlap=0.9, kp_px=0.05)
GAM_TOL = 1e-4   # f32 features after 4 GAM layers, |x| ~ 1
# Coarse threshold of the full-width request whose GAM runs on real
# inliers: random weights leave no match at the bench threshold of 0.2.
LIVE_THR = 1e-6


def _check_outputs(res, hw) -> None:
    h, w = hw
    for mk0, mk1, mc, geo in res:
        check(mk0.shape == mk1.shape and mk0.shape[1:] == (2,)
              and mc.shape == mk0.shape[:1], "match arrays' shapes")
        for a in (mk0, mk1, mc, geo["H"]):
            check(bool(np.isfinite(a).all()), "non-finite output")
        check(bool(((mk0 >= -8) & (mk0[:, :1] < w + 8)
                    & (mk0[:, 1:] < h + 8)).all()), "keypoints off image")


def phase_main_path(device):
    import dataclasses

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk

    cfg = bench_config(use_bf16=True)
    model = weights.random_init(GeoFormer(cfg), seed=0)
    matcher = BatchedMatcher(cfg, model, batch_size=MAIN_B, device=device)
    pairs = [textured_pair(MAIN_HW, seed) for seed in range(MAIN_B)]
    imgs0 = [a for a, _ in pairs]
    imgs1 = [b for _, b in pairs]
    t0 = time.perf_counter()
    matcher.match_batch(imgs0, imgs1)           # warm-up: cuDNN, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    gk.reset_launch_counts()
    t0 = time.perf_counter()
    results = []
    for _ in range(REQUESTS):
        results.append(matcher.match_batch(imgs0, imgs1, return_geo=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)

    n_pairs = REQUESTS * MAIN_B
    ms_per_pair = wall * 1e3 / n_pairs
    n_valid = [len(r[2]) for res in results for r in res]
    log("main_path", config="bench(480x640,bf16,max_matches=1024,"
        "ransac_iters=256,max_inliers=1024,K1+K2)", batch=MAIN_B,
        requests=REQUESTS, warmup_s=f"{warm_s:.2f}",
        ms_per_pair=f"{ms_per_pair:.3f}", valid_matches=n_valid,
        has_H=[r[3]["has_H"] for r in results[-1]],
        num_inliers=[r[3]["num_inliers"] for r in results[-1]],
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=launches, launches_per_forward={
            k: v / REQUESTS for k, v in launches.items()})
    for name, count in launches.items():
        want = PER_FORWARD.get(name, 0) * REQUESTS
        check(count == want, f"{name} launched {count} times in "
              f"{REQUESTS} forwards, expected {want // REQUESTS} per forward")
    for res in results:
        _check_outputs(res, MAIN_HW)
    # every request saw the same pairs with the same RANSAC seed
    for res in results[1:]:
        for a, b in zip(res, results[0]):
            check(a[0].shape == b[0].shape, "requests disagree")

    # One more request with the same weights at the coarse threshold
    # LIVE_THR: the coarse stage then finds matches, RANSAC a homography,
    # and both kernels' outputs are kept (K2 over live inliers, K1 in the
    # cross layers of pairs with a homography).
    live_cfg = cfg.replace(match=dataclasses.replace(cfg.match, thr=LIVE_THR))
    live_model = GeoFormer(live_cfg)
    live_model.load_state_dict(model.state_dict())
    live = BatchedMatcher(live_cfg, live_model, batch_size=MAIN_B,
                          device=device)
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    res = live.match_batch(imgs0, imgs1, return_geo=True)
    torch.cuda.synchronize()
    live_ms = (time.perf_counter() - t0) * 1e3 / MAIN_B
    live_launches = dict(gk.LAUNCHES)
    has_h = [r[3]["has_H"] for r in res]
    log("main_path_live_gam", coarse_thr=LIVE_THR, batch=MAIN_B,
        ms_per_pair=f"{live_ms:.3f}", valid_matches=[len(r[2]) for r in res],
        has_H=has_h, num_inliers=[r[3]["num_inliers"] for r in res],
        launches=live_launches)
    for name, count in live_launches.items():
        want = PER_FORWARD.get(name, 0)
        check(count == want, f"{name} launched {count} times in the "
              f"live-GAM forward, expected {want}")
    check(any(has_h), "the live-GAM request found no homography")
    _check_outputs(res, MAIN_HW)
    return launches, ms_per_pair, live_model


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the kernel wrappers (K1-K5, and K6's two ops) are
    replaced by their plain versions, on any device; the differentiable ops
    and the streamed extraction call them by name. The parity checks'
    reference runs use it; the port itself never falls back."""
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.ops import streaming_match as sm

    plain = {(gk, "box_window_attention_fwd"): gk.box_window_attention_plain,
             (gk, "box_window_attention_bwd"):
                 gk.box_window_attention_bwd_plain,
             (gk, "masked_kv_attention_fwd"): gk.masked_kv_attention_plain,
             (gk, "masked_kv_attention_bwd"): gk.masked_kv_attention_bwd_plain,
             (sm, "extract_lse"): sm.extract_lse_plain,
             (sm, "extract_argmax"): sm.extract_argmax_plain}
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_small_parity(device):
    """At a small size in f32, the forward through both kernels against the
    same model with the kernels' plain versions, on the same card, with the
    same weights and RANSAC draws: the GAM's output features, then the
    final matches by the JAX package's parity bar. (The plain gather path
    is not the reference here: it floors warped points plus window offsets,
    the box path floors the warped point, and the two can pick different
    cells where a point lies within f32 rounding of a cell border; the CPU
    tests hold both paths against the JAX forward.)"""
    import dataclasses

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk

    base = bench_config(use_bf16=False)
    # a low threshold gives the untrained model matches to run the GAM on
    cfg = base.replace(match=dataclasses.replace(base.match, thr=1e-4,
                                                 max_matches=256),
                       fine_match=dataclasses.replace(base.fine_match,
                                                      thr=1e-3))
    model = weights.random_init(GeoFormer(cfg), 1).to(device).eval()
    pairs = [textured_pair(SMALL_HW, 10 + s) for s in range(2)]
    i0 = torch.from_numpy(np.stack([a for a, _ in pairs])[..., None]).to(
        device)
    i1 = torch.from_numpy(np.stack([b for _, b in pairs])[..., None]).to(
        device)

    @torch.no_grad()
    def run(fn):
        gk.reset_launch_counts()
        out = fn(torch.Generator(device).manual_seed(3))
        torch.cuda.synchronize()
        return out, dict(gk.LAUNCHES)

    def forward(g):
        return model(i0, i1, generator=g)

    a, a_launch = run(forward)
    with plain_kernels():
        b, b_launch = run(forward)
    with torch.no_grad():
        cnn = model.backbone(torch.cat([i0, i1]))[0]

    def gam(g):
        return model.geo_module(cnn[:2], cnn[2:], a.matches1, 8,
                                generator=g)[:2]

    gam_k = run(gam)[0]
    with plain_kernels():
        gam_p = run(gam)[0]
    gam_err = max((x - y).abs().max().item() for x, y in zip(gam_k, gam_p))

    overlap, kp_max = 1.0, 0.0
    for j in range(2):
        def pairs_of(o):
            v = o.matches.valid[j].cpu().numpy()
            return set(zip(o.matches.i_ids[j].cpu().numpy()[v].tolist(),
                           o.matches.j_ids[j].cpu().numpy()[v].tolist()))
        pa, pb = pairs_of(a), pairs_of(b)
        overlap = min(overlap, len(pa & pb) / max(len(pa | pb), 1))
        sel = (a.fine.valid[j] & b.fine.valid[j]
               & (a.matches.i_ids[j] == b.matches.i_ids[j]))
        d = torch.maximum(
            (a.fine.mkpts0[j][sel] - b.fine.mkpts0[j][sel]).abs().amax(-1),
            (a.fine.mkpts1[j][sel] - b.fine.mkpts1[j][sel]).abs().amax(-1))
        check(d.numel() > 0, "parity input: no common fine matches")
        kp_max = max(kp_max, d.max().item())
    log("parity", size=f"{SMALL_HW[0]}x{SMALL_HW[1]}", dtype="float32",
        matches=[int(x) for x in a.matches.valid.sum(1).tolist()],
        has_H=a.geo.has_H.tolist(), plain_has_H=b.geo.has_H.tolist(),
        gam_max_abs_err=f"{gam_err:.3e}", gam_tol=GAM_TOL,
        match_overlap=f"{overlap:.4f}", overlap_min=PARITY["overlap"],
        max_kp_px=f"{kp_max:.4f}", kp_px_max=PARITY["kp_px"],
        kernel_launches=a_launch,
        plain_launches=b_launch)
    check(bool(a.geo.has_H.all()), "parity input found no homography")
    check(bool((a.matches.valid.sum(1) > 8).all()), "parity input: no matches")
    check(all(a_launch[k] == n for k, n in PER_FORWARD.items()),
          "kernel path did not launch K1 and K2 4 times and K6 twice")
    check(all(v == 0 for v in b_launch.values()),
          "plain versions launched a kernel")
    check(gam_err <= GAM_TOL, f"GAM outputs differ by {gam_err}")
    check(overlap >= PARITY["overlap"], "kernel and plain versions' match "
          f"sets differ: overlap {overlap}")
    check(kp_max < PARITY["kp_px"], f"a common keypoint moved {kp_max} px")


# ------------------------------------------------------------ phase 4 ------

TRAIN_B = 4              # pairs per step (the headline recipe's batch)
TRAIN_INLIERS = 512      # the recipe's GAM KV capacity (--gam-max-inliers)
# K3-K5 against their plain backwards: largest error over the largest
# magnitude of the plain result. f32: sums of up to L terms in another
# order, no atomics. bf16: both sides round an f32 gradient to bf16 (one
# ulp is 2^-8 of the value).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


def _k4_load(gk, centers, grid_hw) -> dict:
    """K4's work on these centres: the queries whose box meets the grid,
    the most contributions of one key (queries whose box covers it), the
    keys with any, and the pieces of the busiest batch row."""
    n, _, base = gk.box_dkv_schedule(centers, grid_hw, 2)
    hg, wg = grid_hw
    cx, cy = centers[..., 0], centers[..., 1]
    on = (cx >= -2) & (cx < wg + 2) & (cy >= -2) & (cy < hg + 2)
    return dict(on_grid=int(on.sum()), max_per_key=int(n.max()),
                keys_with_any=int((n > 0).sum()),
                pieces=int(base[:, -1].max()))


def _plain_and_library_ms(gk, q, k, v, g, centers, grid):
    """ms of the plain box-window backward (dq, dk, dv at once) and of the
    library call (SDPA's backward under the dense box mask) on these
    inputs, as phase 4 times them."""
    out, lse = gk.box_window_attention_fwd(q, k, v, centers, grid, 2)
    plain_ms = time_ms(lambda: gk.box_window_attention_bwd_plain(
        q, k, v, centers, out, lse, g, grid, 2), 3, warmup=1)
    box = _dense_box(centers, grid, 2)
    lib_ms = _sdpa_bwd_ms(q, k, v, box[:, None], g)
    del box
    return dict(plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}")


def _box_dq_case(gk, q, k, v, g, centers, pattern, grid=GRID_HW,
                 library=False):
    """K5 alone on one centre pattern: against the plain backward, the
    off-grid rows' zero dq, the same bits twice, ms hot and with L2
    flushed, the bound, the load (and with ``library`` the plain
    backward's and the library call's ms); on the 60x80 grid unless
    ``grid``."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    t0 = time.perf_counter()
    dtype = q.dtype
    tol = BWD_TOL[dtype]
    out, lse = gk.box_window_attention_fwd(q, k, v, centers, grid, 2)
    gf = g.float()
    delta = (gf * out.float()).sum(-1)

    def run():
        return gk.box_window_attention_bwd_dq(q, k, v, centers, lse, delta,
                                              gf, grid, 2)

    got, again = run(), run()
    ref = gk.box_window_attention_bwd_plain(q, k, v, centers, out, lse, g,
                                            grid, 2)[0]
    torch.cuda.synchronize()
    same_bits = torch.equal(got, again)
    rel = _rel_err(got.to(dtype), ref)
    off = _offgrid_rows(centers, grid)
    off_zero = bool((got[off] == 0).all())
    cells = _box_cells(centers, grid, 2)
    # q, k, v in their type; f32 g, lse, delta in, f32 dq out
    nbytes = (3 * q.numel() * q.element_size() + 2 * q.numel() * 4
              + centers.numel() * 4 + 2 * lse.numel() * 4)
    bound, by = _bound(nbytes, 6.0 * HEAD_DIM * HEADS * cells, dtype)
    ms = bk.time_graph_ms(run, 20)
    cold_ms = bk.time_graph_cold_ms(run, 10)
    call_ms = time_ms(run, 20)
    lib = (_plain_and_library_ms(gk, q, k, v, g, centers, grid) if library
           else {})
    log("bwd_kernels", name="box_window_attention_bwd_dq",
        dtype=str(dtype), centres=pattern, shape=f"q{tuple(q.shape)}",
        rel_err=f"{rel:.3e}", rel_tol=tol, offgrid_rows=int(off.sum()),
        offgrid_dq_zero=off_zero, same_bits_twice=same_bits,
        kernel_ms=f"{ms:.4f}", kernel_cold_ms=f"{cold_ms:.4f}",
        call_ms=f"{call_ms:.4f}", **lib,
        bound_ms=f"{bound:.4f}", bound_by=by,
        **_gather_load(gk, centers, grid),
        seconds=f"{time.perf_counter() - t0:.1f}")
    check(rel <= tol, f"K5 {dtype} {pattern}: relative error {rel} > {tol}")
    check(off_zero, f"K5 {dtype} {pattern}: off-grid rows got a gradient")
    check(same_bits, f"K5 {dtype} {pattern}: two calls differ")


def _box_dkv_case(gk, q, k, v, g, centers, pattern, grid=GRID_HW,
                  library=False):
    """K4 alone on one centre pattern: against the plain backward, the
    same bits twice, ms hot and with L2 flushed, the bound, the load (and
    with ``library`` the plain backward's and the library call's ms); on
    the 60x80 grid unless ``grid``."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    t0 = time.perf_counter()
    dtype = q.dtype
    tol = BWD_TOL[dtype]
    out, lse = gk.box_window_attention_fwd(q, k, v, centers, grid, 2)
    gf = g.float()
    delta = (gf * out.float()).sum(-1)

    def run():
        return gk.box_window_attention_bwd_dkv(q, k, v, centers, lse, delta,
                                               gf, grid, 2)

    got, again = run(), run()
    ref = gk.box_window_attention_bwd_plain(q, k, v, centers, out, lse, g,
                                            grid, 2)[1:]
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    rel = max(_rel_err(a.to(dtype), r) for a, r in zip(got, ref))
    cells = _box_cells(centers, grid, 2)
    # q, k, v in their type; f32 g, lse, delta in, f32 dk, dv out
    nbytes = (3 * q.numel() * q.element_size() + 3 * q.numel() * 4
              + centers.numel() * 4 + 2 * lse.numel() * 4)
    bound, by = _bound(nbytes, 8.0 * HEAD_DIM * HEADS * cells, dtype)
    ms = bk.time_graph_ms(run, 20)
    cold_ms = bk.time_graph_cold_ms(run, 10)
    call_ms = time_ms(run, 20)
    load = _k4_load(gk, centers, grid)
    lib = (_plain_and_library_ms(gk, q, k, v, g, centers, grid) if library
           else {})
    log("bwd_kernels", name="box_window_attention_bwd_dkv",
        dtype=str(dtype), centres=pattern, shape=f"q{tuple(q.shape)}",
        rel_err=f"{rel:.3e}", rel_tol=tol, same_bits_twice=same_bits,
        kernel_ms=f"{ms:.4f}", kernel_cold_ms=f"{cold_ms:.4f}",
        call_ms=f"{call_ms:.4f}", **lib,
        bound_ms=f"{bound:.4f}", bound_by=by, **load,
        seconds=f"{time.perf_counter() - t0:.1f}")
    check(rel <= tol, f"K4 {dtype} {pattern}: relative error {rel} > {tol}")
    check(same_bits, f"K4 {dtype} {pattern}: two calls differ")


def _rel_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)
            ).item()


def _sdpa_bwd_ms(q, k, v, mask, g) -> float:
    """One PyTorch call with the same gradients: the backward of
    scaled_dot_product_attention with a boolean mask, timed alone on a
    retained graph."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)
    gt = g.transpose(1, 2).to(out.dtype)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                               retain_graph=True), 5)


def _mka_bwd_case(gk, q, k, v, mask, g, kind):
    """K3 against its plain backward on one mask. Called alone it runs K2
    for the row statistics first; it is timed as the train step runs it,
    from K2's output and statistics computed outside the timed loop."""
    t0 = time.perf_counter()
    dtype = q.dtype
    tol = BWD_TOL[dtype]
    b, s = mask.shape
    got = gk.masked_kv_attention_bwd(q, k, v, mask, g)
    out, stats = gk.masked_kv_attention_fwd(q, k, v, mask, return_stats=True)
    again = gk.masked_kv_attention_bwd(q, k, v, mask, g, out=out, stats=stats)
    ref = gk.masked_kv_attention_bwd_plain(q, k, v, mask, g)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, c) for a, c in zip(got, again))
    rel = max(_rel_err(a, r) for a, r in zip(got, ref))
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(got, ref))
    n_keep = mask.sum(dim=1).double()
    dead = (n_keep == 0).to(device=q.device)
    colmean = (g.sum(dim=1, keepdim=True) / s)[dead]
    masked_rel = (_rel_err(got[2][dead], colmean.expand_as(got[2][dead]))
                  if bool(dead.any()) else 0.0)
    masked_zero = bool((got[0][dead] == 0).all() and (got[1][dead] == 0).all())
    l = q.shape[1]
    flops = float((10.0 * HEAD_DIM * HEADS * l * n_keep).sum()
                  + 2.0 * HEAD_DIM * HEADS * l * (n_keep == 0).sum())
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) * q.element_size()
              + mask.numel() + g.numel() * 4)
    bound, by = _bound(nbytes, flops, dtype, PEAK_FLOPS_3XTF32)
    ms = time_ms(lambda: gk.masked_kv_attention_bwd(q, k, v, mask, g, out=out,
                                                    stats=stats), 10)
    plain_ms = time_ms(lambda: gk.masked_kv_attention_bwd_plain(
        q, k, v, mask, g), 3, warmup=1)
    lib_ms = _sdpa_bwd_ms(q, k, v, mask[:, None, None, :], g)
    log("bwd_kernels", name="masked_kv_attention_bwd", dtype=str(dtype),
        mask=kind, shape=f"q{tuple(q.shape)}k{tuple(k.shape)}",
        max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", rel_tol=tol,
        all_masked_dv_rel_err=f"{masked_rel:.3e}",
        all_masked_dq_dk_zero=masked_zero, alone_equals_from_stats=same_bits,
        timed="from K2's out and stats, computed outside the timed loop",
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
        live_keys=[int(x) for x in n_keep.tolist()],
        seconds=f"{time.perf_counter() - t0:.1f}")
    check(rel <= tol, f"K3 {dtype} {kind}: relative error {rel} > {tol}")
    check(masked_zero and masked_rel <= tol,
          f"K3 {dtype} {kind}: the all-masked row breaks the contract")
    check(same_bits, f"K3 {dtype} {kind}: alone and from K2's statistics "
          "differ")
    # K3 (~0.5-0.8 ms a call) is timed by the eager loop alone
    return dict(max_abs_err=err, ms=ms, call_ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


def phase_backward_kernels(device):
    """K3, K4 and K5 against their plain backwards at the training path's
    shapes (B=4, L=4800; S=512 for K3, S=4800 for K4/K5), f32 and bf16."""
    from geoformer_tpu_torch.eval import box_kernels as bk
    from geoformer_tpu_torch.ops import gam_kernels as gk

    gen = torch.Generator().manual_seed(1)
    b = TRAIN_B
    hg, wg = GRID_HW
    s = hg * wg
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = BWD_TOL[dtype]
        # ---- K3: masked-KV backward, one batch row with no inlier
        q = _rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
        k, v = (_rand((b, TRAIN_INLIERS, HEADS, HEAD_DIM), gen, dtype,
                      device) for _ in range(2))
        g = _rand((b, s, HEADS, HEAD_DIM), gen, torch.float32, device)
        mask = torch.rand((b, TRAIN_INLIERS), generator=gen) < 0.6
        mask[-1] = False
        mask = mask.to(device)
        results[("masked_kv_attention_bwd", dtype)] = _mka_bwd_case(
            gk, q, k, v, mask, g, "random")
        _mka_bwd_case(gk, q, k, v, _prefix_like(mask), g, "prefix")
        del q, k, v, g
        if dtype == torch.float32:
            _mka_live_sweep(gk, device, dtype, b, TRAIN_INLIERS,
                            (0, 64, 256, 512), backward=True)

        # ---- K5 and K4: box-window backward, centres with off-grid rows
        q, k, v, g = (_rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
                      for _ in range(4))
        centers = bk.homography_centers(b, GRID_HW).to(device)
        out, lse = gk.box_window_attention_fwd(q, k, v, centers, GRID_HW, 2)
        gf = g.float()
        delta = (gf * out.float()).sum(-1)
        dq = gk.box_window_attention_bwd_dq(q, k, v, centers, lse, delta, gf,
                                            GRID_HW, 2)
        dk, dv = gk.box_window_attention_bwd_dkv(q, k, v, centers, lse,
                                                 delta, gf, GRID_HW, 2)
        again = gk.box_window_attention_bwd_dkv(q, k, v, centers, lse,
                                                delta, gf, GRID_HW, 2)
        ref = gk.box_window_attention_bwd_plain(q, k, v, centers, out, lse,
                                                g, GRID_HW, 2)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b_) for a, b_ in
                            zip((dk, dv), again))
        offgrid = (lse < -1e6)
        off_zero = bool((dq[offgrid.any(-1)] == 0).all())
        cells = _box_cells(centers, GRID_HW, 2)
        in_bytes = (3 * q.numel() * q.element_size() + g.numel()
                    * g.element_size() + centers.numel() * 4
                    + 2 * lse.numel() * 4)
        plain_ms = time_ms(lambda: gk.box_window_attention_bwd_plain(
            q, k, v, centers, out, lse, g, GRID_HW, 2), 3, warmup=1)
        box = _dense_box(centers, GRID_HW, 2)
        lib_ms = _sdpa_bwd_ms(q, k, v, box[:, None], g)
        del box
        for name, got_r, ref_r, flops, out_n in (
                ("box_window_attention_bwd_dq", (dq,), ref[:1],
                 6.0 * HEAD_DIM * HEADS * cells, 1),
                ("box_window_attention_bwd_dkv", (dk, dv), ref[1:],
                 8.0 * HEAD_DIM * HEADS * cells, 2)):
            rel = max(_rel_err(a.to(dtype), r) for a, r in zip(got_r, ref_r))
            err = max((a.to(dtype).float() - r.float()).abs().max().item()
                      for a, r in zip(got_r, ref_r))
            nbytes = in_bytes + out_n * q.numel() * q.element_size()
            bound, by = _bound(nbytes, flops, dtype)
            fn = (gk.box_window_attention_bwd_dq if out_n == 1
                  else gk.box_window_attention_bwd_dkv)
            ms = bk.time_graph_ms(lambda: fn(q, k, v, centers, lse, delta, gf,
                                          GRID_HW, 2), 20)
            call_ms = time_ms(lambda: fn(q, k, v, centers, lse, delta, gf,
                                         GRID_HW, 2), 20)
            log("bwd_kernels", name=name, dtype=str(dtype),
                shape=f"q{tuple(q.shape)}", max_abs_err=f"{err:.3e}",
                rel_err=f"{rel:.3e}", rel_tol=tol, kernel_ms=f"{ms:.4f}",
                call_ms=f"{call_ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
                bound_ms=f"{bound:.4f}", bound_by=by,
                offgrid_rows=int(offgrid.any(-1).sum()),
                offgrid_dq_zero=off_zero, dkv_deterministic=deterministic)
            check(rel <= tol, f"{name} {dtype}: relative error {rel} > {tol}")
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)
        check(off_zero, f"K5 {dtype}: off-grid rows got a gradient")
        check(deterministic, f"K4 {dtype}: two calls differ")
        for pattern, cen in bk.centre_patterns(b, GRID_HW):
            cen = cen.to(device)
            _box_dkv_case(gk, q, k, v, g, cen, pattern)
            _box_dq_case(gk, q, k, v, g, cen, pattern)
            if dtype == torch.float32:   # K1 at the training path's shape
                _box_fwd_case(gk, q, k, v, cen, pattern)
        del q, k, v, g, out, ref, dq, dk, dv, again
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ phase 5 ------

TRAIN_HW = (480, 640)
TRAIN_STEPS = 4          # one warm-up step, then three timed
TRAIN_SEED = 66          # run_training's default seed (weights and data)
GAM_KERNEL_NAMES = ("mka_fwd_kernel", "box_fwd_kernel", "mka_bwd_dq_kernel",
                    "mka_bwd_dkv_kernel", "mka_bwd_sum_kernel",
                    "box_bwd_dq_kernel", "gather_count_kernel",
                    "gather_fill_kernel",
                    "box_count_kernel", "box_plan_kernel", "box_fill_kernel",
                    "box_bwd_dkv_kernel", "box_dkv_sum_kernel")


def headline_config(**match):
    """The headline checkpoint's recipe, `cli train --pallas` at its
    defaults (geoformer_tpu/cli.py:414-456, RESULTS.md:411): f32,
    max_matches 512, force_one_match, 256 RANSAC hypotheses, 512 inliers,
    both GAM kernels."""
    import dataclasses

    from geoformer_tpu_torch.config import (
        GeoFormerConfig,
        GeoModuleConfig,
        MatchConfig,
    )

    return GeoFormerConfig(
        match=dataclasses.replace(
            MatchConfig(max_matches=512, force_one_match=True), **match),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=512,
                            use_pallas=True))


def _profile_step(step_fn, state, batch, lr, gen):
    """One profiled train step: its window by CUDA events, the device's
    busy time, and each GAM kernel's device time (ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        step_fn(state, batch, lr, generator=gen)
        end.record()
        torch.cuda.synchronize()
    # device activity: kernels, copies, sets; the device-side spans of
    # annotations (autograd's record_function ranges) cover kernels and
    # are left out, and overlaps are merged
    cuda = torch.autograd.DeviceType.CUDA
    spans = []
    gam_us = dict.fromkeys(GAM_KERNEL_NAMES, 0.0)
    for e in prof.events():
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        for name in GAM_KERNEL_NAMES:
            if f"{name}<" in e.name or f"{name}(" in e.name:
                gam_us[name] += e.time_range.end - e.time_range.start
    busy_us, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy_us += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    return (start.elapsed_time(end), busy_us / 1e3,
            {k: v / 1e3 for k, v in gam_us.items()})


@contextlib.contextmanager
def _keep_inputs(gk, *names):
    """Within the block, each call of the named kernel wrappers keeps its
    arguments (the centres and the tensors the kernel reads) in the list
    of its name in the dict it yields."""
    calls = {name: [] for name in names}
    wrapped = {name: getattr(gk, name) for name in names}

    def keeper(name):
        def keep(*args, **kwargs):
            calls[name].append(args)
            return wrapped[name](*args, **kwargs)
        return keep

    for name in names:
        setattr(gk, name, keeper(name))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            setattr(gk, name, fn)


# wrapper -> (log tag, position of grid_hw in its arguments, its load)
PROFILED_ALONE = {
    "box_window_attention_bwd_dkv": ("training_profile_k4", 7, _k4_load),
    "box_window_attention_bwd_dq": ("training_profile_k5", 7, _gather_load),
    "box_window_attention_fwd": ("training_profile_k1", 4, _gather_load),
}


def phase_training(device):
    """run_training at the headline recipe on the card: 480x640, f32, batch
    4, random weights from its seed, the procedural bank of 256 textures;
    one warm-up step, then timed steps. Then one profiled step, and one
    step at coarse threshold LIVE_THR, where RANSAC finds a homography and
    the cross layers' gradients reach K4/K5."""
    import io
    import tempfile

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.data.native import native_textures_mixed
    from geoformer_tpu_torch.data.synthetic import make_pair_batch
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.eval import box_kernels as bk
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train.loop import run_training
    from geoformer_tpu_torch.train.trainer import make_train_step

    cfg = headline_config()
    init = weights.random_init(GeoFormer(cfg), TRAIN_SEED).state_dict()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(buf):
        state = run_training(steps=TRAIN_STEPS, batch_size=TRAIN_B,
                             image_hw=TRAIN_HW, ckpt_dir=tmp, log_every=1,
                             seed=TRAIN_SEED, model_cfg=cfg, bank_size=256,
                             device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = [json.loads(ln) for ln in buf.getvalue().splitlines()
               if ln.startswith("{")]
    check(len(metrics) == TRAIN_STEPS, "run_training logged "
          f"{len(metrics)} of {TRAIN_STEPS} steps")
    timed = [TRAIN_B * 1e3 / m["imgs_per_s"] for m in metrics[1:]]
    ms_step = sum(timed) / len(timed)
    sd = state.model.state_dict()
    changed = {kind: sum(not torch.equal(sd[k].cpu(), init[k]) for k in init
                         if ("running" in k) == (kind == "bn_stats"))
               for kind in ("params", "bn_stats")}
    n_bn = sum("running" in k for k in init)
    log("training", config="headline(480x640,f32,batch4,max_matches=512,"
        "ransac_iters=256,max_inliers=512,bank256,K1-K5)",
        steps=TRAIN_STEPS, wall_s=f"{wall:.2f}",
        first_step_ms=f"{TRAIN_B * 1e3 / metrics[0]['imgs_per_s']:.1f}",
        ms_per_step=f"{ms_step:.1f}", step_ms=[f"{x:.1f}" for x in timed],
        images_per_s=f"{2 * TRAIN_B * 1e3 / ms_step:.2f}",
        pairs_per_s=f"{TRAIN_B * 1e3 / ms_step:.2f}",
        peak_gib=f"{peak_gib:.2f}", launches=launches,
        loss=[round(m["loss"], 5) for m in metrics],
        grad_norm=[round(m["grad_norm"], 4) for m in metrics],
        lr=[m["lr"] for m in metrics],
        num_matches=[m["num_matches"] for m in metrics],
        params_changed=f"{changed['params']}/{len(init) - n_bn}",
        bn_stats_changed=f"{changed['bn_stats']}/{n_bn}")
    for m in metrics:
        check(all(np.isfinite(m[k]) for k in ("loss", "grad_norm")),
              f"non-finite loss or grad_norm at step {m['step']}")
    check(changed["params"] > 0.9 * (len(init) - n_bn),
          "the parameters did not change")
    check(changed["bn_stats"] == n_bn, "BatchNorm statistics did not change")
    for name, count in launches.items():
        want = PER_TRAIN_STEP.get(name, 0)
        check(count == want * TRAIN_STEPS, f"{name} launched {count} times "
              f"in {TRAIN_STEPS} train steps, expected {want} per step")

    # one profiled step of the same recipe on a fresh batch
    tcfg = TrainConfig(batch_size=TRAIN_B, image_hw=TRAIN_HW)
    step_fn = make_train_step(tcfg)
    gen = torch.Generator(device).manual_seed(5)
    base = torch.from_numpy(native_textures_mixed(
        TRAIN_B, *TRAIN_HW, seed=7)).to(device)
    batch = make_pair_batch(base, gen)
    with _keep_inputs(gk, *PROFILED_ALONE) as calls:
        window_ms, busy_ms, gam_by_kernel = _profile_step(
            step_fn, state, batch, 1e-5, gen)
    gam_ms = sum(gam_by_kernel.values())
    check(0 < busy_ms <= window_ms * 1.01,
          f"profiled device activity {busy_ms} ms in a {window_ms} ms step")
    log("training_profile", step_ms=f"{window_ms:.1f}",
        device_busy_ms=f"{busy_ms:.1f}",
        device_idle_share=f"{1 - busy_ms / window_ms:.3f}",
        gam_kernels_ms=f"{gam_ms:.2f}",
        by_kernel={k: f"{v:.3f}" for k, v in gam_by_kernel.items()},
        gam_kernels_share_of_step=f"{gam_ms / window_ms:.4f}",
        gam_kernels_share_of_busy=f"{gam_ms / busy_ms:.4f}")
    for name, (tag, grid_at, load) in PROFILED_ALONE.items():
        check(len(calls[name]) == 4, f"the profiled step called {name} "
              f"{len(calls[name])} times, expected 4")
        fn = getattr(gk, name)
        for i, args in enumerate(calls[name]):
            # the kernel alone on the step's inputs, after the step
            ms = bk.time_graph_ms(lambda: fn(*args), 20)
            cold_ms = bk.time_graph_cold_ms(lambda: fn(*args), 10)
            log(tag, launch=i, kernel_ms_alone=f"{ms:.4f}",
                kernel_cold_ms_alone=f"{cold_ms:.4f}",
                **load(gk, args[3], tuple(args[grid_at])))
    del calls

    # one step at LIVE_THR: RANSAC finds a homography on the matches
    state.model.config = headline_config(thr=LIVE_THR)
    geo = []
    hook = state.model.geo_module.register_forward_hook(
        lambda mod, inp, out: geo.append(out[2]))
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    live = step_fn(state, batch, 1e-5, generator=gen)
    torch.cuda.synchronize()
    live_ms = (time.perf_counter() - t0) * 1e3
    hook.remove()
    live_launches = dict(gk.LAUNCHES)
    cross = state.model.geo_module.layer_1
    cross_grad = {n_: getattr(cross, n_).weight.grad.norm().item()
                  for n_ in ("q_proj", "k_proj", "v_proj")}
    has_h = geo[0].has_H.tolist()
    log("training_live_gam", coarse_thr=LIVE_THR, step_ms=f"{live_ms:.1f}",
        has_H=has_h, num_inliers=geo[0].num_inliers.tolist(),
        num_matches=float(live["num_matches"]), loss=float(live["loss"]),
        grad_norm=float(live["grad_norm"]), launches=live_launches,
        cross_layer_grad_norms={k: f"{x:.3e}" for k, x in cross_grad.items()})
    check(any(has_h), "the live-GAM train step found no homography")
    check(all(np.isfinite(float(live[k])) for k in ("loss", "grad_norm")),
          "non-finite live-GAM step")
    check(all(x > 0 for x in cross_grad.values()),
          "the cross layers got no gradient through K4/K5")
    for name, count in live_launches.items():
        want = PER_TRAIN_STEP.get(name, 0)
        check(count == want, f"{name} launched {count} times in the live-GAM "
              f"step, expected {want}")
    del state
    torch.cuda.empty_cache()
    return launches, ms_step


# ------------------------------------------------------------ phase 6 ------

TRAIN_PARITY_HW = (120, 160)
# kernel step vs plain step on the card. The loss: f32 through the whole
# model, 1e-4 rel. Each gradient tensor by relative L2, 1e-2: the backbone's
# gradients pass back through ~20 train-mode BatchNorms (the CPU test of the
# same bar measured a 9 % move from a 1e-6 input perturbation), while a
# wrong formula gives errors of order 1. No atomics in K3-K5 and
# deterministic cuDNN, so the two runs differ only by the kernels' order
# of summation.
TRAIN_PARITY = dict(loss_rel=1e-4, grad_rel_l2=1e-2)


def phase_train_parity(device):
    """One train step at 120x160 in f32 with full widths through the
    kernels, against the same step through their plain versions on the
    same card: same weights, batch and RANSAC draws."""
    import copy

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.eval.synthetic import H_TRUE, textured_pair
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train.optim import make_optimizer
    from geoformer_tpu_torch.train.trainer import TrainState, make_train_step

    # a low threshold gives the untrained model matches for the GAM
    cfg = headline_config(thr=1e-4, max_matches=256)
    model = weights.random_init(GeoFormer(cfg), 1).to(device)
    # the inference parity's pairs: a texture and its warp by H_TRUE
    pairs = [textured_pair(TRAIN_PARITY_HW, 10 + s) for s in range(2)]
    H01 = torch.from_numpy(H_TRUE).float()
    batch = {"image0": np.stack([a for a, _ in pairs])[..., None],
             "image1": np.stack([b for _, b in pairs])[..., None],
             "H_0to1": H01.expand(2, 3, 3).numpy(),
             "H_1to0": torch.linalg.inv(H01).expand(2, 3, 3).numpy()}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in batch.items()}
    tcfg = TrainConfig(batch_size=2, image_hw=TRAIN_PARITY_HW)
    step_fn = make_train_step(tcfg)
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def run():
        m = copy.deepcopy(model)
        grads, geo = {}, []

        def keeper(name):
            def keep(p):   # after backward, before the clip
                grads[name] = p.grad.detach().clone()
            return keep

        hooks = [p.register_post_accumulate_grad_hook(keeper(name))
                 for name, p in m.named_parameters()]
        hooks.append(m.geo_module.register_forward_hook(
            lambda mod, inp, out: geo.append(out[2])))
        gk.reset_launch_counts()
        state = TrainState(m, make_optimizer(tcfg.optim, m.parameters()))
        scalars = step_fn(state, batch, 1e-4,
                          generator=torch.Generator(device).manual_seed(3))
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        return ({k: float(v) for k, v in scalars.items()}, grads, geo[0],
                dict(gk.LAUNCHES))

    try:
        a, ga, geo_a, launch_a = run()
        with plain_kernels():
            b, gb, geo_b, launch_b = run()
    finally:
        torch.backends.cudnn.deterministic = saved_det
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    scale = max(g.norm().item() for g in gb.values())
    worst, worst_name, n_checked = 0.0, "", 0
    for name, g in gb.items():
        norm = g.norm().item()
        if norm < 1e-6 * scale:
            continue
        rel = (ga[name] - g).norm().item() / norm
        n_checked += 1
        if rel > worst:
            worst, worst_name = rel, name
    log("train_parity", size=f"{TRAIN_PARITY_HW[0]}x{TRAIN_PARITY_HW[1]}",
        dtype="float32", loss=a["loss"], plain_loss=b["loss"],
        loss_rel=f"{loss_rel:.3e}", loss_rel_tol=TRAIN_PARITY["loss_rel"],
        grad_norm=a["grad_norm"], plain_grad_norm=b["grad_norm"],
        worst_grad_rel_l2=f"{worst:.3e}", worst_grad=worst_name,
        grad_rel_l2_tol=TRAIN_PARITY["grad_rel_l2"],
        grads_checked=f"{n_checked}/{len(gb)}",
        num_matches=(a["num_matches"], b["num_matches"]),
        num_inliers=(a["num_inliers"], b["num_inliers"]),
        has_H=geo_a.has_H.tolist(), kernel_launches=launch_a,
        plain_launches=launch_b)
    check(bool(geo_a.has_H.any()), "train parity input found no homography")
    check(all(v == PER_TRAIN_STEP.get(k, 0) for k, v in launch_a.items()),
          "the kernel step did not launch each of K1-K5 4 times and K6 "
          "twice")
    check(not any(launch_b.values()), "the plain step launched a kernel")
    check((a["num_matches"], a["num_inliers"])
          == (b["num_matches"], b["num_inliers"]),
          "kernel and plain steps matched differently")
    check(loss_rel <= TRAIN_PARITY["loss_rel"],
          f"train step loss differs by {loss_rel}")
    check(worst <= TRAIN_PARITY["grad_rel_l2"],
          f"gradient of {worst_name} differs by {worst} (relative L2)")
# ------------------------------------------------------------ phase 7 ------

EVAL_HW = ((427, 640), (480, 640))   # the infer pair: a PNG and a PPM
FIXTURE_HW = (600, 800)              # HPatches-sized sequences
FIXTURE_SEQS = ("i_smoke", "v_smoke")
EVAL_IMSIZE = 480                    # the HPatches protocol's
FIT_THR = 3.0


def _png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit grey PNG of img [h, w] uint8 (no row filter)."""
    import struct
    import zlib

    h, w = img.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in img)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _ppm_bytes(img: np.ndarray) -> bytes:
    """A P6 PPM of a grey img [h, w] uint8 (R = G = B)."""
    h, w = img.shape
    return b"P6\n%d %d\n255\n" % (w, h) + np.repeat(
        img[..., None], 3, -1).tobytes()


def _u8(img: np.ndarray) -> np.ndarray:
    return np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)


def _write_fixture(root, rng) -> None:
    """Two sequences in the HPatches layout at FIXTURE_HW: 1.ppm ... 6.ppm
    and H_1_k; i_smoke under small shifts, v_smoke under perspective
    homographies."""
    from geoformer_tpu_torch.data.native import native_warp
    from geoformer_tpu_torch.eval.synthetic import textured_pair

    h, w = FIXTURE_HW
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], float)
    for s, name in enumerate(FIXTURE_SEQS):
        d = root / name
        d.mkdir()
        base = textured_pair(FIXTURE_HW, 20 + s)[0]
        (d / "1.ppm").write_bytes(_ppm_bytes(_u8(base)))
        for k in range(2, 7):
            shift = rng.uniform(-0.1 if s else -0.01, 0.1 if s else 0.01,
                                (4, 2)) * [w, h]
            A = []
            for (x, y), (u, v) in zip(corners, corners + shift):
                A += [[x, y, 1, 0, 0, 0, -u * x, -u * y, -u],
                      [0, 0, 0, x, y, 1, -v * x, -v * y, -v]]
            H = np.linalg.svd(np.array(A))[2][-1].reshape(3, 3)
            H /= H[2, 2]
            img = native_warp(base[None], H[None])[0]
            (d / f"{k}.ppm").write_bytes(_ppm_bytes(_u8(img)))
            np.savetxt(d / f"H_1_{k}", H)


def _forward_launches(launches: dict, forwards: int, what: str) -> None:
    for name, count in launches.items():
        want = PER_FORWARD.get(name, 0) * forwards
        check(count == want, f"{what}: {name} launched {count} times in "
              f"{forwards} forwards, expected {want // forwards} each")


@contextlib.contextmanager
def _record_fits(hp):
    """Within the block, each call of hp.fit_homography_np appends (number
    of correspondences, whether it gave H, its ms up to a synchronize) to
    the list it yields."""
    fits = []
    real = hp.fit_homography_np

    def record(p0, *args, **kw):
        t0 = time.perf_counter()
        H, inliers = real(p0, *args, **kw)
        torch.cuda.synchronize()
        fits.append((len(p0), H is not None,
                     (time.perf_counter() - t0) * 1e3))
        return H, inliers

    hp.fit_homography_np = record
    try:
        yield fits
    finally:
        hp.fit_homography_np = real


def phase_eval_path(device, live_model):
    """The evaluation path from image files on the card, with phase 3's
    live-GAM weights (random, seed 0, coarse threshold LIVE_THR, bf16, K1
    and K2): files written here (an 8-bit PNG and a P6 PPM of a textured
    pair, a 2-sequence HPatches fixture) decode back byte for byte;
    ``infer`` runs through the command line, and the matcher, the fit and
    the HPatches driver on the card, each with 4 K1 and 4 K2 launches a
    forward and none of K3-K5. Random weights leave a flat fine confidence,
    so the matcher and the driver run with a fine threshold of 1e-3 to keep
    final matches to fit; every pair with 4 or more gets a finite H, and
    the fit also recovers a known H from 1024 synthetic matches."""
    import contextlib as ctx
    import dataclasses
    import io
    import tempfile
    import warnings

    from geoformer_tpu_torch import cli
    from geoformer_tpu_torch.eval import hpatches as hp
    from geoformer_tpu_torch.eval.image_io import read_gray
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray
    from geoformer_tpu_torch.eval.metrics import corner_error
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train.checkpoint import save_params

    live = live_model.config
    cfg = live.replace(fine_match=dataclasses.replace(live.fine_match,
                                                      thr=1e-3))
    model = GeoFormer(cfg)
    model.load_state_dict(live_model.state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        img0 = _u8(textured_pair(EVAL_HW[0], 0)[0])
        img1 = _u8(textured_pair(EVAL_HW[1], 0)[1])
        paths = (tmp / "pair0.png", tmp / "pair1.ppm")
        paths[0].write_bytes(_png_bytes(img0))
        paths[1].write_bytes(_ppm_bytes(img1))
        for path, img in zip(paths, (img0, img1)):
            check(np.array_equal(read_gray(str(path)), img),
                  f"{path.name} decodes to other bytes")
        t0 = time.perf_counter()
        (im0, sc0), (im1, sc1) = (load_gray(str(p), EVAL_IMSIZE)
                                  for p in paths)
        load_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(im1, img1.astype(np.float32) / 255),
              "load_gray changed an image it need not resize")
        check(im0.shape == (424, 640) and sc0 == (1.0, 427 / 424),
              f"load_gray of the PNG: {im0.shape} {sc0}")

        # the command line, as a user runs it, with the live weights
        save_params(str(tmp / "random.npz"), live_model, 0)
        out = io.StringIO()
        gk.reset_launch_counts()
        with ctx.redirect_stdout(out):
            cli.main(["infer", str(paths[0]), str(paths[1]), "--ckpt",
                      str(tmp / "random.npz"), "--match-thr", str(LIVE_THR),
                      "--bf16", "--pallas", "--device", str(device),
                      "--out", str(tmp / "m.npy")])
        torch.cuda.synchronize()
        _forward_launches(dict(gk.LAUNCHES), 1, "infer")
        infer_line = out.getvalue().splitlines()[0]
        saved = np.load(tmp / "m.npy")
        check(saved.ndim == 2 and saved.shape[1] == 5
              and bool(np.isfinite(saved).all()), "infer's saved matches")
        check("has_H=True" in infer_line, f"infer: {infer_line}")

        # the pair through the matcher and the fit, each timed
        matcher = BatchedMatcher(cfg, model, batch_size=1, device=device)
        matcher.match_batch([im0], [im1])           # the bucket's first call
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        (mk0, mk1, conf, geo), = matcher.match_batch([im0], [im1],
                                                     return_geo=True)
        fwd_ms = (time.perf_counter() - t0) * 1e3
        _forward_launches(dict(gk.LAUNCHES), 1, "match_batch")
        for a in (mk0, mk1, conf, geo["H"]):
            check(bool(np.isfinite(a).all()), "non-finite matcher output")
        check(len(mk0) >= 4, f"{len(mk0)} final matches on the infer pair")
        with _record_fits(hp) as fits:
            for _ in range(2):                       # a warm-up, then timed
                H, inliers = hp.fit_homography_np(mk0, mk1, FIT_THR,
                                                  device=device)
        check(H is not None and bool(np.isfinite(H).all()),
              "the fit failed on the infer pair")

        # the fit at the HPatches driver's scale: 1024 matches, a third
        # of them wrong, under a known homography
        rng = np.random.default_rng(0)
        H_true = np.array([[0.9, 0.08, 20.0], [-0.05, 1.1, -12.0],
                           [2e-4, -1e-4, 1.0]])
        p0 = rng.random((1024, 2)) * [640, 480]
        ph = np.concatenate([p0, np.ones((1024, 1))], 1) @ H_true.T
        p1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.5, (1024, 2))
        p1[:341] = rng.random((341, 2)) * [640, 480]
        with _record_fits(hp) as fits_1024:
            for _ in range(2):
                H_syn, _ = hp.fit_homography_np(p0.astype(np.float32),
                                                p1.astype(np.float32),
                                                FIT_THR, device=device)
        syn_err = corner_error(H_true, H_syn, (480, 640))
        check(syn_err < 1.0, f"the fit missed a known H by {syn_err} px")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                hp.fit_homography_np(p0.astype(np.float32),
                                     p1.astype(np.float32), FIT_THR,
                                     device=device)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        fit_syncs = sum("synchroniz" in str(w.message) for w in caught)
        log("eval_path_infer", line=repr(infer_line), matches=len(mk0),
            has_H=geo["has_H"], gam_inliers=geo["num_inliers"],
            fit_inliers=int(inliers.sum()),
            load_ms_per_pair=f"{load_ms:.2f}", forward_ms=f"{fwd_ms:.2f}",
            fit_ms=f"{fits[-1][2]:.2f}",
            fit_1024_ms=f"{fits_1024[-1][2]:.2f}",
            fit_1024_corner_px=f"{syn_err:.4f}", fit_host_syncs=fit_syncs)

        root = tmp / "hpatches"
        root.mkdir()
        _write_fixture(root, np.random.default_rng(0))
        lines = []
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with _record_fits(hp) as fits:
            res = hp.eval_hpatches(model, cfg, str(root), imsize=EVAL_IMSIZE,
                                   ransac_thr=FIT_THR, log=lines.append,
                                   device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the prewarm's one forward a bucket, then each sequence's five
        # pairs in batches of two
        forwards = int(lines[0].split()[1]) + len(FIXTURE_SEQS) * math.ceil(
            5 / 2)
        _forward_launches(dict(gk.LAUNCHES), forwards, "eval_hpatches")
    log("eval_path_hpatches", size=f"{FIXTURE_HW[0]}x{FIXTURE_HW[1]}",
        imsize=EVAL_IMSIZE, pairs=res["n_pairs"], est_failed=res["est_failed"],
        matches=[n for n, _, _ in fits], has_fit=[ok for _, ok, _ in fits],
        match_ms_per_pair=f"{res['match_time'] * 1e3:.2f}",
        fit_ms_per_pair=f"{np.mean([ms for _, _, ms in fits]):.2f}",
        wall_ms_per_pair=f"{wall * 1e3 / res['n_pairs']:.2f}",
        inlier_rate=f"{res['inlier_rate']:.4f}", auc_a=res.get("auc_a"),
        forwards=forwards, census=repr(lines[0]))
    check(res["n_pairs"] == 10, "the HPatches fixture was not read")
    check(all(ok for n, ok, _ in fits if n >= 4),
          "a fixture pair with 4 or more matches got no homography")
    check(all(math.isfinite(x) for k in ("auc_a", "correct_a")
              for x in res[k]), "non-finite HPatches metrics")


# ------------------------------------------------------------ phase 8 ------

REPO = Path(__file__).resolve().parent
CKPT = REPO / "checkpoints" / "tpu_r3_main" / "params_final.npz"
SELFCHECK = dict(pairs=40, hw=(480, 640), seed=123456, ransac_thr=3.0)
SELFCHECK_SETS = ("procedural", "held-out-photos")
# AUC@1/3/5/10 references of the self-check on its own pairs (the port's
# make_pairs), measured on a CPU by tests/torch_port_selfcheck_compare.py
# (PERF.md §6): f32, the port's mean over 3 GAM seeds x 3 fit
# seeds; bf16, the JAX package's bf16 forward (its CPU path, no Pallas)
# over 3 fit keys.
SELFCHECK_REF = {
    ("procedural", "float32"): (0.6446, 0.8544, 0.9066, 0.9515),
    ("held-out-photos", "float32"): (0.6571, 0.8665, 0.9099, 0.9425),
    ("procedural", "bfloat16"): (0.6402, 0.8462, 0.9022, 0.9464),
    ("held-out-photos", "bfloat16"): (0.6617, 0.8685, 0.9111, 0.9431),
}
# f32: the spread of the CPU runs of the same pairs (the largest range,
# over both image sets, of the port's 9 runs and JAX's 3), since the card
# draws the GAM's and the fit's samples from other streams; bf16: 0.03 at
# 1 px and 0.02 at 3/5/10 px of the JAX package's bf16.
SELFCHECK_TOL = {"float32": (0.0182, 0.0146, 0.0212, 0.0231),
                 "bfloat16": (0.03, 0.02, 0.02, 0.02)}


def phase_eval_trained(device):
    """The self-check with the trained checkpoint, when it is there: 40
    pairs at 480x640, procedural and held-out photographs, through K1 and
    K2 in f32 and in bf16, each AUC held to its CPU reference."""
    from geoformer_tpu_torch.eval import selfcheck as sc
    from geoformer_tpu_torch.ops import gam_kernels as gk

    if not CKPT.is_file():
        print(f"[eval_trained] absent path={CKPT}", flush=True)
        return
    pairs = {name: sc.make_pairs(
        SELFCHECK["pairs"], SELFCHECK["hw"], SELFCHECK["seed"],
        [name] if name != "procedural" else None) for name in SELFCHECK_SETS}
    forwards = math.ceil(SELFCHECK["pairs"] / sc.BATCH)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        model = sc.load_model(sc.selfcheck_config(
            bf16=dtype == torch.bfloat16, pallas=True), str(CKPT), device)
        for image_set, (base, warped, Hs) in pairs.items():
            gk.reset_launch_counts()
            res = sc.run_pairs(model, base, warped, Hs,
                               SELFCHECK["ransac_thr"], device)
            torch.cuda.synchronize()
            launches = dict(gk.LAUNCHES)
            rec = sc.summary(res)
            ref = SELFCHECK_REF[(image_set, name)]
            delta = [round(a - b, 4) for a, b in zip(rec["auc@1/3/5/10"], ref)]
            log("eval_trained", dtype=name, images=image_set,
                pairs=rec["pairs"], auc=rec["auc@1/3/5/10"], ref_auc=ref,
                delta=delta, tol=SELFCHECK_TOL[name],
                correct=rec["correct@1/3/5/10"],
                mean_matches=rec["mean_matches"], failed=rec["failed"],
                forward_ms_per_pair=f"{res['match_s'] * 1e3 / rec['pairs']:.2f}",
                fit_ms_per_pair=f"{res['fit_s'] * 1e3 / rec['pairs']:.2f}",
                launches=launches)
            _forward_launches(launches, forwards, f"selfcheck {image_set}")
            check(all(abs(d) <= t for d, t in zip(delta, SELFCHECK_TOL[name])),
                  f"self-check {name} {image_set}: AUC {rec['auc@1/3/5/10']}"
                  f" against {ref}")


# ------------------------------------------------------------ phase 9 ------

# Run A: the headline recipe with every option of the loop on; Run B
# resumes it. ckpt_every and val_every 2 give a checkpoint and a validation
# after steps 2 and 4 (and 6 in Run B); bank_refresh 3 rebuilds the bank
# once in Run A (before its 4th batch).
LOOP = dict(steps_a=4, steps_b=6, ckpt_every=2, val_every=2, bank_refresh=3)
VAL_SEEDS = (0, 1, 2)       # RANSAC generator seeds of the trained val step
VAL_B = 2                   # pairs of the trained val step (card and CPU)
# the least bar of each trained val scalar (|card mean - CPU mean|) where
# the CPU runs' spread over VAL_SEEDS is narrower: f32 sums in another
# order (relative for the losses and matches, px for the corner error)
VAL_FLOOR = {"val_loss": 1e-3, "val_loss_c": 1e-3, "val_loss_d": 1e-3,
             "val_loss_f": 1e-3, "val_num_matches": 1e-2,
             "val_corner_err_median": 0.05, "val_fit_rate": 0.0}
VAL_RELATIVE = ("val_loss", "val_loss_c", "val_loss_d", "val_loss_f",
                "val_num_matches")


def _counted(rec: list, gk, fn):
    """fn, appending (synchronized ms, launches of each kernel) of each
    call to rec."""
    def call(*args, **kwargs):
        before = dict(gk.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        rec.append(((time.perf_counter() - t0) * 1e3, {
            k: v - before[k] for k, v in gk.LAUNCHES.items()}))
        return out
    return call


@contextlib.contextmanager
def _instrumented(loop_mod, gk, reference=None):
    """Within the block, run_training's train and val steps record the
    launches and the synchronized ms of each call, its checkpoint saves
    their ms, each restore its ms and whether the state it returns equals
    ``reference`` bit for bit, and the texture banks their seconds."""
    from geoformer_tpu_torch.data import synthetic

    rec = {"train": [], "val": [], "save_ms": [], "restore": [],
           "bank_s": []}
    saved = {name: getattr(loop_mod, name) for name in (
        "make_train_step", "make_val_step", "save_checkpoint",
        "restore_checkpoint")}
    bank = synthetic._procedural_bank

    def save(*args, **kwargs):
        t0 = time.perf_counter()
        saved["save_checkpoint"](*args, **kwargs)
        rec["save_ms"].append((time.perf_counter() - t0) * 1e3)

    def restore(*args, **kwargs):
        t0 = time.perf_counter()
        st = saved["restore_checkpoint"](*args, **kwargs)
        torch.cuda.synchronize()
        rec["restore"].append(((time.perf_counter() - t0) * 1e3,
                               reference is not None
                               and _same_state(st, reference)))
        return st

    def build_bank(*args, **kwargs):
        t0 = time.perf_counter()
        out = bank(*args, **kwargs)
        rec["bank_s"].append((time.perf_counter() - t0, out.shape))
        return out

    loop_mod.make_train_step = lambda *a: _counted(
        rec["train"], gk, saved["make_train_step"](*a))
    loop_mod.make_val_step = lambda *a: _counted(
        rec["val"], gk, saved["make_val_step"](*a))
    loop_mod.save_checkpoint = save
    loop_mod.restore_checkpoint = restore
    synthetic._procedural_bank = build_bank
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(loop_mod, name, fn)
        synthetic._procedural_bank = bank


def _same_state(a, b) -> bool:
    """Bit for bit: model variables, both AdamW moments, the step counts."""
    if a.step != b.step:
        return False
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if any(not torch.equal(sa[k], sb[k]) for k in sa):
        return False
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    return all(torch.equal(a.optimizer.state[pa[k]][slot],
                           b.optimizer.state[pb[k]][slot])
               for k in pa for slot in ("exp_avg", "exp_avg_sq", "step"))


def _metrics_steps(ckpt_dir: Path):
    return [json.loads(ln)["step"] for ln in
            (ckpt_dir / "metrics.jsonl").read_text().splitlines()]


def _per_call_launches(records, kind, expect, steps):
    check(len(records) == steps, f"{steps} {kind} steps expected, "
          f"{len(records)} ran")
    for i, (_, launches) in enumerate(records):
        for name, count in launches.items():
            want = expect.get(name, 0)
            check(count == want, f"{kind} step {i}: {name} launched {count} "
                  f"times, expected {want}")


def _val_batch(device, b):
    """The loop's held-out validation batch (base images from seed +
    9999), its pairs drawn on the host so that the card and the CPU get
    the same batch."""
    from geoformer_tpu_torch.data.synthetic import (
        base_image_stream,
        make_pair_batch,
        pair_draws,
    )

    base = torch.from_numpy(next(base_image_stream(
        TRAIN_HW, b, TRAIN_SEED + 9999)))
    draws = pair_draws(b, TRAIN_HW, torch.Generator().manual_seed(
        TRAIN_SEED + 777))
    return make_pair_batch(base.to(device), draws={
        k: v.to(device) for k, v in draws.items()})


def _profile_val(val_fn, state, batch, device) -> dict:
    """One profiled val step: its device time in all and the three kernels
    that take the most of it, with their launch counts."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        val_fn(state, batch, generator=torch.Generator(device).manual_seed(0))
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {}
    for e in prof.events():
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        ms, count = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (ms + (e.time_range.end - e.time_range.start)
                           / 1e3, count + 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
    return {"device_ms": round(sum(ms for ms, _ in kernels.values()), 1),
            "top": [(name[:60], round(ms, 1), count)
                    for name, (ms, count) in top]}


def _trained_val(device):
    """The val step on the trained checkpoint through K1/K2 on the card,
    over VAL_SEEDS, held to the same step on the host's CPU (the plain
    versions) over the same seeds on the same batch."""
    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.eval import selfcheck as sc
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train.optim import make_optimizer
    from geoformer_tpu_torch.train.trainer import TrainState, make_val_step

    if not CKPT.is_file():
        print(f"[training_loop_trained_val] absent path={CKPT}", flush=True)
        return None
    tcfg = TrainConfig(batch_size=VAL_B, image_hw=TRAIN_HW)
    val_fn = make_val_step(tcfg)
    runs, ms = {}, {"cuda": [], "cpu": []}
    for where in ("cuda", "cpu"):
        dev = device if where == "cuda" else torch.device("cpu")
        model = sc.load_model(headline_config(), str(CKPT), dev)
        state = TrainState(model, make_optimizer(tcfg.optim,
                                                 model.parameters()))
        batch = _val_batch(dev, VAL_B)
        runs[where] = []
        for seed in VAL_SEEDS:
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            out = val_fn(state, batch,
                         generator=torch.Generator(dev).manual_seed(seed))
            runs[where].append({k: float(v) for k, v in out.items()})
            ms[where].append((time.perf_counter() - t0) * 1e3)
            if where == "cuda":
                _forward_launches(dict(gk.LAUNCHES), 1, "trained val step")
        if where == "cuda":
            profile = _profile_val(val_fn, state, batch, dev)
        del state, model
    torch.cuda.empty_cache()
    rows = {}
    for key in VAL_FLOOR:
        card = [r[key] for r in runs["cuda"]]
        cpu = [r[key] for r in runs["cpu"]]
        mean_cpu = sum(cpu) / len(cpu)
        floor = VAL_FLOOR[key] * (abs(mean_cpu) if key in VAL_RELATIVE
                                  else 1.0)
        bar = max(max(cpu) - min(cpu), floor)
        delta = sum(card) / len(card) - mean_cpu
        rows[key] = dict(card=card, cpu=cpu, delta=round(delta, 6),
                         bar=round(bar, 6))
        check(all(math.isfinite(x) for x in card + cpu),
              f"trained val step: non-finite {key}")
        check(abs(delta) <= bar, f"trained val step {key}: card {card} "
              f"against CPU {cpu}, bar {bar}")
    log("training_loop_trained_val", config="headline, trained checkpoint, "
        f"val batch B={VAL_B}", seeds=VAL_SEEDS,
        card_ms=[f"{x:.1f}" for x in ms["cuda"]],
        cpu_ms=[f"{x:.1f}" for x in ms["cpu"]], card_profile=profile, **rows)


def phase_training_loop(device, phase5_ms_step):
    """run_training at the headline recipe with every option on (Run A:
    checkpoints, validation, TensorBoard events and figures, the sensor
    stack, bank refresh), then Run B resuming it; the launches per train
    and per val step; the restored state against Run A's; one `cli train`
    in a subprocess; and the val step on the trained checkpoint against
    the CPU."""
    import io
    import tempfile

    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train import checkpoint as ck
    from geoformer_tpu_torch.train import loop
    from geoformer_tpu_torch.utils.tb_events import read_events

    cfg = headline_config()
    kw = dict(batch_size=TRAIN_B, image_hw=TRAIN_HW, log_every=1,
              seed=TRAIN_SEED, model_cfg=cfg, bank_size=256,
              ckpt_every=LOOP["ckpt_every"], val_every=LOOP["val_every"],
              tensorboard=True, log_figures=True, sensor_aug=True,
              bank_refresh=LOOP["bank_refresh"], device=device)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp) / "run"
        buf = io.StringIO()
        gk.reset_launch_counts()
        with _instrumented(loop, gk) as rec_a, \
                contextlib.redirect_stdout(buf):
            state_a = loop.run_training(steps=LOOP["steps_a"],
                                        ckpt_dir=str(out_dir), **kw)
        launches_a = dict(gk.LAUNCHES)
        with _instrumented(loop, gk, reference=state_a) as rec_b, \
                contextlib.redirect_stdout(buf):
            state_b = loop.run_training(steps=LOOP["steps_b"], resume=True,
                                        ckpt_dir=str(out_dir), **kw)
        printed = buf.getvalue()
        steps_on_disk = sorted(ck.checkpoint_steps(str(out_dir)))
        ckpt_mb = (out_dir / str(LOOP["steps_a"]) / ck.STATE_FILE) \
            .stat().st_size / 1e6
        metric_steps = _metrics_steps(out_dir)
        events = [ev for f in sorted((out_dir / "tb").iterdir())
                  for ev in read_events(str(f))]
        cli_dir = Path(tmp) / "cli"
        # This process's allocator still caches ~67 GiB here (phase 8's
        # and Runs A and B's blocks, ~0.5 GiB of it in use), which left
        # the subprocess ~11 GiB of the card, and its step once failed
        # there with a cuDNN internal error. Hand the cache back first.
        held_gib = torch.cuda.memory_reserved() / 2**30
        torch.cuda.empty_cache()
        cli_free_gib = torch.cuda.mem_get_info()[0] / 2**30
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "geoformer_tpu_torch.cli", "train",
             "--pallas", "--steps", "2", "--batch", "2", "--device", "cuda",
             "--out", str(cli_dir)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        cli_files = sorted(p.name for p in cli_dir.iterdir()) \
            if cli_dir.is_dir() else []

    # Run A: 4 train steps, 2 val steps, 2 figure forwards (K1/K2 only)
    train_k, val_k = PER_TRAIN_STEP, PER_FORWARD
    _per_call_launches(rec_a["train"], "train", train_k, LOOP["steps_a"])
    n_val_a = LOOP["steps_a"] // LOOP["val_every"]
    _per_call_launches(rec_a["val"], "val", val_k, n_val_a)
    for name, count in launches_a.items():
        want = (PER_TRAIN_STEP.get(name, 0) * LOOP["steps_a"]
                + 2 * PER_FORWARD.get(name, 0) * n_val_a)
        check(count == want, f"Run A launched {name} {count} times, "
              f"expected {want} (K1-K5 4 and K6 2 a train step; K1/K2 4 "
              "and K6 2 a val step and a figure forward)")
    _per_call_launches(rec_b["train"], "train", train_k,
                       LOOP["steps_b"] - LOOP["steps_a"])
    _per_call_launches(rec_b["val"], "val", val_k, 1)
    (restore_ms, restored_same), = rec_b["restore"]
    check(restored_same, "Run B did not restore Run A's state bit for bit")
    check(state_b.step == LOOP["steps_b"], f"Run B ended at {state_b.step}")
    check(f"resumed at step {LOOP['steps_a']}" in printed,
          "Run B did not print its resume line")
    check(steps_on_disk == [2, 4, 6], f"checkpoints {steps_on_disk}")
    check(metric_steps == [1, 2, 2, 3, 4, 4, 5, 6, 6],
          f"metrics.jsonl steps {metric_steps}")
    scalars = {(v["tag"], ev["step"]) for ev in events
               for v in ev.get("values", []) if "simple_value" in v}
    images = [(v["description"], ev["step"]) for ev in events
              for v in ev.get("values", []) if "image" in v]
    check(len(scalars) == 6 * 9 + 3 * 7 and len(images) == 3,
          f"event files: {len(scalars)} scalars, {len(images)} images")
    check(all(math.isfinite(v["simple_value"]) or v["tag"]
              == "val_corner_err_median" for ev in events
              for v in ev.get("values", []) if "simple_value" in v),
          "non-finite scalar in the event file")
    # Run A: the val bank, its bank, the refresh; Run B: the val bank, its
    # bank (its 2 batches come before a refresh)
    check(len(rec_a["bank_s"]) == 3 and len(rec_b["bank_s"]) == 2,
          f"banks built: {len(rec_a['bank_s'])} + {len(rec_b['bank_s'])}")
    check(cli.returncode == 0, f"cli train failed:\n{cli.stderr[-3000:]}")
    check({"2", "metrics.jsonl", "params_final.npz"} <= set(cli_files),
          f"cli train wrote {cli_files}")
    train_ms = [t for t, _ in rec_a["train"] + rec_b["train"]]
    val_ms = [t for t, _ in rec_a["val"] + rec_b["val"]]
    val_lines = [json.loads(ln) for ln in printed.splitlines()
                 if ln.startswith('{"val_')]
    log("training_loop", config="headline(480x640,f32,batch4,K1-K5)+"
        "ckpt_every2,val_every2,tensorboard,log_figures,sensor_aug,"
        "bank_refresh3", run_a_steps=LOOP["steps_a"],
        run_b_steps=LOOP["steps_b"],
        train_step_ms=[f"{x:.1f}" for x in train_ms],
        ms_per_step_after_first=f"{sum(train_ms[1:]) / len(train_ms[1:]):.1f}",
        phase5_ms_per_step=f"{phase5_ms_step:.1f}",
        val_step_ms=[f"{x:.1f}" for x in val_ms],
        ckpt_save_ms=[f"{x:.1f}" for x in rec_a["save_ms"] + rec_b["save_ms"]],
        ckpt_restore_ms=f"{restore_ms:.1f}", ckpt_mb=f"{ckpt_mb:.1f}",
        bank_s=[f"{t:.2f}" for t, _ in rec_a["bank_s"] + rec_b["bank_s"]],
        bank_shapes=[list(s) for _, s in rec_a["bank_s"] + rec_b["bank_s"]],
        checkpoints=steps_on_disk, metrics_steps=metric_steps,
        event_scalars=len(scalars), event_images=images,
        launches_run_a=launches_a,
        launches_per_train_step=rec_a["train"][0][1],
        launches_per_val_step=rec_a["val"][0][1],
        val=[{k: round(v, 4) for k, v in m.items()} for m in val_lines],
        cli_s=f"{cli_s:.1f}", cli_files=cli_files,
        held_before_cli_gib=f"{held_gib:.2f}",
        card_free_for_cli_gib=f"{cli_free_gib:.2f}",
        restored_bit_exact=restored_same)
    del state_a, state_b
    torch.cuda.empty_cache()
    _trained_val(device)


# ------------------------------------------------------------ phase 10 -----

# The standing FIRE/ISC gate's corpora (eval/fire_isc_protocol.py) at full
# image size, a stated subset of the whole gate (49 FIRE pairs, 40 ISC
# pairs, 80 classification lines), for the script's time limit: the first
# 3 S, 2 P and 2 A pairs that the module's builder draws from the gate's
# seed, and the first 8 ISC pairs (two portrait 720x640 buckets among them)
# with their 16 classification lines.
FIRE_ISC = dict(seed=20260820, fire_size=1024, fire_counts=(3, 2, 2),
                isc_pairs=8)
# FIRE at imsize 768 is a 96x96 coarse grid; ISC at 480 on a 720x640
# (portrait) image resizes to 536x480, padded to 576x512: 72x64.
FIRE_GRID = (1, (96, 96))
ISC_PORTRAIT_GRID = (2, (72, 64))


def _jpeg_round_trips(src, jpeg):
    """encode -> decode three times at q95: the first round's error against
    the source beside the quantisation bounds, and the pixels each later
    round moves."""
    q = jpeg.quality_table(95).astype(np.float64)
    c = np.full(8, 0.5)
    c[0] = math.sqrt(1 / 8)
    # |pixel error| <= sum (q/2) |c_u c_v| + 1/2 (rounding); the RMS by
    # Parseval at most sqrt(mean((q/2)^2)) + 1/2
    max_bound = float((q.reshape(8, 8) / 2 * np.outer(c, c)).sum() + 0.5)
    rms_bound = float(np.sqrt(((q / 2) ** 2).mean()) + 0.5)
    rounds = [src]
    for _ in range(3):
        rounds.append(jpeg.decode_gray(jpeg.encode_gray(rounds[-1], 95)))
    e1 = rounds[1].astype(np.float64) - src
    moved = [float((rounds[i + 1] != rounds[i]).mean()) for i in (1, 2)]
    step = [int(np.abs(rounds[i + 1].astype(int) - rounds[i]).max())
            for i in (1, 2)]
    return dict(err_max=int(np.abs(e1).max()), err_max_bound=round(max_bound,
                                                                     2),
                err_rms=round(float(np.sqrt((e1 ** 2).mean())), 4),
                err_rms_bound=round(rms_bound, 4), moved_round2=moved[0],
                moved_round3=moved[1], max_step_round2=step[0],
                max_step_round3=step[1])


def _eval_grid_kernels(device):
    """K1 and K2 against their plain versions at the FIRE grid (B=1,
    L = S = 9216) and a portrait ISC bucket (B=2, 72x64), bf16 and f32,
    with phase 2's bars, each kernel's ms beside its bound."""
    from geoformer_tpu_torch.eval import box_kernels as bk
    from geoformer_tpu_torch.ops import gam_kernels as gk

    gen = torch.Generator().manual_seed(10)
    out = {}
    for case, (b, grid) in (("fire", FIRE_GRID),
                            ("isc_portrait", ISC_PORTRAIT_GRID)):
        s = grid[0] * grid[1]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (_rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
                       for _ in range(3))
            centers = bk.homography_centers(b, grid).to(device)
            out[("box_window_attention", case, dtype)] = _k1_vs_plain(
                gk, q, k, v, centers, grid, "fire_isc", case=case)
            # K2 over the bench configuration's 1024 inlier slots
            k2, v2 = (_rand((b, MAX_INLIERS, HEADS, HEAD_DIM), gen, dtype,
                            device) for _ in range(2))
            mask = _prefix_like(torch.rand((b, MAX_INLIERS), generator=gen)
                                < 0.8).to(device)
            r = _mka_fwd_case(gk, q, k2, v2, mask, f"prefix/{case}")
            out[("masked_kv_attention", case, dtype)] = (r["ms"],
                                                         r["bound_ms"])
            del q, k, v, k2, v2
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _timed_parts(fit_module):
    """Within the block, the host ms of each call of the eval path's parts
    (decode: matcher.read_gray, resize: matcher.resize_linear_u8, forward:
    BatchedMatcher.match_batch, fit: fit_module.fit_homography_np up to a
    synchronize) go into the lists of the dict it yields."""
    from geoformer_tpu_torch.eval import matcher

    parts = {}
    patches = []
    for owner, attr, part, sync in (
            (matcher, "read_gray", "decode", False),
            (matcher, "resize_linear_u8", "resize", False),
            (matcher.BatchedMatcher, "match_batch", "forward", False),
            (fit_module, "fit_homography_np", "fit", True)):
        real = getattr(owner, attr)

        def wrapper(*a, _real=real, _part=part, _sync=sync, **kw):
            t0 = time.perf_counter()
            res = _real(*a, **kw)
            if _sync:
                torch.cuda.synchronize()
            parts.setdefault(_part, []).append(
                (time.perf_counter() - t0) * 1e3)
            return res

        setattr(owner, attr, wrapper)
        patches.append((owner, attr, real))
    try:
        yield parts
    finally:
        for owner, attr, real in patches:
            setattr(owner, attr, real)


def phase_fire_isc(device):
    """The FIRE and ISC-HE evaluation paths from JPEG files on the card:
    the gate's corpora built at full size into a temporary directory
    (FIRE_ISC), the decoder held on them, then `cli eval fire`, `eval isc`
    and `eval isc-cls` in bf16 through K1 and K2 with the trained
    checkpoint, the gate's thresholds, 4 launches of K1 and K2 a forward
    (K3-K5 none), the ms of each part; then K1 and K2 at these paths'
    shapes against their plain versions."""
    import shutil
    import tempfile

    from geoformer_tpu_torch import cli
    from geoformer_tpu_torch.data.synthetic import procedural_texture
    from geoformer_tpu_torch.eval import fire, isc, jpeg
    from geoformer_tpu_torch.eval import fire_isc_protocol as proto
    from geoformer_tpu_torch.eval.image_io import read_gray, read_size
    from geoformer_tpu_torch.ops import gam_kernels as gk

    if not CKPT.is_file():
        print(f"[fire_isc] absent path={CKPT}", flush=True)
        return {}
    tmp = Path(tempfile.mkdtemp(prefix="fire_isc_smoke_"))
    try:
        fire_dir, isc_dir = tmp / "fire", tmp / "isc"
        t0 = time.perf_counter()
        n_s, n_p, n_a = FIRE_ISC["fire_counts"]
        n_fire = proto.build_fire(str(fire_dir), seed=FIRE_ISC["seed"],
                                  size=FIRE_ISC["fire_size"], n_s=n_s,
                                  n_p=n_p, n_a=n_a)
        fire_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_isc = proto.build_isc(str(isc_dir), seed=FIRE_ISC["seed"] + 1,
                                n_pairs=FIRE_ISC["isc_pairs"])
        cls_txt = isc_dir / "cls_pairs.txt"
        n_cls = proto.build_isc_cls(str(isc_dir), str(cls_txt),
                                    seed=FIRE_ISC["seed"] + 2)
        isc_build_s = time.perf_counter() - t0
        files = sorted((fire_dir / "images").iterdir()) + sorted(
            (isc_dir / "query").iterdir()) + sorted(
            (isc_dir / "refer").iterdir())
        sizes = {}
        for f in files:
            t0 = time.perf_counter()
            img = read_gray(str(f))
            dt = (time.perf_counter() - t0) * 1e3
            check(img.shape == read_size(str(f)) and img.dtype == np.uint8,
                  f"{f.name}: decoded {img.shape} {img.dtype}")
            sizes.setdefault(img.shape, []).append(dt)
        isc_shapes = sorted({read_size(str(f)) for f in
                             (isc_dir / "query").iterdir()})
        check(any(h > w for h, w in isc_shapes),
              f"no portrait ISC image among {isc_shapes}")
        log("fire_isc", corpora=f"fire {n_fire} pairs ({n_s} S, {n_p} P, "
            f"{n_a} A) at {FIRE_ISC['fire_size']}^2, isc {n_isc} pairs, "
            f"isc-cls {n_cls} lines", seed=FIRE_ISC["seed"],
            fire_build_s=f"{fire_build_s:.1f}",
            isc_build_s=f"{isc_build_s:.1f}", files_decoded=len(files),
            isc_shapes=isc_shapes,
            decode_ms_by_shape={f"{h}x{w}": f"{np.mean(v):.1f} (x{len(v)})"
                                for (h, w), v in sorted(sizes.items())})
        # round trips from the builders' own images before any JPEG: a
        # fundus image and an ISC texture of the gate's sizes
        rt = {}
        rng = np.random.default_rng(FIRE_ISC["seed"])
        for name, img in (
                ("fundus_1024x1024", proto._fundus(rng, 1024)),
                ("texture_600x800", procedural_texture(rng, (600, 800)))):
            rt[name] = _jpeg_round_trips((img * 255).astype(np.uint8), jpeg)
            log("fire_isc", round_trips=name, **rt[name])
            r = rt[name]
            check(r["err_max"] <= r["err_max_bound"] and
                  r["err_rms"] <= r["err_rms_bound"],
                  f"{name}: first round off the quantisation bounds {r}")
            check(r["moved_round2"] <= 0.05 and r["max_step_round2"] <= 4
                  and r["moved_round3"] <= r["moved_round2"],
                  f"{name}: re-encoding does not settle {r}")

        # the drivers, through the command line, timed by part
        records = {}
        for bench, data, mod in (("fire", fire_dir, fire),
                                 ("isc", isc_dir, isc),
                                 ("isc-cls", cls_txt, isc)):
            out = tmp / f"{bench}.json"
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            with _timed_parts(mod) as parts:
                with contextlib.redirect_stdout(sys.stderr):
                    cli.main(["eval", bench, "--data", str(data), "--ckpt",
                              str(CKPT), "--bf16", "--pallas", "--device",
                              str(device), "--json-out", str(out)])
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(gk.LAUNCHES)
            rec = json.loads(out.read_text())
            forwards = len(parts.get("forward", []))
            n = rec["n_pairs"]
            log("fire_isc", benchmark=bench, record=json.dumps(rec),
                wall_s=f"{wall:.1f}", forwards=forwards, launches=launches,
                **{f"{k}_ms_per_pair": f"{sum(v) / n:.1f}"
                   for k, v in parts.items()},
                forward_ms=[f"{x:.1f}" for x in parts.get("forward", [])])
            _forward_launches(launches, forwards, f"eval {bench}")
            check(forwards == n, f"eval {bench}: {forwards} forwards for "
                  f"{n} pairs")
            records[bench] = rec
        check(records["fire"]["n_pairs"] == n_fire and
              records["isc"]["n_pairs"] == n_isc and
              records["isc-cls"]["n_pairs"] == n_cls,
              f"pair counts {[r['n_pairs'] for r in records.values()]}")
        gate = {"fire": records["fire"], "isc": records["isc"],
                "isc_cls": records["isc-cls"]}
        log("fire_isc", gate_pass=proto.gate(gate),
            fire_mauc=records["fire"]["mAUC"],
            fire_failed=records["fire"]["failed"],
            isc_auc=records["isc"]["auc"], isc_eer=records["isc-cls"]["eer"])
        check(proto.gate(gate), f"FIRE/ISC gate missed: {gate}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _eval_grid_kernels(device)


# ------------------------------------------------------------ phase 11 -----

# A cut of the standing HPatches gate's corpus (eval/hpatches_synth.py: 108
# sequences, 540 pairs), for the script's time limit: the builder's first 3
# i_ and 3 v_ sequences from seed 0, at full size (30 pairs; two v_
# sequences change size between images).
HP_SUBSET = dict(seed=0, n_i=3, n_v=3)
HP_PAIRS = 5 * (HP_SUBSET["n_i"] + HP_SUBSET["n_v"])
# cli parity's default gate: the reference README's AUC@1/3/5/10 block,
# within 1 point. The synthetic corpus is easier than HPatches: the trained
# checkpoint meets the block on the CPU (PERF.md §6), so a miss here is a
# fault of the path.
README_AUC = (0.5154, 0.7206, 0.7997, 0.8768)
GATE_PT = 1.0
SERVE_CALLS = 5         # timed calls of the bundle and of the eager matcher
SERVE_KP_PX = 1e-4      # bundle vs eager keypoints, same kernels and noise

# the bundle's process: torch, numpy and the op registrations only
_SERVE_CODE = """
import json, sys, time
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from geoformer_tpu_torch.ops import gam_kernels as gk
from geoformer_tpu_torch.serving import load_bundle
t0 = time.perf_counter()
m = load_bundle(sys.argv[1])
load_s = time.perf_counter() - t0
x = np.load(sys.argv[2])
gk.reset_launch_counts()
out = m(x["image0"], x["image1"])
torch.cuda.synchronize()
launches = dict(gk.LAUNCHES)
ms = []
for _ in range(int(sys.argv[4])):
    t0 = time.perf_counter()
    m(x["image0"], x["image1"])
    ms.append((time.perf_counter() - t0) * 1e3)
np.savez(sys.argv[3], **out)
print(json.dumps({"launches": launches, "load_s": load_s, "ms": ms,
                  "device": torch.cuda.get_device_name(0),
                  "model_modules": sorted(
                      k for k in sys.modules
                      if k.startswith("geoformer_tpu_torch.models"))}))
"""


@contextlib.contextmanager
def _count_forwards():
    """Within the block, the number of GeoFormer forwards (the matcher's
    batches and its prewarm) is the yielded list's length."""
    from geoformer_tpu_torch.models import GeoFormer

    calls = []

    def hook(module, args, out):
        if isinstance(module, GeoFormer):
            calls.append(1)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield calls
    finally:
        handle.remove()


def _serving_pairs(b, hw, seed=11):
    """[b, H, W, 1] textures and their warps by a corner jitter, float32."""
    from geoformer_tpu_torch.data.synthetic import procedural_texture
    from geoformer_tpu_torch.eval import hpatches_synth as hs

    rng = np.random.default_rng(seed)
    base = [procedural_texture(rng, hw) for _ in range(b)]
    warped = [hs.warp_perspective(x, hs._corner_h(rng, hw, hw, 0.08), hw)
              for x in base]
    return (np.stack(base)[..., None].astype(np.float32),
            np.stack(warped)[..., None].astype(np.float32))


def phase_released(device):
    """The released-checkpoint and serving paths on the card, when the
    trained checkpoint is there: a Lightning-style torch checkpoint made
    from it (eval/parity_drill.py) and loaded through the converter, its
    forward held bit-equal to the npz's; a cut of the HPatches gate's
    corpus built here (HP_SUBSET); the gate module
    (eval/hpatches_protocol.py, a subprocess) and the parity drill (`cli
    parity --ckpt` on that checkpoint, gated by the README block and by the
    gate's own AUCs) in bf16 through K1 and K2, 4 launches of each a
    forward, the ms per pair by part; `cli infer --draw --draw-geo`; and a
    serving bundle exported on the card, run in a fresh process that
    imports no model code, held to the eager forward with the same noise."""
    import io
    import shutil
    import tempfile

    from geoformer_tpu_torch import cli
    from geoformer_tpu_torch.eval import hpatches as hp
    from geoformer_tpu_torch.eval import hpatches_protocol, hpatches_synth
    from geoformer_tpu_torch.eval import parity_drill
    from geoformer_tpu_torch.eval import selfcheck as sc
    from geoformer_tpu_torch.eval.image_io import read_gray, read_size
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.serving import export as serving
    from geoformer_tpu_torch.utils.torch_convert import load_torch_weights

    if not CKPT.is_file():
        print(f"[released] absent path={CKPT}", flush=True)
        return
    torch.cuda.empty_cache()        # room for the subprocesses below
    tmp = Path(tempfile.mkdtemp(prefix="released_smoke_"))
    try:
        # the torch checkpoint, both loads on the card, the same forward
        t0 = time.perf_counter()
        ckpt = tmp / "drill_geoformer.ckpt"
        n_tensors = parity_drill.fabricate_checkpoint(str(CKPT), str(ckpt))
        cfg = sc.selfcheck_config(bf16=True, pallas=True)
        from_npz = sc.load_model(cfg, str(CKPT), device)
        from_ckpt = load_torch_weights(GeoFormer(cfg), str(ckpt)).to(
            device).eval()
        sd_npz, sd_ckpt = from_npz.state_dict(), from_ckpt.state_dict()
        check(sd_npz.keys() == sd_ckpt.keys() and all(
            torch.equal(sd_npz[k], sd_ckpt[k]) for k in sd_npz),
            "the .ckpt's weights differ from the npz's")
        ckpt_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        corpus = tmp / "hpatches"
        n_seq = hpatches_synth.build(str(corpus), **HP_SUBSET)
        build_s = time.perf_counter() - t0
        seqs = sorted(p.name for p in corpus.iterdir())
        sizes = {s: sorted({read_size(str(corpus / s / f"{i}.ppm"))
                            for i in range(1, 7)}) for s in seqs}
        changing = [s for s, v in sizes.items() if len(v) > 1]
        log("released", corpus=f"{n_seq} sequences, {HP_PAIRS} pairs",
            build_s=f"{build_s:.1f}", sizes=sizes, size_changes=changing,
            ckpt_tensors=n_tensors, ckpt_s=f"{ckpt_s:.1f}")
        check(n_seq == len(seqs) == HP_PAIRS // 5 and changing,
              f"corpus {seqs}, size changes {changing}")

        seq = corpus / changing[0]
        ims = [load_gray(str(seq / f"{i}.ppm"), 480)[0] for i in (1, 2, 5)]
        outs = []
        for name, model in (("npz", from_npz), ("ckpt", from_ckpt)):
            gk.reset_launch_counts()
            res = BatchedMatcher(cfg, model, batch_size=2,
                                 device=device).match_batch(
                ims[:1] * 2, ims[1:], return_geo=True)
            torch.cuda.synchronize()
            _forward_launches(dict(gk.LAUNCHES), 1, f"{name} forward")
            outs.append(res)
        same = all(np.array_equal(a, b) for ra, rb in zip(*outs)
                   for a, b in zip(ra[:3], rb[:3]))
        log("released", ckpt_forward_equal=same,
            matches=[len(r[0]) for r in outs[0]],
            has_H=[r[3]["has_H"] for r in outs[0]])
        check(same, "the .ckpt's forward differs from the npz's")

        # the gate module, in its own process
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rec = hpatches_protocol.main(
                ["--corpus", str(corpus), "--ckpt", str(CKPT), "--bf16",
                 "--pallas", "--device", str(device)])
        log("released", protocol=json.dumps(rec),
            wall_s=f"{time.perf_counter() - t0:.1f}")
        check(rec["n_pairs"] == HP_PAIRS and rec["est_failed"] == 0,
              f"gate module: {rec['n_pairs']} pairs, {rec['est_failed']} "
              f"failed")
        check(all(a >= r - GATE_PT / 100 for a, r in zip(rec["auc_a"],
                                                            README_AUC)),
              f"gate module: AUC {rec['auc_a']} under the README block")

        # the drill: cli parity on the torch checkpoint, in this process,
        # gated by the gate module's AUCs
        buf = io.StringIO()
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with _timed_parts(hp) as parts, _count_forwards() as fwd, \
                contextlib.redirect_stdout(buf):
            code = parity_drill.main(
                ["--npz", str(CKPT), "--corpus", str(corpus), "--ckpt-out",
                 str(ckpt), "--expect",
                 ",".join(f"{a:.6f}" for a in rec["auc_a"]), "--bf16",
                 "--pallas", "--device", str(device)])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(gk.LAUNCHES)
        drill = json.loads([ln for ln in buf.getvalue().splitlines()
                            if ln.startswith('{"auc_a"')][-1])
        log("released", drill=json.dumps(drill), exit_code=code,
            wall_s=f"{wall:.1f}", forwards=len(fwd), launches=launches,
            **{f"{k}_ms_per_pair": f"{sum(v) / HP_PAIRS:.1f}"
               for k, v in parts.items()})
        _forward_launches(launches, len(fwd), "parity drill")
        check(code == 0 and drill["pass"] and drill["n_pairs"] == HP_PAIRS
              and drill["est_failed"] == 0,
              f"parity drill: exit {code}, {drill}")

        # cli infer with both figures, on the torch checkpoint
        p0, p1 = (str(seq / f"{i}.ppm") for i in (1, 2))
        figs = [tmp / "matches.png", tmp / "geo.png"]
        gk.reset_launch_counts()
        with _count_forwards() as fwd, \
                contextlib.redirect_stdout(sys.stderr):
            cli.main(["infer", p0, p1, "--ckpt", str(ckpt), "--bf16",
                      "--pallas", "--device", str(device), "--draw",
                      str(figs[0]), "--draw-geo", str(figs[1])])
        _forward_launches(dict(gk.LAUNCHES), len(fwd), "infer")
        h0, w0 = load_gray(p0, 480)[0].shape
        h1, w1 = load_gray(p1, 480)[0].shape
        canvas = (max(h0, h1), w0 + 10 + w1)
        shapes = [read_gray(str(f)).shape for f in figs]
        log("released", infer_figures=shapes, canvas=canvas,
            forwards=len(fwd))
        check(len(fwd) == 1 and all(s == canvas for s in shapes),
              f"infer figures {shapes}, canvas {canvas}")

        # the serving bundle: exported here, run in a fresh process
        bundle, inputs, got = (tmp / "matcher.gfmz", tmp / "inputs.npz",
                               tmp / "served.npz")
        t0 = time.perf_counter()
        serving.save_bundle(str(bundle), cfg, from_npz, hw=MAIN_HW,
                            batch=MAIN_B, device=device)
        export_s = time.perf_counter() - t0
        i0, i1 = _serving_pairs(MAIN_B, MAIN_HW)
        np.savez(inputs, image0=i0, image1=i1)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _SERVE_CODE, str(bundle),
                            str(inputs), str(got), str(SERVE_CALLS)],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        serve_s = time.perf_counter() - t0
        check(r.returncode == 0, f"bundle process: {r.stderr[-3000:]}")
        served = json.loads(r.stdout.strip().splitlines()[-1])
        out = dict(np.load(got))
        s = cfg.coarse_scale
        m = torch.ones((MAIN_B, MAIN_HW[0] // s, MAIN_HW[1] // s),
                       device=device)
        with torch.no_grad():
            ref = from_npz(torch.from_numpy(i0).to(device),
                           torch.from_numpy(i1).to(device), m, m.clone(),
                           ransac_noise=serving.ransac_noise(
                               cfg, MAIN_B).to(device)).fine
        valid = ref.valid.cpu().numpy()
        kp_err = max((np.abs(out[k][valid] - getattr(ref, k).float().cpu()
                             .numpy()[valid]).max(initial=0.0))
                     for k in ("mkpts0", "mkpts1"))
        eager = BatchedMatcher(cfg, from_npz, batch_size=MAIN_B,
                               device=device)
        pairs = ([x[..., 0] for x in i0], [x[..., 0] for x in i1])
        eager.match_batch(*pairs)
        eager_ms = []
        for _ in range(SERVE_CALLS):
            t0 = time.perf_counter()
            eager.match_batch(*pairs)
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        log("released", bundle_mb=f"{bundle.stat().st_size / 2**20:.1f}",
            export_s=f"{export_s:.1f}", bundle_process_s=f"{serve_s:.1f}",
            bundle_load_s=f"{served['load_s']:.1f}",
            bundle_launches=served["launches"],
            bundle_model_modules=served["model_modules"],
            valid_equal=bool(np.array_equal(out["valid"], valid)),
            matches=valid.sum(1).tolist(), kp_max_abs_err=f"{kp_err:.3e}",
            kp_tol=SERVE_KP_PX,
            bundle_ms_per_call=[f"{x:.1f}" for x in served["ms"]],
            eager_ms_per_call=[f"{x:.1f}" for x in eager_ms],
            hw=MAIN_HW, batch=MAIN_B)
        _forward_launches(served["launches"], 1, "serving bundle")
        check(not served["model_modules"],
              f"the bundle process imported {served['model_modules']}")
        check(np.array_equal(out["valid"], valid) and valid.any()
              and kp_err <= SERVE_KP_PX,
              f"bundle vs eager: valid equal "
              f"{np.array_equal(out['valid'], valid)}, kp error {kp_err}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phase 12 -----

# The depth-supervised path at the JAX record's recipe (`cli train-depth
# --imsize 640 --batch 4 --depth-pad 640 --pallas`, f32): a cut of the
# cluttered corpus (its 6 val scenes, which the gate's stream draws from,
# and 2 of its 60 train scenes), 4 train steps and a 1-batch validation
# from random weights, the command in a subprocess, and the gate on the
# trained checkpoint (eval/depth_gate.py: 8 batches of 4 from the val
# stream, seed 67).
DEPTH = dict(train_scenes=2, val_scenes=6, steps=4, batch=4, seed=66,
             cli_steps=2)


@contextlib.contextmanager
def _depth_instrumented(loop_mod, gk):
    """Within the block, depth_loop's train and val steps record the ms and
    the launches of each call, and its pose estimator the ms, the host
    synchronisations (torch's sync debug mode) and the failed fits of each
    batch."""
    import warnings

    rec = {"train": [], "val": [], "pose": []}
    saved = {n_: getattr(loop_mod, n_) for n_ in (
        "make_depth_train_step", "make_depth_val_step",
        "batched_pose_errors")}

    def pose(*args, **kwargs):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                out = saved["batched_pose_errors"](*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        rec["pose"].append((ms, syncs, int((~out[3]).sum())))
        return out

    loop_mod.make_depth_train_step = lambda *a: _counted(
        rec["train"], gk, saved["make_depth_train_step"](*a))
    loop_mod.make_depth_val_step = lambda *a: _counted(
        rec["val"], gk, saved["make_depth_val_step"](*a))
    loop_mod.batched_pose_errors = pose
    try:
        yield rec
    finally:
        for n_, fn in saved.items():
            setattr(loop_mod, n_, fn)


def _k1_vs_plain(gk, q, k, v, centers, grid, tag, **fields):
    """K1 against its plain version on these inputs (out and in-grid LSE,
    phase 2's bars), logged under ``tag`` with its device ms beside the
    plain version's, the library call's (SDPA under the dense box mask)
    and its bound; returns (ms, bound_ms)."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    grid = tuple(grid)

    def run():
        return gk.box_window_attention_fwd(q, k, v, centers, grid, 2)

    out, lse = run()
    ref, ref_lse = gk.box_window_attention_plain(q, k, v, centers, grid, 2)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    valid = ref_lse > -1e6
    lse_err = ((lse - ref_lse)[valid].abs().max().item()
               if bool(valid.any()) else 0.0)
    tol = TOL[("box_window_attention", q.dtype)]
    nbytes = (4 * q.numel() * q.element_size() + centers.numel() * 4
              + lse.numel() * 4)
    bound, by = _bound(nbytes, 4.0 * HEAD_DIM * HEADS
                       * _box_cells(centers, grid, 2), q.dtype)
    del out, ref
    ms = bk.time_graph_ms(run, 50)
    plain_ms = time_ms(lambda: gk.box_window_attention_plain(
        q, k, v, centers, grid, 2), 3, warmup=1)
    # the library call: SDPA under the dense box mask, as phase 2 times it
    box = _dense_box(centers, grid, 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=box[:, None]), 5)
    del box
    log(tag, kernel="box_window_attention", **fields, dtype=str(q.dtype),
        shape=f"q{tuple(q.shape)}", grid=grid, max_abs_err=f"{err:.3e}",
        tol=tol, lse_max_abs_err=f"{lse_err:.3e}", lse_tol=LSE_TOL,
        kernel_ms=f"{ms:.4f}", call_ms=f"{time_ms(run, 50):.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=by,
        **_gather_load(gk, centers, grid))
    what = " ".join(str(x) for x in fields.values())
    check(err <= tol, f"K1 {what} {q.dtype}: out error {err} > {tol}")
    check(lse_err <= LSE_TOL, f"K1 {what} {q.dtype}: lse error {lse_err}")
    return ms, bound


def phase_depth(device):
    """The depth-supervised path on the card: the corpus rendered by the
    port, run_depth_training with K1-K5, `cli train-depth` in a
    subprocess, and the pose-AUC gate on the trained depth checkpoint."""
    import io
    import tempfile

    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.data import depth_corpus
    from geoformer_tpu_torch.data.hdf5 import read_dataset
    from geoformer_tpu_torch.eval import depth_gate as dg
    from geoformer_tpu_torch.eval.image_io import read_gray
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train import depth_loop

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="depth_") as tmp:
        root = Path(tmp) / "corpus"
        t0 = time.perf_counter()
        depth_corpus.build(str(root), n_scenes=DEPTH["train_scenes"],
                           n_val_scenes=DEPTH["val_scenes"],
                           seed=dg.CORPUS_SEED, cluttered=True)
        render_s = time.perf_counter() - t0
        imgs = sorted(root.glob("scenes/val0000/imgs/*"))
        t0 = time.perf_counter()
        for f in imgs:
            read_gray(str(f))
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
        deps = sorted(root.glob("scenes/val0000/depths/*"))
        t0 = time.perf_counter()
        for f in deps:
            read_dataset(str(f))
        h5_ms = (time.perf_counter() - t0) * 1e3 / len(deps)
        log("depth_render", scenes=DEPTH["train_scenes"] + DEPTH["val_scenes"],
            views=8 * (DEPTH["train_scenes"] + DEPTH["val_scenes"]),
            render_s=f"{render_s:.1f}", processes=os.cpu_count(),
            textures=sorted(depth_corpus.TEXTURES_USED),
            jpeg_decode_ms_per_image=f"{decode_ms:.1f}",
            hdf5_read_ms_per_depth=f"{h5_ms:.1f}")

        # 4 train steps from random weights with one 1-batch validation
        out_dir = Path(tmp) / "run"
        buf = io.StringIO()
        gk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with _depth_instrumented(depth_loop, gk) as rec, \
                contextlib.redirect_stdout(buf):
            state, best = depth_loop.run_depth_training(
                npz_dir=str(root / "index"), root_dir=str(root),
                val_npz_dir=str(root / "index_val"), steps=DEPTH["steps"],
                batch_size=DEPTH["batch"],
                image_hw=(dg.IMSIZE, dg.IMSIZE), ckpt_dir=str(out_dir),
                log_every=1, val_every=DEPTH["steps"], n_val_batches=1,
                seed=DEPTH["seed"], model_cfg=dg.recipe_config(),
                depth_pad=dg.DEPTH_PAD, device=device)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        files = sorted(p.name for p in out_dir.iterdir())
        best_steps = sorted(p.name for p in (out_dir / "best").iterdir())
        del state
        torch.cuda.empty_cache()

        # the command in a subprocess on the same corpus
        cli_dir = Path(tmp) / "cli"
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "geoformer_tpu_torch.cli", "train-depth",
             "--npz-dir", str(root / "index"), "--root", str(root),
             "--imsize", str(dg.IMSIZE), "--depth-pad", str(dg.DEPTH_PAD),
             "--batch", str(DEPTH["batch"]), "--steps",
             str(DEPTH["cli_steps"]), "--log-every", "1", "--pallas",
             "--out", str(cli_dir)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0

        # the gate on the trained checkpoint
        gate_state = dg.load_state(device)
        vb = dg.val_batches(str(root), device)
        gk.reset_launch_counts()
        with _depth_instrumented(depth_loop, gk) as grec, \
                _keep_inputs(gk, "box_window_attention_fwd",
                             "masked_kv_attention_fwd") as kept:
            val_fn = depth_loop.make_depth_val_step(TrainConfig(
                batch_size=dg.BATCH, image_hw=(dg.IMSIZE, dg.IMSIZE)))
            agg = depth_loop.run_depth_validation(val_fn, gate_state, vb)
        gate_launches = dict(gk.LAUNCHES)

        # the same batches through the host pose estimator
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        hstats = {}
        with _depth_instrumented(depth_loop, gk) as hrec:
            val_fn = depth_loop.make_depth_val_step(TrainConfig(
                batch_size=dg.BATCH, image_hw=(dg.IMSIZE, dg.IMSIZE)))
            agg_host = depth_loop.run_depth_validation(
                val_fn, gate_state, vb, pose_backend="host",
                pose_stats=hstats)
        host_sweep_s = time.perf_counter() - t0
        host_launches = dict(gk.LAUNCHES)

    train_k, val_k = PER_TRAIN_STEP, PER_FORWARD
    _per_call_launches(rec["train"], "depth train", train_k, DEPTH["steps"])
    _per_call_launches(rec["val"], "depth val", val_k, 1)
    _per_call_launches(grec["val"], "depth gate val", val_k, dg.BATCHES)
    train_lines = [m for m in lines if "loss" in m]
    check([m["step"] for m in train_lines] == list(range(1, DEPTH["steps"]
                                                        + 1)),
          f"depth metrics lines {[m.get('step') for m in lines]}")
    check(all(math.isfinite(m[k]) for m in train_lines
              for k in ("loss", "grad_norm")), "non-finite depth loss")
    check({"metrics.jsonl", "best", "params_final.npz",
           str(DEPTH["steps"])} <= set(files), f"train-depth wrote {files}")
    check(best_steps == [str(DEPTH["steps"])], f"best/ holds {best_steps}")
    check(cli.returncode == 0,
          f"cli train-depth failed:\n{cli.stderr[-3000:]}")
    cli_lines = [json.loads(ln) for ln in cli.stdout.splitlines()
                 if ln.startswith("{")]
    check([m["step"] for m in cli_lines] == [1, 2],
          f"cli train-depth printed {cli.stdout[-2000:]}")
    train_ms = [t for t, _ in rec["train"]]
    ms_step = sum(train_ms[1:]) / len(train_ms[1:])
    log("depth_train", config="train-depth recipe (640x640 padded, 480x640 "
        "content, f32, batch 4, K1-K5, depth_pad 640)",
        steps=DEPTH["steps"], train_step_ms=[f"{x:.1f}" for x in train_ms],
        ms_per_step_after_first=f"{ms_step:.1f}",
        images_per_s=f"{2 * DEPTH['batch'] * 1e3 / ms_step:.2f}",
        peak_allocated_gib=f"{peak_gib:.2f}",
        val_step_ms=[f"{t:.1f}" for t, _ in rec["val"]],
        pose_ms=[f"{p[0]:.1f}" for p in rec["pose"]],
        launches_per_train_step=rec["train"][0][1],
        launches_per_val_step=rec["val"][0][1],
        # each step's wall clock in the loop (from its imgs_per_s, pairs a
        # second), the batch's reading and decoding included
        loop_s_per_step=[round(DEPTH["batch"] / m["imgs_per_s"], 3)
                         for m in train_lines],
        loss=[round(m["loss"], 4) for m in train_lines],
        num_matches=[m["num_matches"] for m in train_lines],
        val=[{k: round(v, 4) for k, v in m.items()} for m in lines
             if "auc@10" in m], files=files, best=best_steps,
        cli_s=f"{cli_s:.1f}", cli_steps=[m["step"] for m in cli_lines])

    aucs = [agg[k] for k in dg.AUCS]
    pose = grec["pose"]
    log("depth_gate", checkpoint="tpu_r5_depth2", pairs=dg.BATCHES * dg.BATCH,
        auc=[round(a, 4) for a in aucs],
        cpu_reference=[round(dg.CPU_REF[k], 4) for k in dg.AUCS],
        delta=[round(agg[k] - dg.CPU_REF[k], 4) for k in dg.AUCS],
        tol=dg.GATE_TOL,
        jax_record=[round(dg.JAX_RECORD[k], 3) for k in dg.AUCS],
        delta_jax_record=[round(agg[k] - dg.JAX_RECORD[k], 4)
                          for k in dg.AUCS],
        prec=agg["prec@5e-04"], val_num_matches=agg["val_num_matches"],
        val_loss=round(agg["val_loss"], 4),
        failed_fits=sum(p[2] for p in pose),
        val_step_ms=[f"{t:.1f}" for t, _ in grec["val"]],
        pose_ms_per_batch=[f"{p[0]:.1f}" for p in pose],
        pose_host_syncs_per_batch=[p[1] for p in pose],
        launches=gate_launches)
    check(dg.gate(agg), f"depth gate: pose AUC {aucs} against the CPU "
          f"reference {dg.CPU_REF} (tol {dg.GATE_TOL}), prec@5e-04 "
          f"{agg['prec@5e-04']}, {agg['val_num_matches']} matches a pair")

    _per_call_launches(hrec["val"], "depth gate host val", val_k, dg.BATCHES)
    agg_host.update(dg.host_fields(hstats))
    log("depth_gate_host", checkpoint="tpu_r5_depth2",
        pairs=dg.BATCHES * dg.BATCH, pose_backend="host",
        auc_host=[round(agg_host[k], 4) for k in dg.AUCS],
        auc_device=[round(a, 4) for a in aucs],
        cpu_reference_host=[round(dg.CPU_REF_HOST[k], 4) for k in dg.AUCS],
        delta=[round(agg_host[k] - dg.CPU_REF_HOST[k], 4) for k in dg.AUCS],
        tol=dg.GATE_TOL, prec=agg_host["prec@5e-04"],
        host_ms_per_pair=f"{agg_host['host_ms_per_pair']:.1f}",
        pose_ms=[f"{x:.1f}" for x in hstats["ms"]],
        ransac_iters_per_pair=agg_host["ransac_iters_per_pair"],
        ransac_iters=hstats["iters"], failed_pairs=agg_host["failed_pairs"],
        cpu_failed_pairs=dg.CPU_HOST_FAILED,
        val_step_ms=[f"{t:.1f}" for t, _ in hrec["val"]],
        sweep_s=f"{host_sweep_s:.1f}", launches=host_launches,
        card=_card())
    check(dg.gate(agg_host, "host"), f"depth gate, host backend: pose AUC "
          f"{[agg_host[k] for k in dg.AUCS]} against the CPU reference "
          f"{dg.CPU_REF_HOST} (tol {dg.GATE_TOL}), {agg_host['failed_pairs']}"
          f" pairs without a pose (CPU: {dg.CPU_HOST_FAILED}), prec@5e-04 "
          f"{agg_host['prec@5e-04']}")
    _host_pose_fixed_check()

    # K1 and K2 at the depth grid on the gate's first val step's inputs
    q, k, v, centers, grid = kept["box_window_attention_fwd"][0][:5]
    _k1_vs_plain(gk, q, k, v, centers, grid, "depth_kernels",
                 inputs="gate val step 0, cross layer 0")
    q, k, v, mask = kept["masked_kv_attention_fwd"][0][:4]
    _mka_fwd_case(gk, q, k, v, mask, "depth gate val step 0, self layer 0")
    del kept
    _depth_live_step(gk, device, gate_state, vb[0])
    del gate_state, vb
    torch.cuda.empty_cache()


# The host pose estimator on the sets of its CPU tests
# (tests/test_torch_port_pose_host.py, eval/synthetic.py), as a CPU
# computes them (numpy 2.0.2, Python 3.12): the real solutions of the 20
# five-tuples, and for the twelve two-view sets the inliers, the RANSAC's
# iterations and the (t, R) errors in degrees.
HOST_POSE_SOLUTIONS = (6, 6, 4, 6, 4, 4, 4, 6, 6, 6, 6, 6, 4, 6, 6, 4, 6, 6,
                       4, 6)
HOST_POSE_SETS = (
    (300, 1, 0.0, 0.0), (240, 29, 0.0, 0.0), (180, 142, 0.0, 0.0),
    (201, 79, 2.3775628945230016, 0.5902411305244532),
    (144, 446, 2.192329432223076, 0.21798983879778636),
    (126, 875, 3.259742060369207, 1.7691958711421323),
    (115, 1000, 6.361736940517815, 1.9064613644298019),
    (89, 1000, 1.94532612392685, 0.9240292712466469),
    (75, 1000, 1.5335237054940793, 0.34530767266261087),
    (300, 1, 0.0, 0.0), (240, 29, 0.0, 0.0), (180, 142, 0.0, 0.0))
HOST_POSE_DEG = 1e-3     # as the CPU test holds errors to cv2's


def _host_pose_fixed_check():
    """The 5-point solver, the RANSAC and recover_pose on the card's host,
    on the CPU tests' sets: equal solution counts, the true E among the
    solutions (1e-8), equal inliers and iterations, errors within
    HOST_POSE_DEG of the CPU's; recover_pose on a noise-free set with 25
    points behind camera 0 keeps the 300 in front and the true R and t."""
    from geoformer_tpu_torch.eval import pose as ppose
    from geoformer_tpu_torch.eval.synthetic import five_tuples, pose_sets
    from geoformer_tpu_torch.geometry import five_point as fp

    t0 = time.perf_counter()
    counts, e_gap = [], 0.0
    for x1, x2, E_true in five_tuples(20, 20):
        E, valid = fp.essential_five_point(x1[None], x2[None])
        sols = E[0][valid[0]]
        counts.append(len(sols))
        e_gap = max(e_gap, min(min(np.abs(e - E_true).max(),
                                   np.abs(e + E_true).max()) for e in sols))
    got = []
    for uv0, uv1, K, T in pose_sets(0):
        iters = []
        t_err, R_err, inl = ppose.pose_error_for_pair(uv0, uv1, K, K, T,
                                                      iters=iters)
        got.append((int(inl.sum()), iters[0], t_err, R_err))
    # recover_pose: set 0 (no noise, no outliers) and 25 points behind
    uv0, uv1, K, T = pose_sets(0)[0]
    rng = np.random.default_rng(5)
    X = rng.uniform([-2, -2, -9], [2, 2, -4], (25, 3))
    R, t = T[:3, :3], T[:3, 3]
    b0 = X @ K.T
    b1 = (X @ R.T + t) @ K.T
    uv0 = np.r_[uv0, b0[:, :2] / b0[:, 2:]]
    uv1 = np.r_[uv1, b1[:, :2] / b1[:, 2:]]
    Kinv = np.linalg.inv(K)
    x1 = (np.c_[uv0, np.ones(len(uv0))] @ Kinv.T)[:, :2]
    x2 = (np.c_[uv1, np.ones(len(uv1))] @ Kinv.T)[:, :2]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    n, R_got, t_got, mask = fp.recover_pose(tx @ R, x1, x2, 1e9)
    r_gap = float(np.abs(R_got - R).max())
    t_gap = float(np.abs(t_got[:, 0] - t / np.linalg.norm(t)).max())
    ms = (time.perf_counter() - t0) * 1e3
    log("host_pose_check", solutions=counts, true_e_gap=f"{e_gap:.2e}",
        sets=[(g[0], g[1], round(g[2], 6), round(g[3], 6)) for g in got],
        recover_pose=dict(count=n, behind_kept=int(mask[300:].sum()),
                          r_gap=f"{r_gap:.2e}", t_gap=f"{t_gap:.2e}"),
        ms=f"{ms:.0f}", numpy=np.__version__)
    check(tuple(counts) == HOST_POSE_SOLUTIONS,
          f"5-point solution counts {counts}")
    check(e_gap < 1e-8, f"5-point: true E {e_gap} from the solutions")
    for i, (g, w) in enumerate(zip(got, HOST_POSE_SETS)):
        check(g[:2] == w[:2], f"host pose set {i}: inliers, iterations "
              f"{g[:2]}, on a CPU {w[:2]}")
        check(abs(g[2] - w[2]) <= HOST_POSE_DEG
              and abs(g[3] - w[3]) <= HOST_POSE_DEG,
              f"host pose set {i}: errors {g[2:]}, on a CPU {w[2:]}")
    check(n == 300 and not mask[300:].any() and r_gap < 1e-9
          and t_gap < 1e-9, f"recover_pose: {n} in front, R {r_gap}, "
          f"t {t_gap}")


def _depth_live_step(gk, device, state, batch):
    """One depth train step of the trained checkpoint on a val batch, where
    RANSAC finds homographies and the cross layers' gradients pass through
    K4/K5 (phase 5's live-GAM checks); then K3, K4 and K5 against their
    plain backwards at phase 4's bars on the forward inputs of its first
    self and cross layer in both directions, the 80x80 grid with its
    padded rows, and a fixed gradient."""
    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.eval import depth_gate as dg
    from geoformer_tpu_torch.train import depth_loop

    step_fn = depth_loop.make_depth_train_step(TrainConfig(
        batch_size=dg.BATCH, image_hw=(dg.IMSIZE, dg.IMSIZE)))
    geo = []
    hook = state.model.geo_module.register_forward_hook(
        lambda mod, inp, out: geo.append(out[2]))
    gk.reset_launch_counts()
    with _keep_inputs(gk, "box_window_attention_fwd",
                      "masked_kv_attention_fwd") as kept:
        t0 = time.perf_counter()
        live = step_fn(state, batch, 1e-5,
                       generator=torch.Generator(device).manual_seed(5))
        torch.cuda.synchronize()
        live_ms = (time.perf_counter() - t0) * 1e3
    hook.remove()
    launches = dict(gk.LAUNCHES)
    cross = state.model.geo_module.layer_1
    cross_grad = {n_: getattr(cross, n_).weight.grad.norm().item()
                  for n_ in ("q_proj", "k_proj", "v_proj")}
    has_h = geo[0].has_H.tolist()
    log("depth_live_gam", checkpoint="tpu_r5_depth2", step_ms=f"{live_ms:.1f}",
        has_H=has_h, num_inliers=geo[0].num_inliers.tolist(),
        num_matches=float(live["num_matches"]), loss=float(live["loss"]),
        grad_norm=float(live["grad_norm"]), launches=launches,
        cross_layer_grad_norms={k: f"{x:.3e}" for k, x in cross_grad.items()})
    check(any(has_h), "the depth train step found no homography")
    check(all(math.isfinite(float(live[k])) for k in ("loss", "grad_norm")),
          "non-finite depth train step on the trained checkpoint")
    check(all(x > 0 for x in cross_grad.values()),
          "the cross layers got no gradient through K4/K5 on the depth path")
    for name, count in launches.items():
        want = PER_TRAIN_STEP.get(name, 0)
        check(count == want, f"{name} launched {count} times in the depth "
              f"train step on the trained checkpoint, expected {want}")

    gen = torch.Generator(device).manual_seed(14)
    for i in range(2):
        q, k, v, mask = (x.detach() for x in
                         kept["masked_kv_attention_fwd"][i][:4])
        g = torch.randn(q.shape, generator=gen, device=device)
        _mka_bwd_case(gk, q, k, v, mask, g,
                      f"depth train step, self layer 0, call {i}")
        q, k, v, centers = (x.detach() for x in
                            kept["box_window_attention_fwd"][i][:4])
        grid = tuple(kept["box_window_attention_fwd"][i][4])
        g = torch.randn(q.shape, generator=gen, device=device)
        what = f"depth train step, cross layer 0, call {i}"
        _box_dkv_case(gk, q, k, v, g, centers, what, grid, library=i == 0)
        _box_dq_case(gk, q, k, v, g, centers, what, grid, library=i == 0)


# ------------------------------------------------------------ phase 13 -----

# The standing localization and ATE gates (eval/localize_protocol.py,
# eval/ate_protocol.py) at their full size: the 3-plane scene of 8 db and
# 4 query images at 480x640 (with the db scans for the dense mode), and 12
# frames of 480x640 with loop stride 5, all from seed 20260819.
LOC_PHASE = dict(seed=20260819, n_db=8, n_query=4)
ATE_PHASE = dict(seed=20260819, frames=12, loop_stride=5, hw=(480, 640))
# card against the host's CPU on the same inputs and draws: the f32 PnP
# and SL(3) bars of tests/test_torch_port_{sfm_localize,slam}.py (two
# BLAS/LAPACK stacks in f32: the DLT refit's normal matrix is
# ill-conditioned, the graph's 8 squarings compound the rounding)
PNP_BAR = dict(rot_deg=0.1, centre_m=0.02, inliers=2)
GRAPH_BAR_PX = 1e-2


def _synced(fn, *args, **kwargs):
    """(fn's result, its ms up to a synchronize, the host synchronisations
    torch's sync debug mode reported within it, their count by the source
    line that made them)."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ms = (time.perf_counter() - t0) * 1e3
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return out, ms, sum(where.values()), where


def _pose_gap(Ta, Tb):
    """(rotation angle in degrees, camera-centre distance) of two
    world->cam 4x4 poses; the angle from |Ra - Rb|_F, exact when small."""
    Ra, Rb = Ta[:3, :3], Tb[:3, :3]
    ang = math.degrees(2 * math.asin(min(1.0, float(
        np.linalg.norm(Ra - Rb)) / (2 * math.sqrt(2)))))
    return ang, float(np.linalg.norm(Ra.T @ Ta[:3, 3] - Rb.T @ Tb[:3, 3]))


def _phase13_gates(tmp, device):
    """The three protocol commands, each in its own process and all at
    once: `cli slam` on the ATE sequence and `cli localize` on the scene in
    the SfM and the dense mode (bf16, K1 and K2). Returns the records, the
    sequence's directory and the scene's."""
    import concurrent.futures

    from geoformer_tpu_torch.eval import ate_protocol as ap
    from geoformer_tpu_torch.eval import localize_protocol as lp

    seq, scene = tmp / "seq", tmp / "scene"
    t0 = time.perf_counter()
    ap.build_sequence(str(seq), ATE_PHASE["frames"], ATE_PHASE["hw"],
                      ATE_PHASE["seed"])
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cams = lp.build_scene(str(scene / "sfm"), LOC_PHASE["seed"],
                          LOC_PHASE["n_db"], LOC_PHASE["n_query"],
                          scans=True)
    scene_s = time.perf_counter() - t0
    # the dense mode on the same scene, with its own output directory
    (scene / "dense").mkdir()
    for name in ("images", "scans", "queries.txt", "query_pairs.txt"):
        (scene / "dense" / name).symlink_to(scene / "sfm" / name)
    cmds = {
        "slam": ap.slam_command(str(seq), str(CKPT), max(ATE_PHASE["hw"]),
                                ATE_PHASE["loop_stride"], str(device),
                                bf16=True, pallas=True),
        "localize_sfm": lp.localize_command(str(scene / "sfm"), str(CKPT),
                                            str(device), True, True),
        "localize_dense": lp.localize_command(str(scene / "dense"),
                                              str(CKPT), str(device), True,
                                              True, scans=True)}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        runs = dict(zip(cmds, pool.map(lambda c: subprocess.run(
            c, cwd=REPO, capture_output=True, text=True, timeout=600),
            cmds.values())))
    wall = time.perf_counter() - t0
    logs = {name: r.stdout + r.stderr for name, r in runs.items()}
    for name, r in runs.items():
        check(r.returncode == 0, f"{name} failed ({r.returncode}):\n"
              f"{logs[name][-3000:]}")
    slam = [json.loads(ln) for ln in runs["slam"].stdout.splitlines()
            if ln.startswith("{")][-1]
    recs = {"ate": ap.record(slam, ATE_PHASE["seed"], ATE_PHASE["frames"],
                             ATE_PHASE["loop_stride"])}
    for mode in ("sfm", "dense"):
        with contextlib.redirect_stdout(sys.stderr):
            recs[mode] = lp.score(str(scene / mode / "run" / "poses.txt"),
                                  cams["query"], LOC_PHASE["seed"],
                                  LOC_PHASE["n_db"], scans=mode == "dense")
    log("localize_slam_build", ate_sequence_s=f"{seq_s:.1f}",
        scene_s=f"{scene_s:.1f}", textures=_texture_source(),
        processes_wall_s=f"{wall:.1f}")
    return recs, seq, scene / "sfm"


def _texture_source() -> str:
    """Which build made the procedural textures: the port's g++ build of
    cpp/synthgen.cpp, or its numpy fallback where g++ is missing."""
    from geoformer_tpu_torch.data import native

    try:
        native.load_library()
        return "cpp/synthgen.cpp (g++)"
    except native.NoCompiler:
        return "numpy fallback (no g++)"


def phase_localize_slam(device):
    """The localization and planar-SLAM paths on the card, when the trained
    checkpoint is there: the standing ATE and localization gates through
    `cli slam` and `cli localize` (SfM and dense) in their own processes,
    each beside the JAX record and the port's CPU run; then both paths in
    this process with K1/K2 counted a forward and held against their plain
    versions on this path's inputs, the ms by part and the host syncs, and
    the card's PnP and SL(3) graph solves against the same calls on the
    host's CPU with the same draws."""
    import shutil
    import sqlite3
    import tempfile

    from geoformer_tpu_torch import cli
    from geoformer_tpu_torch.engine import pnp, slam
    from geoformer_tpu_torch.eval import ate_protocol as ap
    from geoformer_tpu_torch.eval import localize_driver as ld
    from geoformer_tpu_torch.eval import localize_protocol as lp
    from geoformer_tpu_torch.eval import sfm_localize as sl
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray
    from geoformer_tpu_torch.geometry.homography import corner_error
    from geoformer_tpu_torch.geometry.ransac import gumbel_sample_idx
    from geoformer_tpu_torch.ops import gam_kernels as gk

    if not CKPT.is_file():
        print(f"[localize_slam] absent path={CKPT}", flush=True)
        return
    log("localize_slam", sqlite3=sqlite3.sqlite_version)
    tmp = Path(tempfile.mkdtemp(prefix="loc_slam_smoke_"))
    try:
        recs, seq, scene = _phase13_gates(tmp, device)
        for name, rec, ref, jax_rec in (
                ("ate", recs["ate"], ap.CPU_REF, ap.JAX_RECORD),
                ("localize_sfm", recs["sfm"], lp.CPU_REF["sfm"],
                 lp.JAX_RECORD),
                ("localize_dense", recs["dense"], lp.CPU_REF["dense"],
                 None)):
            log("localize_slam_gate", gate=name, record=json.dumps(rec),
                cpu_reference=json.dumps(ref),
                jax_record=json.dumps(jax_rec))
        check(recs["ate"]["pass"], f"ATE gate: optimized drift "
              f"{recs['ate']['corner_drift_optimized_px']} px > "
              f"{ap.REGRESSION_GATE_PX}")
        for mode in ("sfm", "dense"):
            check(lp.passed(recs[mode]), f"localization gate ({mode}): "
                  f"recall@5m,10deg {recs[mode]['recall@5m,10deg']}")

        # both paths in this process, instrumented
        args = cli.build_parser().parse_args(
            ["slam", "--images", str(seq), "--ckpt", str(CKPT), "--bf16",
             "--pallas", "--device", str(device)])
        cfg, model = cli._model(args)
        matcher = BatchedMatcher(cfg, model, batch_size=1, device=device)
        parts = {"decode": [], "forward": []}

        def decode(path, imsize):
            t0 = time.perf_counter()
            out = load_gray(path, imsize)
            parts["decode"].append((time.perf_counter() - t0) * 1e3)
            return out

        def forward(a, b):
            t0 = time.perf_counter()
            (mk0, mk1, _), = matcher.match_batch([a], [b])
            parts["forward"].append((time.perf_counter() - t0) * 1e3)
            return mk0, mk1

        frames = [decode(str(p), 640)[0]
                  for p in sorted(seq.glob("frame_*.png"))]
        fits, graphs = [], []
        real_fit, real_graph = slam.fit_homography_np, \
            slam.optimize_homography_graph

        def fit(*a, **kw):
            out, ms, syncs, _ = _synced(real_fit, *a, **kw)
            fits.append((ms, syncs))
            return out

        def graph(g, **kw):
            out, ms, syncs, where = _synced(real_graph, g, **kw)
            graphs.append((g, kw, out[0], ms, syncs, where))
            return out

        slam.fit_homography_np, slam.optimize_homography_graph = fit, graph
        gk.reset_launch_counts()
        try:
            with _count_forwards() as fw:
                res = slam.run_planar_slam(
                    frames, lambda i, j: forward(frames[i], frames[j]),
                    loop_stride=ATE_PHASE["loop_stride"], device=device,
                    log=lambda *a: None)
        finally:
            slam.fit_homography_np, slam.optimize_homography_graph = \
                real_fit, real_graph
        slam_launches = dict(gk.LAUNCHES)
        _forward_launches(slam_launches, len(fw), "slam")
        hw = frames[0].shape
        drift = slam.trajectory_drift(res["H_traj"], np.load(
            seq / "gt.npz")["H"], hw)
        g, kw, H_card, graph_ms, graph_syncs, graph_where = graphs[0]
        # the same solve again, warm
        _, graph_ms2, _, _ = _synced(real_graph, g, **kw)
        cpu_graph = type(g)(*(x.cpu() for x in g))
        H_cpu = real_graph(cpu_graph, **kw)[0]
        gap_px = float(corner_error(H_card.cpu(), H_cpu, hw).max())
        log("localize_slam_ate", frames=len(frames), forwards=len(fw),
            launches=slam_launches, edges_ok=sum(e["ok"]
                                                 for e in res["edges"]),
            drift_px=f"{drift:.3f}",
            subprocess_drift_px=recs["ate"]["corner_drift_optimized_px"],
            decode_ms_per_frame=f"{np.median(parts['decode']):.1f}",
            forward_ms_first=f"{parts['forward'][0]:.1f}",
            forward_ms_median=f"{np.median(parts['forward']):.1f}",
            fit_ms_median=f"{np.median([f[0] for f in fits]):.1f}",
            fit_host_syncs=sorted({f[1] for f in fits}),
            graph_solve_ms=f"{graph_ms:.1f}",
            graph_solve_ms_again=f"{graph_ms2:.1f}",
            graph_host_syncs=graph_syncs,
            graph_syncs_by_line=dict(graph_where.most_common(8)),
            graph_edges=int(g.edge_i.numel()),
            graph_card_vs_cpu_corner_px=f"{gap_px:.2e}",
            graph_bar_px=GRAPH_BAR_PX)
        check(gap_px <= GRAPH_BAR_PX, f"SL(3) graph: card vs CPU "
              f"{gap_px} px > {GRAPH_BAR_PX}")

        # the localization driver (SfM mode) in this process
        parts["decode"].clear()
        parts["forward"].clear()
        images = scene / "images"

        def match_pairs_fn(n0, n1):
            im0, sc0 = decode(str(images / n0), 480)
            im1, sc1 = decode(str(images / n1), 480)
            mk0, mk1 = forward(im0, im1)
            return np.concatenate([mk0 * np.array(sc0),
                                   mk1 * np.array(sc1)], axis=1)

        pnp_calls = []
        real_pose = sl.pnp_pose

        def pose(*a, **kw):
            out, ms, syncs, where = _synced(real_pose, *a, **kw)
            pnp_calls.append((a, ms, syncs, where))
            return out

        sl.pnp_pose = pose
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with _count_forwards() as fw, \
                    contextlib.redirect_stdout(sys.stderr):
                poses = ld.run_localization(
                    str(scene / "model.nvm"), str(scene / "db.db"),
                    str(tmp / "inproc"), match_pairs_fn,
                    sl.parse_queries_with_intrinsics(
                        str(scene / "queries.txt")),
                    ld.load_pairs_txt(str(scene / "query_pairs.txt")),
                    covis_topk=3, device=device)
        finally:
            sl.pnp_pose = real_pose
        loc_s = time.perf_counter() - t0
        loc_launches = dict(gk.LAUNCHES)
        _forward_launches(loc_launches, len(fw), "localize")
        # each query's PnP on the card and on the CPU, the same samples
        gaps = []
        for (uvs, xyzs, K, capacity, thr, *_), *_ in pnp_calls:
            n = min(len(uvs), capacity)
            uv = np.zeros((capacity, 2), np.float32)
            xyz = np.zeros((capacity, 3), np.float32)
            uv[:n], xyz[:n] = np.asarray(uvs)[:n], np.asarray(xyzs)[:n]
            valid = torch.arange(capacity) < n
            idx = gumbel_sample_idx(valid[None], 256,
                                    torch.Generator().manual_seed(7), k=6)[0]
            outs = [pnp.pnp_ransac(
                torch.from_numpy(xyz).to(d), torch.from_numpy(uv).to(d),
                torch.tensor(K, dtype=torch.float32, device=d),
                valid.to(d), thr_px=thr, sample_idx=idx.to(d))
                for d in (device, torch.device("cpu"))]
            a, b = ({k: v.cpu().numpy() for k, v in o.items()} for o in outs)
            ang, dc = _pose_gap(a["T"].astype(np.float64),
                                b["T"].astype(np.float64))
            gaps.append((bool(a["ok"]), bool(b["ok"]),
                         int(a["num_inliers"]), int(b["num_inliers"]),
                         ang, dc))
        log("localize_slam_localize", queries=len(poses), forwards=len(fw),
            launches=loc_launches, wall_s=f"{loc_s:.1f}",
            ok=[p["ok"] for p in poses.values()],
            inliers=[p["num_inliers"] for p in poses.values()],
            decode_ms_per_image=f"{np.median(parts['decode']):.1f}",
            forward_ms_median=f"{np.median(parts['forward']):.1f}",
            pnp_ms_per_query=[f"{c[1]:.1f}" for c in pnp_calls],
            pnp_host_syncs_per_query=[c[2] for c in pnp_calls],
            pnp_syncs_by_line=dict(pnp_calls[0][3].most_common(8)),
            pnp_card_vs_cpu=[f"ok {g[0]}/{g[1]} inl {g[2]}/{g[3]} "
                             f"{g[4]:.4f}deg {g[5]:.4f}m" for g in gaps],
            pnp_bar=PNP_BAR)
        for g in gaps:
            check(g[0] == g[1] and abs(g[2] - g[3]) <= PNP_BAR["inliers"]
                  and g[4] <= PNP_BAR["rot_deg"]
                  and g[5] <= PNP_BAR["centre_m"],
                  f"PnP card vs CPU off the bar {PNP_BAR}: {g}")
        check(all(p["ok"] for p in poses.values()),
              "a query was not localized in process")

        # K1 and K2 on one forward of this path: 4 launches each, and each
        # against its plain version on that forward's inputs
        q0, d0 = next(iter(ld.load_pairs_txt(str(scene / "query_pairs.txt"))))
        im0, _ = load_gray(str(images / q0), 480)
        im1, _ = load_gray(str(images / d0), 480)
        gk.reset_launch_counts()
        with _keep_inputs(gk, "box_window_attention_fwd",
                          "masked_kv_attention_fwd") as kept:
            matcher.match_batch([im0], [im1])
        _forward_launches(dict(gk.LAUNCHES), 1, "localization pair")
        q, k, v, centers, grid = kept["box_window_attention_fwd"][0][:5]
        _k1_vs_plain(gk, q, k, v, centers, grid, "localize_slam_kernels",
                     inputs=f"{q0}-{d0} cross layer 0")
        q, k, v, mask = kept["masked_kv_attention_fwd"][0][:4]
        _mka_fwd_case(gk, q, k, v, mask, f"{q0}-{d0} self layer 0")
        del kept, matcher, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 14 -----

# The eval-only int8 paths (--int8: int8 backbone; --int8-full: int8
# everywhere) and the forward's alternates (sinkhorn matcher, the (16, 4)
# ladder, plain LoFTR). The int8 self-check's AUC@1/3/5/10 references:
# the port's own eval/selfcheck.py (--bf16 --pallas --device cpu, 40
# procedural pairs of 480x640, GAM and fit seed 0) on the CPU of the
# card's machine (PERF.md §6). The card draws the GAM's and the fit's
# samples from other streams, so the bars are phase 8's, the wider of its
# f32 and bf16 bars at each threshold (one pair of 40 moves an AUC by up
# to 0.025).
SELFCHECK_INT8_REF = {
    "int8": (0.6291, 0.852, 0.9012, 0.9381),
    "int8_full": (0.6307, 0.85, 0.9122, 0.9561),
}
SELFCHECK_INT8_TOL = tuple(max(a, b) for a, b in zip(
    SELFCHECK_TOL["float32"], SELFCHECK_TOL["bfloat16"]))
# JAX on a TPU v5e (RESULTS.md:384-395): accuracy context only, no bar.
SELFCHECK_INT8_TPU = {"int8_full": (0.437, 0.692, 0.795, 0.873)}
# An int8 forward through the kernels against the same forward through
# their plain versions: the kernels' f32 sums in another order can move a
# value across a rounding boundary of its quantum, and the layers after it
# carry that (tests/test_torch_port_int8_model.py's bars).
INT8_PARITY = dict(overlap=0.9, kp_same=0.8, kp_window_px=8.0, gam=0.25)
INT8_MODES = ("int8", "int8_full")


def _int8_config(cfg, mode):
    from geoformer_tpu_torch.config import with_int8

    return with_int8(cfg, int8=True, int8_full=mode == "int8_full")


def _record_int8_shapes(model):
    """Forward hooks that count each distinct int8 product of ``model``:
    ("conv", input shape, weight shape, stride, padding) or ("dense",
    (rows, K), weight shape). Returns (counts, hooks)."""
    from geoformer_tpu_torch.models.layers import Int8Conv, Int8Dense

    counts = {}

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, Int8Conv):
            key = ("conv", tuple(x.shape), tuple(mod.weight.shape),
                   mod.stride, mod.padding)
        else:
            key = ("dense", (x.numel() // x.shape[-1], x.shape[-1]),
                   tuple(mod.weight.shape))
        counts[key] = counts.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Int8Conv, Int8Dense))]
    return counts, hooks


def _int8_products(device, shapes):
    """At each distinct int8 product shape of the forward: the card's int32
    accumulation (torch._int_mm on im2col rows) against the exact integer
    product (f64 on the card: |sum| < 2^53), bit for bit, and the int8
    call's ms (quantize, product, dequantize) beside the bf16 cuDNN /
    cuBLAS call's on the same shapes."""
    import torch.nn.functional as F

    from geoformer_tpu_torch.ops import quantize as qz

    gen = torch.Generator().manual_seed(16)
    totals = {"int8_ms": 0.0, "bf16_ms": 0.0}
    for key, calls in sorted(shapes.items(), key=str):
        kind, xs, ws = key[:3]
        x = torch.randn(xs, generator=gen).to(device, torch.bfloat16)
        w = (torch.randn(ws, generator=gen) * 0.05).to(device)
        xq, _ = qz.quantize_symmetric(x)
        if kind == "conv":
            stride, pad = key[3:]
            wq, _ = qz.quantize_symmetric(w, dims=(1, 2, 3))
            got = qz.conv_int32(xq, wq, stride, pad)
            exact = F.conv2d(xq.double(), wq.double(), stride=stride,
                             padding=pad).permute(0, 2, 3, 1)
            wb = w.to(torch.bfloat16)
            int8_ms = time_ms(lambda: qz.int8_conv(x, w, stride, pad), 10)
            bf16_ms = time_ms(lambda: F.conv2d(x, wb, stride=stride,
                                               padding=pad), 10)
        else:
            wq, _ = qz.quantize_symmetric(w, dims=(1,))
            got = qz.int_mm(xq, wq.t())
            exact = xq.double() @ wq.double().t()
            wb = w.to(torch.bfloat16)
            int8_ms = time_ms(lambda: qz.int8_dense(x, w), 10)
            bf16_ms = time_ms(lambda: F.linear(x, wb), 10)
        equal = bool(torch.equal(got.double(), exact))
        del exact, got
        totals["int8_ms"] += calls * int8_ms
        totals["bf16_ms"] += calls * bf16_ms
        log("int8_products", kind=kind, x=xs, w=ws,
            **({"stride": key[3], "pad": key[4]} if kind == "conv" else {}),
            calls_per_forward=calls, int32_equal_exact=equal,
            int8_ms=f"{int8_ms:.4f}", bf16_ms=f"{bf16_ms:.4f}")
        check(equal, f"int8 {kind} {xs}x{ws}: the int32 accumulation is "
              "not the exact product")
    torch.cuda.empty_cache()
    log("int8_products", shapes=len(shapes),
        int8_ms_per_forward=f"{totals['int8_ms']:.3f}",
        bf16_ms_per_forward=f"{totals['bf16_ms']:.3f}")


def _forward_requests(device, cfg, pairs, label, phase3_ms=None,
                      requests=2, live=True):
    """The BatchedMatcher at full width, B=2, random weights (seed 0): one
    warm-up request, ``requests`` timed ones, then one at coarse threshold
    LIVE_THR (the GAM on real inliers); K1 and K2 at 4 launches a forward.
    Returns the model."""
    import dataclasses

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk

    imgs0, imgs1 = [a for a, _ in pairs], [b for _, b in pairs]
    model = weights.random_init(GeoFormer(cfg), seed=0)
    matcher = BatchedMatcher(cfg, model, batch_size=MAIN_B, device=device)
    matcher.match_batch(imgs0, imgs1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(requests):
        res = matcher.match_batch(imgs0, imgs1, return_geo=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (requests * MAIN_B)
    launches = dict(gk.LAUNCHES)
    log(label, batch=MAIN_B, requests=requests, ms_per_pair=f"{ms:.3f}",
        phase3_bf16_ms_per_pair=(None if phase3_ms is None
                                 else f"{phase3_ms:.3f}"),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=launches)
    _check_outputs(res, MAIN_HW)
    per_fwd = _per_forward(cfg)
    for name, count in launches.items():
        want = per_fwd.get(name, 0) * requests
        check(count == want, f"{label}: {name} launched {count} times in "
              f"{requests} forwards, expected {want // requests} each")
    if live:
        live_cfg = cfg.replace(match=dataclasses.replace(cfg.match,
                                                         thr=LIVE_THR))
        live_model = GeoFormer(live_cfg)
        live_model.load_state_dict(model.state_dict())
        lm = BatchedMatcher(live_cfg, live_model, batch_size=MAIN_B,
                            device=device)
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        res = lm.match_batch(imgs0, imgs1, return_geo=True)
        torch.cuda.synchronize()
        has_h = [r[3]["has_H"] for r in res]
        launches = dict(gk.LAUNCHES)
        log(label + "_live_gam", coarse_thr=LIVE_THR,
            ms_per_pair=f"{(time.perf_counter() - t0) * 1e3 / MAIN_B:.3f}",
            has_H=has_h, num_inliers=[r[3]["num_inliers"] for r in res],
            valid_matches=[len(r[2]) for r in res], launches=launches)
        _check_outputs(res, MAIN_HW)
        check(any(has_h), f"{label}: the live-GAM request found no "
              "homography")
        for name, count in launches.items():
            want = per_fwd.get(name, 0)
            check(count == want, f"{label} live GAM: {name} launched "
                  f"{count} times, expected {want}")
        del lm, live_model
    return model


def _kernels_vs_plain(device, cfg, label, int8):
    """At SMALL_HW in f32, ``cfg``'s forward through K1/K2 against the
    same forward through their plain versions on this card, the same
    weights and RANSAC draws: the GAM's output features, then the final
    matches (phase 3's bars). An int8 model takes the trained checkpoint
    on two self-check pairs, when it is there, and INT8_PARITY's bars: a
    random model's matches at a low threshold hang on values that a
    quantum moves (on an H100 its int8 GAM features differed by ~0.1,
    within the bar, and a quarter of its matches changed)."""
    import dataclasses

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.eval import selfcheck as sc
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk

    if int8:
        if not CKPT.is_file():
            print(f"[{label}] absent path={CKPT}", flush=True)
            return
        cfg = cfg.replace(match=dataclasses.replace(cfg.match,
                                                    max_matches=256))
        model = sc.load_model(cfg, str(CKPT), device)
        base, warped = sc.make_pairs(2, SMALL_HW, SELFCHECK["seed"])[:2]
        pairs = list(zip(base, warped))
    else:
        cfg = cfg.replace(match=dataclasses.replace(cfg.match, thr=1e-4,
                                                    max_matches=256),
                          fine_match=dataclasses.replace(cfg.fine_match,
                                                         thr=1e-3))
        model = weights.random_init(GeoFormer(cfg), 1).to(device).eval()
        pairs = [textured_pair(SMALL_HW, 10 + s) for s in range(2)]
    i0, i1 = (torch.from_numpy(np.ascontiguousarray(np.stack(
        [p[j] for p in pairs])[..., None], np.float32)).to(device)
        for j in (0, 1))

    @torch.no_grad()
    def run(fn):
        gk.reset_launch_counts()
        out = fn(torch.Generator(device).manual_seed(3))
        torch.cuda.synchronize()
        return out, dict(gk.LAUNCHES)

    a, a_launch = run(lambda g: model(i0, i1, generator=g))
    with plain_kernels():
        b, b_launch = run(lambda g: model(i0, i1, generator=g))
    with torch.no_grad():
        cnn = model.backbone(torch.cat([i0, i1]))[0]

    def gam(g):
        return model.geo_module(cnn[:2], cnn[2:], a.matches1,
                                cfg.coarse_scale, generator=g)[:2]

    gam_k = run(gam)[0]
    with plain_kernels():
        gam_p = run(gam)[0]
    gam_err = max((x - y).abs().max().item() for x, y in zip(gam_k, gam_p))
    overlap, kp_max, kp_same = 1.0, 0.0, 1.0
    for j in range(2):
        def pairs_of(o):
            v = o.matches.valid[j].cpu().numpy()
            return set(zip(o.matches.i_ids[j].cpu().numpy()[v].tolist(),
                           o.matches.j_ids[j].cpu().numpy()[v].tolist()))
        pa, pb = pairs_of(a), pairs_of(b)
        overlap = min(overlap, len(pa & pb) / max(len(pa | pb), 1))
        sel = (a.fine.valid[j] & b.fine.valid[j]
               & (a.matches.i_ids[j] == b.matches.i_ids[j]))
        d = torch.maximum(
            (a.fine.mkpts0[j][sel] - b.fine.mkpts0[j][sel]).abs().amax(-1),
            (a.fine.mkpts1[j][sel] - b.fine.mkpts1[j][sel]).abs().amax(-1))
        check(d.numel() > 0, f"{label}: no common fine matches")
        kp_max = max(kp_max, d.max().item())
        kp_same = min(kp_same, (d < PARITY["kp_px"]).float().mean().item())
    gam_tol = INT8_PARITY["gam"] if int8 else GAM_TOL
    log(label, size=f"{SMALL_HW[0]}x{SMALL_HW[1]}", dtype="float32",
        matches=[int(x) for x in a.matches.valid.sum(1).tolist()],
        has_H=a.geo.has_H.tolist(), plain_has_H=b.geo.has_H.tolist(),
        gam_max_abs_err=f"{gam_err:.3e}", gam_tol=gam_tol,
        match_overlap=f"{overlap:.4f}", max_kp_px=f"{kp_max:.4f}",
        kp_within_0_05px=f"{kp_same:.4f}", kernel_launches=a_launch,
        plain_launches=b_launch)
    check(bool(a.geo.has_H.all()), f"{label}: no homography")
    check(all(a_launch[k] == n for k, n in _per_forward(cfg).items()),
          f"{label}: the kernel path did not launch K1 and K2 4 times "
          f"(and K6 twice on the streamed matcher)")
    check(all(v == 0 for v in b_launch.values()),
          f"{label}: the plain versions launched a kernel")
    check(gam_err <= gam_tol, f"{label}: GAM outputs differ by {gam_err}")
    check(overlap >= PARITY["overlap"], f"{label}: match overlap {overlap}")
    if int8:
        check(kp_same >= INT8_PARITY["kp_same"]
              and kp_max <= INT8_PARITY["kp_window_px"],
              f"{label}: keypoints {kp_same} within 0.05 px, max {kp_max}")
    else:
        check(kp_max < PARITY["kp_px"], f"{label}: a keypoint moved "
              f"{kp_max} px")


def _int8_selfcheck(device):
    """The trained self-check (40 procedural pairs of 480x640) with --int8
    and --int8-full in bf16 through K1/K2, each AUC held to the port's CPU
    reference (SELFCHECK_INT8_REF, SELFCHECK_INT8_TOL)."""
    from geoformer_tpu_torch.eval import selfcheck as sc
    from geoformer_tpu_torch.ops import gam_kernels as gk

    if not CKPT.is_file():
        print(f"[int8_selfcheck] absent path={CKPT}", flush=True)
        return
    base, warped, Hs = sc.make_pairs(SELFCHECK["pairs"], SELFCHECK["hw"],
                                     SELFCHECK["seed"])
    forwards = math.ceil(SELFCHECK["pairs"] / sc.BATCH)
    tol = SELFCHECK_INT8_TOL
    for mode in INT8_MODES:
        model = sc.load_model(sc.selfcheck_config(
            bf16=True, pallas=True, int8=True,
            int8_full=mode == "int8_full"), str(CKPT), device)
        gk.reset_launch_counts()
        res = sc.run_pairs(model, base, warped, Hs, SELFCHECK["ransac_thr"],
                           device)
        torch.cuda.synchronize()
        launches = dict(gk.LAUNCHES)
        rec = sc.summary(res)
        ref = SELFCHECK_INT8_REF[mode]
        delta = [round(a - b, 4) for a, b in zip(rec["auc@1/3/5/10"], ref)]
        log("int8_selfcheck", mode=mode, dtype="bfloat16",
            images="procedural", pairs=rec["pairs"],
            auc=rec["auc@1/3/5/10"], cpu_ref_auc=ref, delta=delta, tol=tol,
            jax_tpu_auc=SELFCHECK_INT8_TPU.get(mode),
            correct=rec["correct@1/3/5/10"],
            mean_matches=rec["mean_matches"], failed=rec["failed"],
            forward_ms_per_pair=f"{res['match_s'] * 1e3 / rec['pairs']:.2f}",
            fit_ms_per_pair=f"{res['fit_s'] * 1e3 / rec['pairs']:.2f}",
            launches=launches)
        _forward_launches(launches, forwards, f"int8 self-check {mode}")
        check(all(abs(d) <= t_ for d, t_ in zip(delta, tol)),
              f"int8 self-check {mode}: AUC {rec['auc@1/3/5/10']} against "
              f"the CPU reference {ref}")
        del model
    torch.cuda.empty_cache()


def _ladder_and_loftr(device):
    """ResNetFPN_16_4 (the bench widths with a fourth stage of 512) on the
    4 images of a B=2 request and plain LoFTR (f32, as the JAX model) on
    B=2 pairs, 480x640, random weights: ms and output shapes."""
    import dataclasses

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import BackboneConfig, bench_config
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models.backbone import build_backbone
    from geoformer_tpu_torch.models.loftr import LoFTR

    pairs = [textured_pair(MAIN_HW, seed) for seed in range(MAIN_B)]
    i0, i1 = (torch.from_numpy(np.stack([p[j] for p in pairs])[..., None])
              .to(device) for j in (0, 1))
    x = torch.cat([i0, i1])
    for dtype in (torch.bfloat16, torch.float32):
        bb = weights.random_init(build_backbone(BackboneConfig(
            block_dims=(128, 196, 256, 512), resolution=(16, 4)),
            dtype=dtype), 0).to(device).eval()
        with torch.no_grad():
            c, f = bb(x)
            ms = time_ms(lambda: bb(x), 5)
        log("ladder_16_4", dtype=str(dtype), images=tuple(x.shape),
            coarse=tuple(c.shape), fine=tuple(f.shape), ms=f"{ms:.3f}")
        check(c.shape == (4, 30, 40, 512) and f.shape == (4, 120, 160, 196)
              and bool(torch.isfinite(c).all()), "the (16, 4) ladder's "
              "outputs")
        del bb, c, f
    base = bench_config(use_bf16=False)
    cfg = base.replace(match=dataclasses.replace(base.match, thr=LIVE_THR))
    model = weights.random_init(LoFTR(cfg), 0).to(device).eval()
    with torch.no_grad():
        out = model(i0, i1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: model(i0, i1), 3, warmup=1)
    log("loftr", dtype="float32", batch=MAIN_B, conf=tuple(out.conf.shape),
        valid=out.valid.sum(1).tolist(), ms_per_pair=f"{ms / MAIN_B:.3f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    check(bool(torch.isfinite(out.mkpts1).all())
          and bool(torch.isfinite(out.expec_f).all()), "LoFTR's outputs")
    del model, out
    torch.cuda.empty_cache()


def phase_int8_alternates(device, phase3_ms):
    """(a) the int8 products at every distinct shape of the --int8-full
    bench forward against the exact product; (b) the --int8 and
    --int8-full forwards at full width with K1/K2 4 times each; (c) the
    trained int8 self-checks; (d) the sinkhorn forward at full width and,
    small in f32, sinkhorn and --int8-full through K1/K2 against their
    plain versions; (e) the (16, 4) ladder and plain LoFTR, timed."""
    import dataclasses

    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.eval.synthetic import textured_pair

    from geoformer_tpu_torch.eval.matcher import BatchedMatcher

    pairs = [textured_pair(MAIN_HW, seed) for seed in range(MAIN_B)]
    bench = bench_config(use_bf16=True)
    shapes = {}
    for mode in INT8_MODES:
        cfg = _int8_config(bench, mode)
        model = _forward_requests(device, cfg, pairs, f"{mode}_forward",
                                  phase3_ms)
        if mode == "int8_full":
            # one more request, counting the int8 products by shape
            shapes, hooks = _record_int8_shapes(model)
            BatchedMatcher(cfg, model, batch_size=MAIN_B,
                           device=device).match_batch(
                [a for a, _ in pairs], [b for _, b in pairs])
            for h in hooks:
                h.remove()
        del model
        torch.cuda.empty_cache()
    _int8_products(device, shapes)
    _int8_selfcheck(device)
    sink = bench.replace(match=dataclasses.replace(bench.match,
                                                   match_type="sinkhorn"))
    _forward_requests(device, sink, pairs, "sinkhorn_forward", phase3_ms,
                      requests=1, live=False)
    torch.cuda.empty_cache()
    small = bench_config(use_bf16=False)
    _kernels_vs_plain(device, small.replace(match=dataclasses.replace(
        small.match, match_type="sinkhorn")), "sinkhorn_parity", False)
    _kernels_vs_plain(device, _int8_config(small, "int8_full"),
                      "int8_full_parity", True)
    _ladder_and_loftr(device)
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 15 ------

# (a): the headline recipe at a global batch of 4, two ranks of 2 on the
# one card over gloo, against one process at batch 4; warm-up 1 step, so
# that step 2 moves the weights at the recipe's full LR (step 1's LR is 0)
DP = dict(world=2, batch=4, steps=2, seed=TRAIN_SEED, bank=8, warmup=1)
DP_SCALAR_REL = 1e-3          # loss and grad_norm of each step
DP_UPDATE = dict(rel_l2=0.1, off_share=0.01)   # tests/test_torch_port_train_step.py
DP_STATS = dict(rtol=1e-4, atol=1e-5)          # BatchNorm running statistics
# (b): cli train under torchrun, one rank, NCCL
DP_CLI = dict(hw=(120, 160), batch=2, steps=2, bank=4)
# (c): the engine; the BA scene of tests/test_engine.py
BA_SCENE = dict(C=6, P=80, seed=1)
BA_ITERS = 10
SHARDED_SCENE = dict(C=4, P=64, seed=5)
SHARDED_ITERS = 8


def _dp_kwargs(ckpt_dir, model_cfg, image_hw) -> dict:
    return dict(steps=DP["steps"], batch_size=DP["batch"],
                image_hw=image_hw, ckpt_dir=str(ckpt_dir), log_every=1,
                seed=DP["seed"], model_cfg=model_cfg, bank_size=DP["bank"],
                warmup_steps=DP["warmup"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _dp_run(kw, device) -> dict:
    """run_training on ``device`` in this process's group (if any): each
    train step's synchronized ms and launches, the gradient all-reduce's
    synchronized ms, the count of all-reduces, the peak memory (on the
    card), what it printed and the state after it (host arrays)."""
    import io

    import torch.distributed as dist

    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train import loop as loop_mod

    ar = {"ms": [], "calls": 0}
    flat, all_reduce = mesh.all_sum_flat, dist.all_reduce

    def timed_flat(tensors):
        _sync(device)
        t0 = time.perf_counter()
        out = flat(tensors)
        _sync(device)
        ar["ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def counted(*args, **kwargs):
        ar["calls"] += 1
        return all_reduce(*args, **kwargs)

    mesh.all_sum_flat, dist.all_reduce = timed_flat, counted
    gk.reset_launch_counts()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    try:
        with _instrumented(loop_mod, gk) as rec, \
                contextlib.redirect_stdout(buf):
            state = loop_mod.run_training(**kw, device=device)
        _sync(device)
    finally:
        mesh.all_sum_flat, dist.all_reduce = flat, all_reduce
    return dict(steps=rec["train"], all_reduce_ms=ar["ms"],
                all_reduce_calls=ar["calls"], printed=buf.getvalue(),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30
                if cuda else 0.0,
                state={k: v.cpu().numpy() for k, v in
                       state.model.state_dict().items()})


def _dp_rank(rank, kw, device, hosts):
    """Phase 15 on one rank (both ranks on ``device``), TF32 off: (a)'s
    training run, then (c)'s two sharded BA solves of ``hosts`` (one group
    for both saves the ranks' second start-up)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    out = _dp_run(kw, device)
    out["sharded"] = _sharded_solves(hosts, device)
    return out


def _update_gap(got: dict, ref: dict, before: dict, lr: float):
    """The largest relative L2 gap between two runs' updates of a
    parameter tensor, and the largest share of its elements whose updates
    differ by more than lr / 10; the BatchNorm statistics' largest gap
    beyond DP_STATS (0 when within)."""
    rel, off, stats = 0.0, 0.0, 0.0
    for name, r in ref.items():
        g, b = got[name], before[name]
        if "running" in name:
            excess = np.abs(g - r) - (DP_STATS["atol"]
                                      + DP_STATS["rtol"] * np.abs(r))
            stats = max(stats, float(excess.max()))
            continue
        d_ref, d_got = r - b, g - b
        if np.linalg.norm(d_ref) == 0:
            continue
        rel = max(rel, float(np.linalg.norm(d_got - d_ref)
                             / np.linalg.norm(d_ref)))
        off = max(off, float((np.abs(d_got - d_ref) > lr / 10).mean()))
    return rel, off, max(stats, 0.0)


def _dp_two_ranks(device, tmp, model_cfg, image_hw, hosts):
    """(a): two gloo ranks on the one card against one process; returns
    the ranks' sharded BA solutions of ``hosts`` and the group's
    seconds."""
    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk

    before = {k: v.numpy() for k, v in weights.random_init(
        GeoFormer(model_cfg), DP["seed"]).state_dict().items()}
    one = _dp_run(_dp_kwargs(tmp / "one", model_cfg, image_hw), device)
    ref_lines = [json.loads(ln) for ln in
                 (tmp / "one" / "metrics.jsonl").read_text().splitlines()]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.launch(_dp_rank, DP["world"], (
        _dp_kwargs(tmp / "two", model_cfg, image_hw), str(device), hosts),
        backend="gloo", timeout=900, threads=4, init_dir=str(tmp))
    launch_s = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in
             (tmp / "two" / "metrics.jsonl").read_text().splitlines()]
    train_k = PER_TRAIN_STEP
    for r, res in enumerate(ranks):
        _per_call_launches(res["steps"], f"rank {r} train", train_k,
                           DP["steps"])
    check(ranks[1]["printed"] == "", "rank 1 printed: rank 0 alone logs")
    check([m["step"] for m in lines] == [1, 2], f"metrics steps {lines}")
    gaps = {}
    for m, ref in zip(lines, ref_lines):
        for k in ("loss", "grad_norm"):
            gaps[f"{k}@{m['step']}"] = abs(m[k] - ref[k]) / abs(ref[k])
    rel, off, stats = _update_gap(ranks[0]["state"], one["state"], before,
                                  lines[-1]["lr"])
    same = all(np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k])
               for k in ranks[0]["state"])
    ms = [[round(t, 1) for t, _ in res["steps"]] for res in ranks]
    log("data_parallel_ranks", world=DP["world"], backend="gloo",
        global_batch=DP["batch"], hw=image_hw, launch_s=f"{launch_s:.1f}",
        ms_per_step_rank=ms,
        one_process_ms_per_step=[round(t, 1) for t, _ in one["steps"]],
        all_reduce_ms=[[round(t, 2) for t in res["all_reduce_ms"]]
                       for res in ranks],
        all_reduces_per_step=[res["all_reduce_calls"] // DP["steps"]
                              for res in ranks],
        peak_gib_rank=[round(res["peak_gib"], 2) for res in ranks],
        one_process_peak_gib=f"{one['peak_gib']:.2f}",
        loss=[m["loss"] for m in lines],
        one_process_loss=[m["loss"] for m in ref_lines],
        grad_norm=[m["grad_norm"] for m in lines],
        one_process_grad_norm=[m["grad_norm"] for m in ref_lines],
        num_inliers=[m["num_inliers"] for m in lines],
        one_process_num_inliers=[m["num_inliers"] for m in ref_lines],
        scalar_rel_gap={k: f"{v:.2e}" for k, v in gaps.items()},
        update_rel_l2=f"{rel:.3e}", update_off_share=f"{off:.4f}",
        batch_stats_excess=f"{stats:.2e}", ranks_equal=same,
        launches_per_step_rank=[res["steps"][0][1] for res in ranks])
    check(all(v <= DP_SCALAR_REL for v in gaps.values()),
          f"two ranks' loss/grad_norm against one process: {gaps}")
    check(rel < DP_UPDATE["rel_l2"] and off < DP_UPDATE["off_share"],
          f"two ranks' update against one process: rel L2 {rel}, "
          f"off share {off}")
    check(stats == 0.0, f"BatchNorm statistics off by {stats} beyond "
          f"{DP_STATS}")
    check(same, "the two ranks' states differ")
    return [res["sharded"] for res in ranks], launch_s


def _dp_torchrun(device, tmp):
    """(b): cli train under torchrun, one rank on the card, NCCL (gloo for
    the CPU)."""
    out = tmp / "torchrun"
    h, w = DP_CLI["hw"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "geoformer_tpu_torch.cli", "train",
         "--pallas", "--steps", str(DP_CLI["steps"]), "--batch",
         str(DP_CLI["batch"]), "--height", str(h), "--width", str(w),
         "--bank-size", str(DP_CLI["bank"]), "--log-every", "1", "--out",
         str(out), "--device", device.type],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "NCCL_DEBUG": "VERSION"})
    seconds = time.perf_counter() - t0
    text = run.stdout + run.stderr
    nccl = [ln.strip() for ln in text.splitlines() if "NCCL version" in ln]
    check(run.returncode == 0, f"torchrun cli train failed:\n{text[-3000:]}")
    lines = [json.loads(ln) for ln in
             (out / "metrics.jsonl").read_text().splitlines()]
    log("data_parallel_torchrun", seconds=f"{seconds:.1f}", hw=DP_CLI["hw"],
        batch=DP_CLI["batch"], steps=[m["step"] for m in lines],
        loss=[m["loss"] for m in lines], nccl=nccl[:1],
        files=sorted(p.name for p in out.iterdir()))
    check([m["step"] for m in lines] == [1, 2]
          and all(math.isfinite(m["loss"]) for m in lines),
          f"torchrun metrics {lines}")
    check(bool(nccl) or device.type != "cuda",
          "NCCL did not start under torchrun")
    check((out / "params_final.npz").is_file(), "no params_final.npz")


def _ba_scene(C: int, P: int, seed: int, by_point_shards: int = 0) -> dict:
    """tests/test_engine.py's BA scene as host arrays of a BAProblem: C
    cameras along x, P points 6-10 in front, every point seen by every
    camera, the poses (but camera 0's) perturbed by 0.02 and the points by
    0.05; with ``by_point_shards``, the observations grouped by point into
    that many equal slices, obs_pt local to its slice."""
    from geoformer_tpu_torch.engine.lie import se3_exp

    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    pts = rng.uniform([-2, -2, 6], [2, 2, 10], (P, 3)).astype(np.float32)
    xi = np.zeros((C, 6), np.float32)
    xi[:, 3] = 0.3 * np.arange(C)
    xi[:, 1] = 0.02 * np.arange(C)
    cams = se3_exp(torch.from_numpy(xi)).numpy()
    pc = np.einsum("cij,pj->cpi", cams[:, :3, :3], pts) + cams[:, None, :3, 3]
    uv = ((pc / pc[..., 2:]) @ K.T)[..., :2].reshape(-1, 2)
    obs_cam = np.repeat(np.arange(C), P)
    obs_pt = np.tile(np.arange(P), C)
    dxi = rng.normal(0, 0.02, (C, 6)).astype(np.float32)
    dxi[0] = 0
    cams0 = se3_exp(torch.from_numpy(dxi)).numpy() @ cams
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    if by_point_shards:
        order = np.argsort(obs_pt, kind="stable")
        obs_cam, obs_pt, uv = obs_cam[order], obs_pt[order], uv[order]
        obs_pt = obs_pt % (P // by_point_shards)
    return dict(cams=cams0.astype(np.float32), points=pts0, K=K,
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv.astype(np.float32),
                obs_valid=np.ones(C * P, bool))


def _ba_problem(host: dict, device):
    from geoformer_tpu_torch.engine.ba import BAProblem

    return BAProblem(**{k: torch.from_numpy(np.asarray(v)).to(device)
                        for k, v in host.items()})


def _solution_gap(got, ref) -> dict:
    """Two BA solutions compared where the problem fixes them (camera 0
    alone is frozen, so the scale along the baseline is free): the first
    costs' relative gap, the final costs, the ATE of the camera centres
    after a similarity alignment, and the raw cameras' largest gap."""
    from geoformer_tpu_torch.engine import trajectory as tr

    cams, _, hist = (torch.as_tensor(x).cpu() for x in got)
    rcams, _, rhist = (torch.as_tensor(x).cpu() for x in ref)
    return dict(first_rel=float(abs(hist[0] - rhist[0]) / rhist[0]),
                final=max(float(hist[-1]), float(rhist[-1])),
                ate=float(tr.ate_rmse(tr.camera_centers(cams),
                                      tr.camera_centers(rcams))),
                cams=float((cams - rcams).abs().max()))


# the gaps tests/test_torch_port_cuda.py allows between two BA solutions
BA_BARS = dict(first_rel=5e-2, final=1e-3, ate=1e-3, cams=2e-2)


def _check_solution(what: str, gap: dict) -> None:
    check(all(gap[k] < bar for k, bar in BA_BARS.items()),
          f"{what}: {gap} against {BA_BARS}")


def _sharded_hosts():
    """(c)'s scene for the sharded solvers, as ba_solve_sharded takes it
    and grouped by point into two slices for ba_solve_points_sharded."""
    return [_ba_scene(**SHARDED_SCENE),
            _ba_scene(**SHARDED_SCENE, by_point_shards=2)]


def _sharded_solves(hosts, device):
    """This rank's ba_solve_sharded and ba_solve_points_sharded of
    ``hosts`` on ``device`` (host arrays)."""
    from geoformer_tpu_torch.engine import ba

    out = []
    for fn, host in ((ba.ba_solve_sharded, hosts[0]),
                     (ba.ba_solve_points_sharded, hosts[1])):
        got = fn(_ba_problem(host, device), iters=SHARDED_ITERS)
        out.append(tuple(x.cpu().numpy() for x in got))
    return out


def _pose_graph_case():
    from geoformer_tpu_torch.engine.lie import se3_exp

    rng = np.random.default_rng(3)
    step = se3_exp(torch.tensor([0, 0, 0.1, 0.5, 0.05, 0.0]))
    gt = [torch.eye(4)]
    for _ in range(7):
        gt.append(step @ gt[-1])
    noise = se3_exp(torch.from_numpy(rng.normal(0, 0.01, (7, 6))
                                     .astype(np.float32)))
    eT = [noise[i] @ gt[i + 1] @ torch.linalg.inv(gt[i]) for i in range(7)]
    eT.append(gt[7] @ torch.linalg.inv(gt[0]))
    init = [torch.eye(4)]
    for i in range(7):
        init.append(eT[i] @ init[i])
    return dict(poses=torch.stack(init), edge_i=torch.tensor(
        list(range(7)) + [0]), edge_j=torch.tensor(list(range(1, 8)) + [7]),
        edge_T=torch.stack(eT), edge_valid=torch.ones(8, dtype=torch.bool),
        edge_weight=torch.tensor([1.0] * 7 + [10.0])), torch.stack(gt)


def _dp_engine(device, sharded, launch_s):
    """(c): the engine's solvers on the card against the CPU, and the two
    sharded BA solvers of (a)'s ranks (``sharded``, by rank) against one
    process."""
    from geoformer_tpu_torch.engine import ba
    from geoformer_tpu_torch.engine import pose_graph as pg
    from geoformer_tpu_torch.engine import trajectory as tr
    from geoformer_tpu_torch.engine.lie import se3_exp

    host = _ba_scene(**BA_SCENE)
    for name, fn, kw in (("ba_solve", ba.ba_solve, dict(iters=BA_ITERS)),
                         ("ba_solve_huber", ba.ba_solve,
                          dict(iters=BA_ITERS, huber_delta=1.0)),
                         ("ba_solve_cg", ba.ba_solve_cg,
                          dict(iters=6, cg_iters=16))):
        fn(_ba_problem(host, device), **kw)           # warm-up
        _sync(device)
        t0 = time.perf_counter()
        got = fn(_ba_problem(host, device), **kw)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = fn(_ba_problem(host, "cpu"), **kw)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        gap = _solution_gap(got, ref)
        log("engine", solver=name, scene=BA_SCENE, ms=f"{ms:.1f}",
            host_cpu_ms=f"{cpu_ms:.1f}", rmse=f"{float(got[2][-1]):.3e}",
            **{k: f"{v:.2e}" for k, v in gap.items()})
        _check_solution(f"{name} on the card against the CPU", gap)
    arrays, gt = _pose_graph_case()
    got, hist = pg.optimize_pose_graph(pg.PoseGraph(
        **{k: v.to(device) for k, v in arrays.items()}), iters=10)
    ref, ref_hist = pg.optimize_pose_graph(pg.PoseGraph(**arrays), iters=10)
    pose_gap = float((got.cpu() - ref).abs().max())
    ate = float(tr.ate_rmse(tr.camera_centers(got.cpu()),
                            tr.camera_centers(gt), align=False))
    est = torch.from_numpy(np.random.default_rng(4).normal(size=(30, 3))
                           .astype(np.float32))
    rot = se3_exp(torch.tensor([0.1, 0.2, 0.7, 0.0, 0.0, 0.0]))[:3, :3]
    gt_c = 2 * est @ rot.T + torch.tensor([1.0, 2.0, 3.0])
    sim = [float((a.cpu() - b).abs().max()) for a, b in zip(
        tr.align_umeyama(est.to(device), gt_c.to(device)),
        tr.align_umeyama(est, gt_c))]
    ate_card = float(tr.ate_rmse(est.to(device), gt_c.to(device)))
    log("engine", solver="optimize_pose_graph", pose_gap=f"{pose_gap:.2e}",
        residual=[f"{float(x):.3e}" for x in hist[[0, -1]]],
        cpu_residual=[f"{float(x):.3e}" for x in ref_hist[[0, -1]]],
        ate_vs_gt=f"{ate:.4f}", umeyama_gap=[f"{x:.1e}" for x in sim],
        umeyama_ate=f"{ate_card:.2e}")
    check(pose_gap < 2e-4 and ate < 0.05, f"pose graph on the card: gap "
          f"{pose_gap}, ATE {ate}")
    check(max(sim) < 1e-4 and ate_card < 1e-4, f"Umeyama on the card: {sim}"
          f", ATE {ate_card}")
    hosts = _sharded_hosts()
    refs = (ba.ba_solve(_ba_problem(hosts[0], device), iters=SHARDED_ITERS),
            ba.ba_solve_points_sharded(_ba_problem(
                _ba_scene(**SHARDED_SCENE, by_point_shards=1), device),
                iters=SHARDED_ITERS))
    for name, got, ref, other in zip(
            ("ba_solve_sharded", "ba_solve_points_sharded"), sharded[0],
            refs, sharded[1]):
        gap = _solution_gap(got, ref)
        alike = all(np.array_equal(a, b) for a, b in zip(got, other))
        log("engine", solver=name, world=2, backend="gloo",
            scene=SHARDED_SCENE, group_s=f"{launch_s:.1f}", ranks_equal=alike,
            rmse=f"{float(got[2][-1]):.3e}",
            **{k: f"{v:.2e}" for k, v in gap.items()})
        check(alike, f"{name}: the two ranks' solutions differ")
        _check_solution(f"{name} on two ranks against one process", gap)


def phase_data_parallel(device):
    """(a) run_training at the headline recipe, global batch 4 from seed
    66, on two gloo ranks of 2 pairs on the one card, against one process
    at batch 4; (b) `cli train` under torchrun, one rank, NCCL; (c) the
    engine's solvers on the card against the CPU, and the sharded BA
    solvers on two gloo ranks against one process."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sharded, group_s = _dp_two_ranks(device, tmp, headline_config(),
                                         TRAIN_HW, _sharded_hosts())
        _dp_torchrun(device, tmp)
        _dp_engine(device, sharded, group_s)
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 16 ------

# (a): the bench configuration (bf16, 1024 matches and inliers, 256
# hypotheses, K1 and K2) with the trained weights, one pair split over two
# gloo ranks on the one card (NCCL refuses two ranks on one device)
# against one process with the same RANSAC uniforms; at 480x640 and at
# 1920x2560 (76,800 coarse tokens an image)
SP = dict(world=2, hws=((480, 640), (1920, 2560)), forwards=3, seed=0,
          pair_seed=3)
# bf16 features of the two runs, by the largest gap over the largest
# value: the coarse transformer's (f0, f1) within a few bf16 ulps; the
# GAM's (g0, g1) also read windows placed by H, whose last bits differ
SP_FEAT_REL = (2e-2, 2e-2, 1e-1, 1e-1)
SP_H_REL = 1e-2
# (b): the headline recipe's SP train step (f32, TF32 off, K1-K5) at its
# coarse threshold, random weights and one batch of two pairs from seed 66
# (as phase 15: at the live threshold random weights' matches turn on last
# bits, which cuDNN's algorithms for a band and for the whole map differ
# in; and from the trained weights Adam's sign-like first update flips
# 0.78 % of one tensor's elements, whose gradients are at the noise floor);
# the first step's LR is 0 (the recipe's warm-up), so the second moves the
# weights at the full LR from the same weights
SP_TRAIN = dict(hw=(480, 640), batch=2, lrs=(0.0, 1e-3),
                gen_seed=TRAIN_SEED, bank_seed=TRAIN_SEED)


def _sp_infer(device, pair, noise, seq: int) -> dict:
    """The bench configuration's forward of ``pair`` on ``device`` with the
    trained weights (their matches and fit are stable where random
    weights' are not: a last-bit difference can turn a random-weight
    match set and its RANSAC fit), its rows split over a seq group of
    ``seq`` ranks (1: one process): one warm-up, then SP["forwards"] timed
    forwards; ms a forward, launches a forward, peak GiB, the outputs
    (host arrays)."""
    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.eval import selfcheck as sc
    from geoformer_tpu_torch.models.geoformer import gather_feats
    from geoformer_tpu_torch.ops import gam_kernels as gk

    cfg = bench_config(use_bf16=True).replace(seq_axis="seq")
    model = sc.load_model(cfg, str(CKPT), device).eval()
    i0, i1 = (torch.from_numpy(a)[None, ..., None].to(device) for a in pair)
    u = torch.from_numpy(noise).to(device)
    small = pair[0].shape == SP["hws"][0]
    with mesh.seq_groups(seq), torch.no_grad():
        model(i0, i1, ransac_noise=u)                   # warm-up
        _sync(device)
        torch.cuda.reset_peak_memory_stats()
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(SP["forwards"]):
            out = model(i0, i1, ransac_noise=u, return_feats=small)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3 / SP["forwards"]
        launches = {k: v / SP["forwards"] for k, v in gk.LAUNCHES.items()}
        feats = [f.float().cpu().numpy() for f in gather_feats(out.feats)]
    host = lambda x: x.float().cpu().numpy()  # noqa: E731
    return dict(ms=ms, launches=launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                feats=feats, H=host(out.geo.H),
                has_H=out.geo.has_H.cpu().numpy(),
                i=out.matches.i_ids.cpu().numpy(),
                j=out.matches.j_ids.cpu().numpy(),
                valid=out.matches.valid.cpu().numpy(),
                kp=np.concatenate([host(out.fine.mkpts0),
                                   host(out.fine.mkpts1)], -1),
                fine_valid=out.fine.valid.cpu().numpy())


def _sp_train(device, batch, seq: int) -> dict:
    """SP_TRAIN's steps of the headline recipe from random weights (seed
    66) on ``batch`` (host arrays) on ``device``, rows split over ``seq``
    ranks: each step's synchronized ms, launches and scalars, the peak
    GiB, the state after them."""
    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.ops import gam_kernels as gk
    from geoformer_tpu_torch.train.optim import make_optimizer
    from geoformer_tpu_torch.train.trainer import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = headline_config().replace(seq_axis="seq")
    tc = TrainConfig(batch_size=SP_TRAIN["batch"], image_hw=SP_TRAIN["hw"])
    model = weights.random_init(GeoFormer(cfg), TRAIN_SEED).to(device)
    state = TrainState(model, make_optimizer(tc.optim, model.parameters()))
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator(device).manual_seed(SP_TRAIN["gen_seed"])
    steps = []
    with mesh.seq_groups(seq):
        step = make_train_step(tc)
        torch.cuda.reset_peak_memory_stats()
        for lr in SP_TRAIN["lrs"]:
            gk.reset_launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            scalars = step(state, t, lr, generator=gen)
            _sync(device)
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              launches=dict(gk.LAUNCHES),
                              scalars={k: float(v) for k, v in
                                       scalars.items()}))
    return dict(steps=steps,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                state={k: v.cpu().numpy() for k, v in
                       state.model.state_dict().items()})


def _sp_rank(rank, plan, device):
    """Phase 16 on one rank of the seq group: (a) at both sizes, then
    (b)."""
    device = torch.device(device)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    infer = {hw: _sp_infer(device, pair, plan["noise"][hw], SP["world"])
             for hw, pair in plan["pairs"].items()}
    torch.cuda.empty_cache()
    return dict(infer=infer, train=_sp_train(device, plan["batch"],
                                              SP["world"]))


def _sp_match_gap(got, ref) -> dict:
    """Overlap of the (i, j) match sets of the first pair, the share of
    the common matches whose final keypoints agree within PARITY's px,
    H's relative gap and has_H's agreement."""
    def pairs(r):     # (i, j) -> final keypoints, None where gated
        v = r["valid"][0]
        return {(int(a), int(b)): k if fv else None for a, b, k, fv in zip(
            r["i"][0][v], r["j"][0][v], r["kp"][0][v], r["fine_valid"][0][v])}

    pg, pr = pairs(got), pairs(ref)
    common = pg.keys() & pr.keys()
    kp_ok = [np.abs(pg[c] - pr[c]).max() <= PARITY["kp_px"] for c in common
             if pg[c] is not None and pr[c] is not None]
    return dict(overlap=len(common) / max(len(pg.keys() | pr.keys()), 1),
                matches=len(pr), kp_share=float(np.mean(kp_ok))
                if kp_ok else 1.0,
                H_rel=float(np.abs(got["H"] - ref["H"]).max()
                            / np.abs(ref["H"]).max()),
                has_H_equal=bool((got["has_H"] == ref["has_H"]).all()))


def _sp_cli(device, tmp):
    """(c): cli infer --seq-shard 2 on the one card refuses with the
    documented error; --seq-shard 1 runs."""
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.utils.plotting import write_png

    a, b = textured_pair((240, 320), 1)
    paths = []
    for name, img in (("a.png", a), ("b.png", b)):
        write_png(str(tmp / name), (img * 255).astype(np.uint8))
        paths.append(str(tmp / name))
    runs = {}
    for n in (2, 1):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "geoformer_tpu_torch.cli", "infer",
             *paths, "--imsize", "240", "--seq-shard", str(n)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        runs[n] = (r.returncode, r.stdout + r.stderr,
                   time.perf_counter() - t0)
    refusal = "--seq-shard 2 > 1 devices"
    log("seq_parallel_cli", cards=torch.cuda.device_count(),
        seq_shard_2_rc=runs[2][0], seq_shard_2_refused=refusal in runs[2][1],
        seq_shard_1_rc=runs[1][0],
        seq_shard_1=[ln for ln in runs[1][1].splitlines()
                     if "matches in" in ln][:1],
        seconds=[f"{runs[n][2]:.1f}" for n in (2, 1)])
    if torch.cuda.device_count() == 1:
        check(runs[2][0] != 0 and refusal in runs[2][1],
              f"--seq-shard 2 on one card did not refuse:\n"
              f"{runs[2][1][-2000:]}")
    check(runs[1][0] == 0 and "matches in" in runs[1][1],
          f"--seq-shard 1 failed:\n{runs[1][1][-2000:]}")


def phase_seq_parallel(device):
    """(a) the bench configuration's forward with one pair's rows split
    over two gloo ranks on the one card, against one process, at 480x640
    and 1920x2560; (b) the headline recipe's SP train step, two ranks
    against one process; (c) cli infer --seq-shard on the one card."""
    import tempfile

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.data.native import native_textures_mixed
    from geoformer_tpu_torch.data.synthetic import make_pair_batch
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models import GeoFormer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_config(use_bf16=True)
    rng = np.random.default_rng(SP["seed"])
    noise = {hw: rng.random((1, cfg.geo.ransac_iters, min(
        cfg.match.max_matches, hw[0] * hw[1] // 64))).astype(np.float32)
        for hw in SP["hws"]}
    pairs = {hw: textured_pair(hw, SP["pair_seed"]) for hw in SP["hws"]}
    gen = torch.Generator(device).manual_seed(SP_TRAIN["gen_seed"])
    base = torch.from_numpy(native_textures_mixed(
        SP_TRAIN["batch"], *SP_TRAIN["hw"], seed=SP_TRAIN["bank_seed"]))
    batch = {k: v.cpu().numpy() for k, v in
             make_pair_batch(base.to(device), gen).items()}
    one = {hw: _sp_infer(device, pair, noise[hw], 1)
           for hw, pair in pairs.items()}
    torch.cuda.empty_cache()
    one_train = _sp_train(device, batch, 1)
    before = {k: v.numpy() for k, v in weights.random_init(GeoFormer(
        headline_config()), TRAIN_SEED).state_dict().items()}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = mesh.launch(_sp_rank, SP["world"], (dict(
            pairs=pairs, noise=noise, batch=batch), str(device)),
            backend="gloo", timeout=900, threads=4, init_dir=tmp)
        group_s = time.perf_counter() - t0
        for hw in SP["hws"]:
            ref, got = one[hw], ranks[0]["infer"][hw]
            gap = _sp_match_gap(got, ref)
            feat_rel = [float(np.abs(a - b).max() / np.abs(b).max())
                        for a, b in zip(got["feats"], ref["feats"])]
            log("seq_parallel_infer", hw=hw, world=SP["world"],
                backend="gloo", config="bench(bf16,max_matches=1024,"
                "ransac_iters=256,max_inliers=1024,K1+K2),tpu_r3_main",
                ms_per_pair_rank=[f"{r['infer'][hw]['ms']:.2f}"
                                  for r in ranks],
                one_process_ms_per_pair=f"{ref['ms']:.2f}",
                peak_gib_rank=[f"{r['infer'][hw]['peak_gib']:.3f}"
                               for r in ranks],
                one_process_peak_gib=f"{ref['peak_gib']:.3f}",
                launches_per_forward_rank=[r["infer"][hw]["launches"]
                                           for r in ranks],
                feat_rel_gap=[f"{x:.2e}" for x in feat_rel],
                has_H=got["has_H"].tolist(),
                **{k: (f"{v:.3e}" if isinstance(v, float) else v)
                   for k, v in gap.items()})
            for r, res in enumerate(ranks):
                lc = res["infer"][hw]["launches"]
                for name, count in lc.items():
                    want = PER_FORWARD.get(name, 0)
                    check(count == want, f"rank {r} at {hw}: {name} "
                          f"launched {count} times a forward, expected "
                          f"{want}")
                check(res["infer"][hw]["has_H"].tolist()
                      == got["has_H"].tolist(), "the ranks' has_H differ")
                check(np.array_equal(res["infer"][hw]["H"], got["H"]),
                      "the ranks' H differ")
            check(bool(ref["has_H"].all()), f"{hw}: no homography: the "
                  "GAM's cross layers did not run on K1")
            check(gap["has_H_equal"] and gap["H_rel"] <= SP_H_REL
                  and gap["overlap"] >= PARITY["overlap"]
                  and gap["kp_share"] >= PARITY["overlap"],
                  f"{hw}: two ranks against one process: {gap}")
            check(all(x <= bar for x, bar in zip(feat_rel, SP_FEAT_REL)),
                  f"{hw}: feature gaps {feat_rel} over {SP_FEAT_REL}")
        steps = [r["train"]["steps"] for r in ranks]
        gaps = {}
        for i, (s, ref) in enumerate(zip(steps[0], one_train["steps"])):
            for k in ("loss", "grad_norm"):
                gaps[f"{k}@{i + 1}"] = abs(s["scalars"][k]
                                           - ref["scalars"][k]) \
                    / abs(ref["scalars"][k])
        rel, off, stats = _update_gap(ranks[0]["train"]["state"],
                                      one_train["state"], before,
                                      SP_TRAIN["lrs"][-1])
        same = all(np.array_equal(ranks[0]["train"]["state"][k],
                                  ranks[1]["train"]["state"][k])
                   for k in ranks[0]["train"]["state"])
        log("seq_parallel_train", world=SP["world"], backend="gloo",
            config="headline(480x640,f32,batch2,K1-K5),seed66",
            group_s=f"{group_s:.1f}",
            ms_per_step_rank=[[f"{s['ms']:.1f}" for s in st]
                              for st in steps],
            one_process_ms_per_step=[f"{s['ms']:.1f}"
                                     for s in one_train["steps"]],
            peak_gib_rank=[f"{r['train']['peak_gib']:.3f}" for r in ranks],
            one_process_peak_gib=f"{one_train['peak_gib']:.3f}",
            loss=[s["scalars"]["loss"] for s in steps[0]],
            one_process_loss=[s["scalars"]["loss"]
                              for s in one_train["steps"]],
            grad_norm=[s["scalars"]["grad_norm"] for s in steps[0]],
            one_process_grad_norm=[s["scalars"]["grad_norm"]
                                   for s in one_train["steps"]],
            num_inliers=[s["scalars"]["num_inliers"] for s in steps[0]],
            scalar_rel_gap={k: f"{v:.2e}" for k, v in gaps.items()},
            update_rel_l2=f"{rel:.3e}", update_off_share=f"{off:.4f}",
            batch_stats_excess=f"{stats:.2e}", ranks_equal=same,
            launches_per_step_rank=[[s["launches"] for s in st]
                                    for st in steps])
        for r, st in enumerate(steps):
            for i, s in enumerate(st):
                for name, count in s["launches"].items():
                    want = PER_TRAIN_STEP.get(name, 0)
                    check(count == want, f"rank {r} SP train step {i + 1}: "
                          f"{name} launched {count} times, expected {want}")
        check(all(v <= DP_SCALAR_REL for v in gaps.values()),
              f"SP train: loss/grad_norm against one process: {gaps}")
        check(rel < DP_UPDATE["rel_l2"] and off < DP_UPDATE["off_share"],
              f"SP train: update against one process: rel L2 {rel}, off "
              f"share {off}")
        check(stats == 0.0, f"SP train: BatchNorm statistics off by {stats}")
        check(same, "SP train: the two ranks' states differ")
        _sp_cli(device, Path(tmp))
    torch.cuda.empty_cache()


# ------------------------------------------------------------ main ---------

_PA = "geoformer_tpu/ops/pallas_attention.py"
_CSRC = "geoformer_tpu_torch/csrc"
# kernel -> (TPU kernel it replaces, CUDA source, the path whose run its
# launches are read from, the dtype of that path)
KERNELS = {
    "box_window_attention": (f"{_PA}:277", f"{_CSRC}/box_window_attention.cu",
                             "inference", torch.bfloat16),
    "masked_kv_attention": (f"{_PA}:30", f"{_CSRC}/masked_kv_attention.cu",
                            "inference", torch.bfloat16),
    "masked_kv_attention_bwd": (f"{_PA}:111",
                                f"{_CSRC}/masked_kv_attention_bwd.cu",
                                "training", torch.float32),
    "box_window_attention_bwd_dkv": (f"{_PA}:351",
                                     f"{_CSRC}/box_window_attention_bwd.cu",
                                     "training", torch.float32),
    "box_window_attention_bwd_dq": (f"{_PA}:418",
                                    f"{_CSRC}/box_window_attention_bwd.cu",
                                    "training", torch.float32),
    # K6 replaces no TPU kernel: the JAX package runs XLA ops there
    "streaming_match_extract": (
        "none (XLA ops: geoformer_tpu/ops/fused_loss.py:"
        "streaming_match_extract)", f"{_CSRC}/streaming_match.cu",
        "inference", torch.float32),
}
# launch counts (one a wrapper call) a forward of the streamed matcher: K1
# and K2 in the GAM's four layers, K6 in the two coarse matchings
PER_FORWARD = {"box_window_attention": 4, "masked_kv_attention": 4,
               "streaming_match_extract": 2}
# a train step: K1-K5 four times, K6 twice (the forward's matchings)
PER_TRAIN_STEP = {**{name: 4 for name in KERNELS},
                  "streaming_match_extract": 2}


def _per_forward(cfg) -> dict:
    """PER_FORWARD for cfg's matcher: the sinkhorn matcher and the dense
    extraction bypass K6."""
    streamed = (cfg.match.match_type != "sinkhorn"
                and cfg.match.streaming_extract)
    return {**PER_FORWARD, "streaming_match_extract": 2 if streamed else 0}


def main() -> int:
    card = phase_device()
    device = torch.device("cuda", 0)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        log("phase", name=name, seconds=seconds[name])
        return out

    fwd_results = timed("kernels", phase_kernels, device)
    launches, ms_per_pair, live_model = timed("main_path", phase_main_path,
                                              device)
    timed("small_parity", phase_small_parity, device)
    bwd_results = timed("bwd_kernels", phase_backward_kernels, device)
    train_launches, ms_step = timed("training", phase_training, device)
    timed("train_parity", phase_train_parity, device)
    timed("eval_path", phase_eval_path, device, live_model)
    timed("eval_trained", phase_eval_trained, device)
    timed("training_loop", phase_training_loop, device, ms_step)
    timed("fire_isc", phase_fire_isc, device)
    timed("released", phase_released, device)
    timed("depth", phase_depth, device)
    timed("localize_slam", phase_localize_slam, device)
    timed("int8_alternates", phase_int8_alternates, device, ms_per_pair)
    timed("data_parallel", phase_data_parallel, device)
    timed("seq_parallel", phase_seq_parallel, device)
    results = {**fwd_results, **bwd_results}
    path_launches = {"inference": launches, "training": train_launches}
    kernels = []
    for name, (replaces, source, path, dtype) in KERNELS.items():
        r = results[(name, dtype)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # ms is the device time (CUDA-graph replay but for K3); call_ms
            # is an eager call's, the custom op's host dispatch included
            "call_ms": r["call_ms"]})
        check(kernels[-1]["launches"] > 0, f"{name} was not launched on "
              f"the {path} path")
    log("total", seconds=f"{time.perf_counter() - T_START:.1f}",
        phases=seconds, ms_per_pair=f"{ms_per_pair:.3f}",
        train_ms_per_step=f"{ms_step:.1f}", card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
