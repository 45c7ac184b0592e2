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
   path's shape (B=4, S=512, f32);
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
   CPU reference; when it is not, one line says so.

K1, K4 and K5 (a plan and then the pieces, several launches a call) are
timed on the device by CUDA-graph replay (kernel_ms), beside the time per
call of an eager loop by CUDA events (call_ms), which also holds the
host's time per call where that is the longer; the other kernels by the
event loop.

Phases 1-7 read no data file: weights come from a seed and images from
numpy (phase 7 decodes only files it wrote). Phase 8 reads the trained
checkpoint and the held-out photographs through the port's own loaders.
It needs only the standard library, torch and numpy. Any failure
raises, so the exit code is nonzero; with no CUDA device it stops in
phase 1. The last line of a successful run is one JSON object naming the
device; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import json
import math
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

def phase_device():
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    check(torch.cuda.is_available(), "no CUDA device: the port runs on the "
          "card only (the CPU tests cover its plain versions)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
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
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by)
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
    return results


def _prefix_like(mask):
    """The same live count in each batch row, packed first, as the GAM's
    masked_select_capacity packs its inliers."""
    n = mask.sum(dim=1, keepdim=True)
    return torch.arange(mask.shape[1], device=mask.device)[None] < n


def _mka_live_sweep(gk, device, dtype, b, s, counts, backward=False):
    """K2 (or K3, from K2's statistics) on prefix masks with the same live
    count in every batch row, for the time's dependence on that count;
    each run is held against the plain version."""
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
            ms.append(time_ms(lambda: gk.masked_kv_attention_fwd(
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
    ms = time_ms(lambda: gk.masked_kv_attention_fwd(q, k, v, mask), 20)
    plain_ms = time_ms(lambda: gk.masked_kv_attention_plain(q, k, v, mask), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    am = mask[:, None, None, :]
    lib_ms = time_ms(lambda: torch.nn.functional.
                     scaled_dot_product_attention(qt, kt, vt, attn_mask=am),
                     20)
    log("kernels", name="masked_kv_attention", dtype=str(dtype), mask=kind,
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
        bound_by=by, live_keys=[int(n) for n in n_keep.tolist()],
        bound_all_live_ms=f"{bound_live:.4f}", bound_all_live_by=by_live,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by)


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
    per_fwd = 4 * REQUESTS
    for name, count in launches.items():
        want = per_fwd if name in FORWARD_KERNELS else 0
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
        want = 4 if name in FORWARD_KERNELS else 0
        check(count == want, f"{name} launched {count} times in the "
              f"live-GAM forward, expected {want}")
    check(any(has_h), "the live-GAM request found no homography")
    _check_outputs(res, MAIN_HW)
    return launches, ms_per_pair, live_model


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the GAM's kernel wrappers (K1-K5) are replaced by
    their plain versions, on any device; the differentiable ops call them
    by name. The parity checks' reference runs use it; the port itself
    never falls back."""
    from geoformer_tpu_torch.ops import gam_kernels as gk

    plain = {"box_window_attention_fwd": gk.box_window_attention_plain,
             "box_window_attention_bwd": gk.box_window_attention_bwd_plain,
             "masked_kv_attention_fwd": gk.masked_kv_attention_plain,
             "masked_kv_attention_bwd": gk.masked_kv_attention_bwd_plain}
    saved = {name: getattr(gk, name) for name in plain}
    for name, fn in plain.items():
        setattr(gk, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(gk, name, fn)


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
    check(all(a_launch[k] == 4 for k in FORWARD_KERNELS),
          "kernel path did not launch both kernels 4 times")
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


def _box_dq_case(gk, q, k, v, g, centers, pattern):
    """K5 alone on one centre pattern: against the plain backward, the
    off-grid rows' zero dq, the same bits twice, ms hot and with L2
    flushed, the bound, the load."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    t0 = time.perf_counter()
    dtype = q.dtype
    tol = BWD_TOL[dtype]
    out, lse = gk.box_window_attention_fwd(q, k, v, centers, GRID_HW, 2)
    gf = g.float()
    delta = (gf * out.float()).sum(-1)

    def run():
        return gk.box_window_attention_bwd_dq(q, k, v, centers, lse, delta,
                                              gf, GRID_HW, 2)

    got, again = run(), run()
    ref = gk.box_window_attention_bwd_plain(q, k, v, centers, out, lse, g,
                                            GRID_HW, 2)[0]
    torch.cuda.synchronize()
    same_bits = torch.equal(got, again)
    rel = _rel_err(got.to(dtype), ref)
    off = _offgrid_rows(centers, GRID_HW)
    off_zero = bool((got[off] == 0).all())
    cells = _box_cells(centers, GRID_HW, 2)
    # q, k, v in their type; f32 g, lse, delta in, f32 dq out
    nbytes = (3 * q.numel() * q.element_size() + 2 * q.numel() * 4
              + centers.numel() * 4 + 2 * lse.numel() * 4)
    bound, by = _bound(nbytes, 6.0 * HEAD_DIM * HEADS * cells, dtype)
    ms = bk.time_graph_ms(run, 20)
    cold_ms = bk.time_graph_cold_ms(run, 10)
    call_ms = time_ms(run, 20)
    log("bwd_kernels", name="box_window_attention_bwd_dq",
        dtype=str(dtype), centres=pattern, shape=f"q{tuple(q.shape)}",
        rel_err=f"{rel:.3e}", rel_tol=tol, offgrid_rows=int(off.sum()),
        offgrid_dq_zero=off_zero, same_bits_twice=same_bits,
        kernel_ms=f"{ms:.4f}", kernel_cold_ms=f"{cold_ms:.4f}",
        call_ms=f"{call_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=by,
        **_gather_load(gk, centers, GRID_HW),
        seconds=f"{time.perf_counter() - t0:.1f}")
    check(rel <= tol, f"K5 {dtype} {pattern}: relative error {rel} > {tol}")
    check(off_zero, f"K5 {dtype} {pattern}: off-grid rows got a gradient")
    check(same_bits, f"K5 {dtype} {pattern}: two calls differ")


def _box_dkv_case(gk, q, k, v, g, centers, pattern):
    """K4 alone on one centre pattern: against the plain backward, the
    same bits twice, ms hot and with L2 flushed, the bound, the load."""
    from geoformer_tpu_torch.eval import box_kernels as bk

    t0 = time.perf_counter()
    dtype = q.dtype
    tol = BWD_TOL[dtype]
    out, lse = gk.box_window_attention_fwd(q, k, v, centers, GRID_HW, 2)
    gf = g.float()
    delta = (gf * out.float()).sum(-1)

    def run():
        return gk.box_window_attention_bwd_dkv(q, k, v, centers, lse, delta,
                                               gf, GRID_HW, 2)

    got, again = run(), run()
    ref = gk.box_window_attention_bwd_plain(q, k, v, centers, out, lse, g,
                                            GRID_HW, 2)[1:]
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    rel = max(_rel_err(a.to(dtype), r) for a, r in zip(got, ref))
    cells = _box_cells(centers, GRID_HW, 2)
    # q, k, v in their type; f32 g, lse, delta in, f32 dk, dv out
    nbytes = (3 * q.numel() * q.element_size() + 3 * q.numel() * 4
              + centers.numel() * 4 + 2 * lse.numel() * 4)
    bound, by = _bound(nbytes, 8.0 * HEAD_DIM * HEADS * cells, dtype)
    ms = bk.time_graph_ms(run, 20)
    cold_ms = bk.time_graph_cold_ms(run, 10)
    call_ms = time_ms(run, 20)
    load = _k4_load(gk, centers, GRID_HW)
    log("bwd_kernels", name="box_window_attention_bwd_dkv",
        dtype=str(dtype), centres=pattern, shape=f"q{tuple(q.shape)}",
        rel_err=f"{rel:.3e}", rel_tol=tol, same_bits_twice=same_bits,
        kernel_ms=f"{ms:.4f}", kernel_cold_ms=f"{cold_ms:.4f}",
        call_ms=f"{call_ms:.4f}",
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
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by)


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
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
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
        def keep(*args):
            calls[name].append(args)
            return wrapped[name](*args)
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
        check(count == 4 * TRAIN_STEPS, f"{name} launched {count} times in "
              f"{TRAIN_STEPS} train steps, expected 4 per step")

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
        check(count == 4, f"{name} launched {count} times in the live-GAM "
              "step, expected 4")
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
    check(all(v == 4 for v in launch_a.values()),
          "the kernel step did not launch each of K1-K5 4 times")
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
        want = 4 * forwards if name in FORWARD_KERNELS else 0
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
}
FORWARD_KERNELS = ("box_window_attention", "masked_kv_attention")


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
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
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
