#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geoformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: card name and power limit, torch and CUDA versions, the nvcc
   build of the CUDA kernels (geoformer_tpu_torch/csrc/*.cu), TF32 off;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (B=2), in bf16 and f32, with the stated
   tolerance, and the kernel's, the plain version's and one library call's
   times beside the kernel's bound;
3. main path: the port's BatchedMatcher at full width, bf16, 480x640, the
   bench configuration, random weights from a seed, on a textured image and
   its warp by a known homography; the launch counts of both kernels are
   read around the run. One more request with the same weights at a low
   coarse threshold gives the GAM real inliers and a homography. Then, at
   a small size in f32, the forward through the kernels is held against
   the same forward through their plain versions on the same card.

The script reads no data file: weights come from a seed and images from
numpy. It needs only the standard library, torch and numpy. Any failure
raises, so the exit code is nonzero; with no CUDA device it stops in
phase 1. The last line of a successful run is one JSON object naming the
device; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()

# One NVIDIA H100 SXM, published dense peaks (NVIDIA data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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

def _homography_centers(b: int, grid_hw) -> torch.Tensor:
    """Warped box centres as the GAM makes them, for a known homography,
    with a few rows pushed fully and partly off the grid."""
    hg, wg = grid_hw
    scale = 8
    H = torch.tensor([[0.95, 0.05, 12.0], [-0.04, 0.98, -6.0],
                      [1e-5, 2e-5, 1.0]], dtype=torch.float64)
    ids = torch.arange(hg * wg)
    pts = torch.stack([(ids % wg) * scale, (ids // wg) * scale,
                       torch.ones_like(ids)], -1).double()
    w = pts @ H.T
    c = torch.floor((w[:, :2] / w[:, 2:]) / scale).to(torch.int32)
    centers = c[None].repeat(b, 1, 1)
    centers[:, :40] = torch.tensor([-10, -10], dtype=torch.int32)   # off
    centers[:, 40:80, 0] = -1                                      # partly
    centers[-1, 100:140] = torch.tensor([wg + 1, hg + 1], dtype=torch.int32)
    return centers


def _rand(shape, gen, dtype, device):
    return torch.randn(shape, generator=gen).to(dtype=dtype, device=device)


def phase_kernels(device):
    from geoformer_tpu_torch.ops import gam_kernels as gk

    gen = torch.Generator().manual_seed(0)
    b = KERNEL_B
    hg, wg = GRID_HW
    s = hg * wg
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        # ---- K1: box-window attention, L = S = 4800
        q, k, v = (_rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
                   for _ in range(3))
        centers = _homography_centers(b, GRID_HW).to(device)
        out, lse = gk.box_window_attention(q, k, v, centers, GRID_HW, 2)
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
        ms = time_ms(lambda: gk.box_window_attention(q, k, v, centers,
                                                     GRID_HW, 2), 50)
        plain_ms = time_ms(lambda: gk.box_window_attention_plain(
            q, k, v, centers, GRID_HW, 2), 3, warmup=1)
        box = _dense_box(centers, GRID_HW, 2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             qt, kt, vt, attn_mask=box[:, None]), 5)
        del box
        log("kernels", name="box_window_attention", dtype=str(dtype),
            kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=by)
        results[("box_window_attention", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by)
        del q, k, v, out, ref

        # ---- K2: masked-KV attention, L = 4800, S = 1024, one row masked
        q = _rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
        k, v = (_rand((b, MAX_INLIERS, HEADS, HEAD_DIM), gen, dtype, device)
                for _ in range(2))
        mask = (torch.rand((b, MAX_INLIERS), generator=gen) < 0.6)
        mask[-1] = False                          # RANSAC found no inliers
        mask = mask.to(device)
        out = gk.masked_kv_attention(q, k, v, mask)
        ref = gk.masked_kv_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        mean_v = v[-1].float().mean(dim=0)                       # [H, D]
        masked_err = (out[-1] - mean_v[None]).abs().max().item()
        tol = TOL[("masked_kv_attention", dtype)]
        log("kernels", name="masked_kv_attention", dtype=str(dtype),
            shape=f"q{tuple(q.shape)}k{tuple(k.shape)}",
            out_dtype=str(out.dtype), max_abs_err=f"{err:.3e}", tol=tol,
            all_masked_row_vs_mean_v=f"{masked_err:.3e}")
        check(out.dtype == torch.float32, "K2 must return f32")
        check(err <= tol, f"K2 {dtype}: error {err} > {tol}")
        check(masked_err <= tol, f"K2 {dtype}: all-masked row is not the "
              f"mean of V ({masked_err})")
        n_keep = mask.sum(dim=1).double()
        flops = float((4.0 * HEAD_DIM * HEADS * s * n_keep).sum()
                      + (n_keep == 0).sum() * MAX_INLIERS * HEAD_DIM * HEADS)
        nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
                  + mask.numel() + out.numel() * 4)
        bound, by = _bound(nbytes, flops, dtype)
        # the same call with every key live, for a bound that is not this
        # mask's: every query scores every key
        bound_live, by_live = _bound(
            nbytes, 4.0 * HEAD_DIM * HEADS * s * MAX_INLIERS * b, dtype)
        ms = time_ms(lambda: gk.masked_kv_attention(q, k, v, mask), 20)
        plain_ms = time_ms(lambda: gk.masked_kv_attention_plain(
            q, k, v, mask), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        am = mask[:, None, None, :]
        lib_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=am), 20)
        log("kernels", name="masked_kv_attention", dtype=str(dtype),
            kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=by, live_keys=[int(n) for n in n_keep.tolist()],
            bound_all_live_ms=f"{bound_live:.4f}", bound_all_live_by=by_live)
        results[("masked_kv_attention", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return results


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


def _bound(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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
        check(count == per_fwd, f"{name} launched {count} times in "
              f"{REQUESTS} forwards, expected 4 per forward")
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
        check(count == 4, f"{name} launched {count} times in the live-GAM "
              "forward, expected 4")
    check(any(has_h), "the live-GAM request found no homography")
    _check_outputs(res, MAIN_HW)
    return launches, ms_per_pair


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the GAM's kernel wrappers are replaced by their
    plain versions, on any device. The small parity check's reference run
    uses it; the port itself never falls back."""
    from geoformer_tpu_torch.ops import gam_kernels as gk

    saved = gk.box_window_attention, gk.masked_kv_attention
    gk.box_window_attention = gk.box_window_attention_plain
    gk.masked_kv_attention = gk.masked_kv_attention_plain
    try:
        yield
    finally:
        gk.box_window_attention, gk.masked_kv_attention = saved


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
    check(all(v == 4 for v in a_launch.values()),
          "kernel path did not launch both kernels 4 times")
    check(all(v == 0 for v in b_launch.values()),
          "plain versions launched a kernel")
    check(gam_err <= GAM_TOL, f"GAM outputs differ by {gam_err}")
    check(overlap >= PARITY["overlap"], "kernel and plain versions' match "
          f"sets differ: overlap {overlap}")
    check(kp_max < PARITY["kp_px"], f"a common keypoint moved {kp_max} px")


# ------------------------------------------------------------ main ---------

REPLACES = {
    "box_window_attention": "geoformer_tpu/ops/pallas_attention.py:277",
    "masked_kv_attention": "geoformer_tpu/ops/pallas_attention.py:30",
}
SOURCES = {
    "box_window_attention": "geoformer_tpu_torch/csrc/box_window_attention.cu",
    "masked_kv_attention": "geoformer_tpu_torch/csrc/masked_kv_attention.cu",
}


def main() -> int:
    card = phase_device()
    device = torch.device("cuda", 0)
    kernel_results = phase_kernels(device)
    launches, ms_per_pair = phase_main_path(device)
    phase_small_parity(device)
    kernels = []
    for name in ("box_window_attention", "masked_kv_attention"):
        r = kernel_results[(name, torch.bfloat16)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log("total", seconds=f"{time.perf_counter() - T_START:.1f}",
        ms_per_pair=f"{ms_per_pair:.3f}", card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
