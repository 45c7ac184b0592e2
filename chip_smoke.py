#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geoformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:

1. device: card name and power limit, torch and CUDA versions, the nvcc
   build of the CUDA kernels (geoformer_tpu_torch/csrc/*.cu), TF32 off;
2. kernels: the forward kernels K1 and K2 against their plain PyTorch
   versions on the card at the inference path's shapes (B=2), in bf16 and
   f32, with the stated tolerance, and the kernel's, the plain version's
   and one library call's times beside the kernel's bound;
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
   scaled_dot_product_attention with the same boolean mask);
5. training path: run_training at the headline recipe (480x640, f32,
   batch 4, random weights, the procedural bank of 256 textures), one
   warm-up step and three timed ones, with the launch counts of K1-K5 read
   around it; one profiled step; one step at a low coarse threshold where
   RANSAC finds a homography and the cross layers' gradients go through
   K4/K5;
6. train parity: at 120x160 in f32 with full widths, one train step
   through the kernels against the same step through their plain versions
   on the same card (loss and every parameter gradient).

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
        ms = time_ms(lambda: gk.box_window_attention_fwd(q, k, v, centers,
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
        out = gk.masked_kv_attention_fwd(q, k, v, mask)
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
        ms = time_ms(lambda: gk.masked_kv_attention_fwd(q, k, v, mask), 20)
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
    return launches, ms_per_pair


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


def phase_backward_kernels(device):
    """K3, K4 and K5 against their plain backwards at the training path's
    shapes (B=4, L=4800; S=512 for K3, S=4800 for K4/K5), f32 and bf16."""
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
        got = gk.masked_kv_attention_bwd(q, k, v, mask, g)
        ref = gk.masked_kv_attention_bwd_plain(q, k, v, mask, g)
        torch.cuda.synchronize()
        rel = max(_rel_err(a, r) for a, r in zip(got, ref))
        err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(got, ref))
        colmean = g[-1].sum(dim=0) / TRAIN_INLIERS
        masked_rel = _rel_err(got[2][-1], colmean.expand_as(got[2][-1]))
        masked_zero = bool((got[0][-1] == 0).all() and (got[1][-1] == 0).all())
        n_keep = mask.sum(dim=1).double()
        flops = float((10.0 * HEAD_DIM * HEADS * s * n_keep).sum()
                      + 2.0 * HEAD_DIM * HEADS * s * (n_keep == 0).sum())
        nbytes = (2 * (q.numel() + k.numel() + v.numel()) * q.element_size()
                  + mask.numel() + g.numel() * 4)
        bound, by = _bound(nbytes, flops, dtype)
        ms = time_ms(lambda: gk.masked_kv_attention_bwd(q, k, v, mask, g), 10)
        plain_ms = time_ms(lambda: gk.masked_kv_attention_bwd_plain(
            q, k, v, mask, g), 3, warmup=1)
        lib_ms = _sdpa_bwd_ms(q, k, v, mask[:, None, None, :], g)
        log("bwd_kernels", name="masked_kv_attention_bwd", dtype=str(dtype),
            shape=f"q{tuple(q.shape)}k{tuple(k.shape)}",
            max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", rel_tol=tol,
            all_masked_dv_rel_err=f"{masked_rel:.3e}",
            all_masked_dq_dk_zero=masked_zero, kernel_ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by,
            live_keys=[int(x) for x in n_keep.tolist()])
        check(rel <= tol, f"K3 {dtype}: relative error {rel} > {tol}")
        check(masked_zero and masked_rel <= tol,
              f"K3 {dtype}: the all-masked row breaks the contract")
        results[("masked_kv_attention_bwd", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by)
        del q, k, v, g, got, ref

        # ---- K5 and K4: box-window backward, centres with off-grid rows
        q, k, v, g = (_rand((b, s, HEADS, HEAD_DIM), gen, dtype, device)
                      for _ in range(4))
        centers = _homography_centers(b, GRID_HW).to(device)
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
            ms = time_ms(lambda: fn(q, k, v, centers, lse, delta, gf,
                                    GRID_HW, 2), 20)
            log("bwd_kernels", name=name, dtype=str(dtype),
                shape=f"q{tuple(q.shape)}", max_abs_err=f"{err:.3e}",
                rel_err=f"{rel:.3e}", rel_tol=tol, kernel_ms=f"{ms:.4f}",
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
        del q, k, v, g, out, ref, dq, dk, dv, again
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ phase 5 ------

TRAIN_HW = (480, 640)
TRAIN_STEPS = 4          # one warm-up step, then three timed
TRAIN_SEED = 66          # run_training's default seed (weights and data)
GAM_KERNEL_NAMES = ("mka_fwd_kernel", "box_fwd_kernel", "mka_bwd_dq_kernel",
                    "mka_bwd_dkv_kernel", "box_bwd_dq_kernel",
                    "box_bucket_kernel", "box_bwd_dkv_kernel")


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
    window_ms, busy_ms, gam_by_kernel = _profile_step(step_fn, state, batch,
                                                      1e-5, gen)
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
    launches, ms_per_pair = timed("main_path", phase_main_path, device)
    timed("small_parity", phase_small_parity, device)
    bwd_results = timed("bwd_kernels", phase_backward_kernels, device)
    train_launches, ms_step = timed("training", phase_training, device)
    timed("train_parity", phase_train_parity, device)
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
