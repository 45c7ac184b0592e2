"""Operations and bytes, counted from shapes and the run's own inputs.

The peaks are one NVIDIA H100 SXM's published dense rates (NVIDIA's data
sheet, at the full 700 W): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 on
the CUDA cores (the rate of float32 work with TF32 off), 495 TFLOP/s in
TF32, 3.35 TB/s of HBM. The GAM kernels' float32 products of K2 and K3
run as three TF32 products each on the tensor cores (495 / 3 TFLOP/s).

Kernel bounds (copied from the repository's chip_smoke.py, where each was
checked against the kernels' plain versions): the larger of the bytes the
call must read and write once over the memory rate, and the operations its
inputs need over the peak of its path; ``bound`` says which of the two
binds. K1 and K4/K5 count the in-grid cells of each query's 5x5 box, K2
and K3 the live keys of each image's inlier set.

Model operations (``forward_flops``) count each multiply-add as two
operations, once, from the configuration's shapes and the run's match and
inlier counts: convolutions, linear layers, the attention products and the
similarity products of the two coarse matchings; elementwise work, norms
and softmaxes are left out. The streamed matcher computes each similarity
tile twice (its LSE pass and its argmax pass): counted once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12,
              "3xtf32": 495e12 / 3}
HEADS, HEAD_DIM = 4, 64          # the GAM's 256 channels
GAM_KERNEL_NAMES = ("mka_fwd_kernel", "box_fwd_kernel", "mka_bwd_dq_kernel",
                    "mka_bwd_dkv_kernel", "mka_bwd_sum_kernel",
                    "box_bwd_dq_kernel", "gather_count_kernel",
                    "gather_fill_kernel", "box_count_kernel",
                    "box_plan_kernel", "box_fill_kernel",
                    "box_bwd_dkv_kernel", "box_dkv_sum_kernel")


def bound_ms(nbytes: float, flops: float, peak: float) -> Tuple[float, str]:
    """(the least time in ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def box_cells(centers: torch.Tensor, grid_hw, r: int = 2) -> float:
    """In-grid cells summed over all (batch, query) boxes of half-width r
    around ``centers`` [..., 2] (x, y cell indices)."""
    hg, wg = grid_hw
    cx, cy = centers[..., 0].long(), centers[..., 1].long()
    nx = torch.clamp(cx + r, max=wg - 1) - torch.clamp(cx - r, min=0) + 1
    ny = torch.clamp(cy + r, max=hg - 1) - torch.clamp(cy - r, min=0) + 1
    return float((nx.clamp(min=0) * ny.clamp(min=0)).sum())


def box_centers(H: torch.Tensor, grid_hw, scale: int = 8) -> torch.Tensor:
    """[B, L, 2] destination cells of each source cell's corner point
    warped through H [B, 3, 3] (K1's centres)."""
    h, w = grid_hw
    ids = torch.arange(h * w, device=H.device)
    p = torch.stack([(ids % w) * scale, (ids // w) * scale], -1).float()
    x, y = p[:, 0], p[:, 1]
    Hh = H[:, None]
    u = Hh[..., 0, 0] * x + Hh[..., 0, 1] * y + Hh[..., 0, 2]
    v = Hh[..., 1, 0] * x + Hh[..., 1, 1] * y + Hh[..., 1, 2]
    d = Hh[..., 2, 0] * x + Hh[..., 2, 1] * y + Hh[..., 2, 2]
    d = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    warped = torch.stack([u / d, v / d], -1)
    return torch.floor(warped.clamp(-1e6, 1e6) / scale)


def gam_geometry(H, has_H, map0, map1, max_inliers: int, grid_hw):
    """What the GAM kernels' work depends on, from a forward's RANSAC
    state: (centres image 0 -> 1, centres 1 -> 0, live keys of image 0 and
    of image 1 per pair)."""
    eye = torch.eye(3, device=H.device, dtype=H.dtype)
    Hs = torch.where(has_H[:, None, None], H, eye)
    c1 = box_centers(Hs, grid_hw)
    c0 = box_centers(torch.linalg.inv_ex(Hs)[0], grid_hw)
    n0 = map0.sum(-1).clamp(max=max_inliers).double()
    n1 = map1.sum(-1).clamp(max=max_inliers).double()
    return c1, c0, n0, n1


def gam_kernel_bounds(geo, grid_hw, max_inliers: int, act_bytes: int,
                      f32_path: bool, backward: bool) -> Dict[str, float]:
    """Bound ms of one forward's (and with ``backward``, one train step's)
    GAM kernel launches, summed by kernel: K1 and K2 four launches each
    (two layers, two images or directions); K3, K4, K5 four each.
    ``geo`` is gam_geometry's tuple; ``act_bytes`` the element size of
    q, k, v."""
    c1, c0, n0, n1 = geo
    b, l = c1.shape[:2]
    hd = HEADS * HEAD_DIM
    qn = b * l * hd                       # q numel (= k, v over the grid)
    kvn = b * max_inliers * hd            # K2/K3's gathered k, v
    lse = b * l * HEADS
    peak_box = PEAK_FLOPS["f32"] if f32_path else PEAK_FLOPS["bf16"]
    peak_mka = PEAK_FLOPS["3xtf32"] if f32_path else PEAK_FLOPS["bf16"]
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0.0)
    for cen in (c1, c0):
        cells = box_cells(cen, grid_hw)
        cen_b = cen.numel() * 4
        out["K1"] += 2 * bound_ms(4 * qn * act_bytes + cen_b + lse * 4,
                                  4.0 * hd * cells, peak_box)[0]
        if backward:
            out["K5"] += 2 * bound_ms(
                3 * qn * act_bytes + 2 * qn * 4 + cen_b + 2 * lse * 4,
                6.0 * hd * cells, peak_box)[0]
            out["K4"] += 2 * bound_ms(
                3 * qn * act_bytes + 3 * qn * 4 + cen_b + 2 * lse * 4,
                8.0 * hd * cells, peak_box)[0]
    for n in (n0, n1):
        mask_b = b * max_inliers
        dead = float((n == 0).sum())
        flops = float((4.0 * hd * l * n).sum()) + dead * max_inliers * hd
        out["K2"] += 2 * bound_ms((qn + 2 * kvn) * act_bytes + mask_b
                                  + qn * 4, flops, peak_mka)[0]
        if backward:
            flops = float((10.0 * hd * l * n).sum()) + 2.0 * hd * l * dead
            out["K3"] += 2 * bound_ms(2 * (qn + 2 * kvn) * act_bytes + mask_b
                                      + qn * 4, flops, peak_mka)[0]
    return out


# ------------------------------------------------------- model FLOPs -----

def _conv(hw, cin, cout, k, stride=1):
    h, w = hw[0] // stride, hw[1] // stride
    return 2.0 * h * w * cin * cout * k * k, (h, w)


def backbone_flops(hw, initial=128, dims=(128, 196, 256)) -> float:
    """One image through ResNet-FPN (8, 2)."""
    d1, d2, d3 = dims
    total = 0.0
    f, s2 = _conv(hw, 1, initial, 7, 2)
    total += f
    cin = initial
    sizes = {}
    hw_ = s2
    for stage, (d, stride) in enumerate(((d1, 1), (d2, 2), (d3, 2)), 1):
        f, hw_o = _conv(hw_, cin, d, 3, stride)       # block 0, conv1
        total += f + _conv(hw_o, d, d, 3)[0]          # conv2
        if stride != 1:
            total += _conv(hw_, cin, d, 1, stride)[0]  # conv_down
        total += 2 * _conv(hw_o, d, d, 3)[0]          # block 1
        sizes[stage] = hw_o
        hw_, cin = hw_o, d
    total += _conv(sizes[3], d3, d3, 1)[0]            # l3_out
    total += _conv(sizes[2], d2, d3, 1)[0]            # l2_out
    total += _conv(sizes[2], d3, d3, 3)[0]            # l2_m1
    total += _conv(sizes[2], d3, d2, 3)[0]            # l2_m2
    total += _conv(sizes[1], d1, d2, 1)[0]            # l1_out
    total += _conv(sizes[1], d2, d2, 3)[0]            # l1_m1
    total += _conv(sizes[1], d2, d1, 3)[0]            # l1_m2
    return total


def encoder_proj_flops(n_q: int, n_kv: int, d: int) -> float:
    """Projections, merge and the concat MLP of one encoder layer."""
    return (2.0 * n_q * d * d * 2          # q, merge
            + 2.0 * n_kv * d * d * 2       # k, v
            + 2.0 * n_q * (2 * d) * (2 * d) + 2.0 * n_q * (2 * d) * d)


def linear_attention_flops(n_q: int, n_kv: int, d: int, nhead: int) -> float:
    dh = d // nhead
    return 2.0 * n_kv * d * dh + 2.0 * n_q * d * dh + 2.0 * n_q * d


def forward_flops(hw, grid_hw, counts: Dict[str, float],
                  max_inliers: int) -> float:
    """One pair's forward. ``counts`` holds the pair's live keys of the GAM
    self layers ("keys0", "keys1"), in-grid window cells of its cross
    layers ("cells1" for image 0's queries, "cells0"), and its coarse
    matches of the second pass ("matches", the fine stage's windows)."""
    d, dc_f, L = 256, 128, grid_hw[0] * grid_hw[1]
    total = 2 * backbone_flops(hw)
    # coarse transformer: 4 self + 4 cross layers, each over both images
    total += 8 * 2 * (encoder_proj_flops(L, L, d)
                      + linear_attention_flops(L, L, d, 8))
    total += 2 * 2.0 * L * L * d                       # two matchings
    # GAM: 2 self layers (k, v over the gathered capacity slots), 2 cross
    # layers (k, v projected over the whole source grid)
    for img in ("0", "1"):
        total += 2 * (encoder_proj_flops(L, max_inliers, d)
                      + 4.0 * L * counts["keys" + img] * d)
        total += 2 * (encoder_proj_flops(L, L, d)
                      + 4.0 * counts["cells" + img] * d)
    # fine: per match, both windows fused with the coarse feature, then one
    # self and one cross layer over 25 tokens, and the 25x25 similarity
    m, ww = counts["matches"], 25
    per = 2 * (2.0 * d * dc_f + 2.0 * ww * (2 * dc_f) * dc_f)
    per += 2 * 2 * (encoder_proj_flops(ww, ww, dc_f)
                    + linear_attention_flops(ww, ww, dc_f, 8))
    per += 2.0 * ww * ww * dc_f
    return total + m * per


def backward_flops(hw, grid_hw, counts, max_inliers: int) -> float:
    """One pair's backward, twice its forward's products (the input
    gradient and the weight gradient of each), less the stem's input
    gradient (the images take none)."""
    stem = 2.0 * (hw[0] // 2) * (hw[1] // 2) * 1 * 128 * 49
    return 2 * forward_flops(hw, grid_hw, counts, max_inliers) - 2 * stem


def loss_flops(grid_hw, d: int = 256) -> float:
    """The streamed loss's similarity products of one pair, before and
    after the GAM (each chunk's tile once; the recomputation under the
    checkpoint is not counted)."""
    L = grid_hw[0] * grid_hw[1]
    return 2 * 2.0 * L * L * d


def work(outs, hw, geo_cfg, use_bf16: bool, backward: bool) -> Dict:
    """Model operations and the GAM kernels' bound (ms) of the forwards
    whose outputs ``outs`` hold (H, has_H, map0, map1, m2_valid, one dict a
    call): a forward each, or with ``backward`` a train step each (the
    backward and the loss's similarity products too)."""
    grid = (hw[0] // 8, hw[1] // 8)
    flops, bound = 0.0, 0.0
    for o in outs:
        geo = gam_geometry(o["H"], o["has_H"], o["map0"], o["map1"],
                           geo_cfg.max_inliers, grid)
        bound += sum(gam_kernel_bounds(
            geo, grid, geo_cfg.max_inliers, 2 if use_bf16 else 4,
            not use_bf16, backward=backward).values())
        c1, c0, n0, n1 = geo
        nm = o["m2_valid"].sum(-1)
        for p in range(c1.shape[0]):
            c = {"keys0": float(n0[p]), "keys1": float(n1[p]),
                 "cells1": box_cells(c1[p], grid),
                 "cells0": box_cells(c0[p], grid),
                 "matches": float(nm[p])}
            flops += forward_flops(hw, grid, c, geo_cfg.max_inliers)
            if backward:
                flops += backward_flops(hw, grid, c, geo_cfg.max_inliers)
                flops += 3 * loss_flops(grid)
    return {"flops": flops, "gam_bound_ms": bound,
            "peak_flops": PEAK_FLOPS["bf16" if use_bf16 else "f32"]}
