"""The plain reference of one depth-supervised training step, float32.

The supervision of the published depth trainer (PL_GeoFormer,
``lightning/lightning_depth_geoformer.py``, on MegaDepth batches laid out
by ``loftr_src/utils/dataset.py``) written out in plain torch, and the
step around it:

- ``warp_kpts``, the published one (``loftr/utils/geometry.py``): each
  keypoint's depth read at its nearest pixel, the point lifted through
  K0^-1, moved by T_0to1 and projected by K1 (+1e-4 on the denominator);
  valid where its depth is nonzero, it lands inside depth1's map (strictly
  between 0 and the size less one) and depth1 at its truncated position
  agrees with its z within 0.2 relative to depth1 there;
- the coarse GT (``loftr/utils/supervision.py`` spvs_coarse): both grids
  of cell corners, padded cells moved to the origin, scaled to the
  original resolution by ``scale`` and warped by depth both ways (their
  validity unused), back to cells of the other grid, rounded (half to
  even), off-grid to cell 0, kept where the round trip returns to the same
  cell; cell 0 never supervised;
- the fine labels (spvs_fine2): the 5x5 windows of 2-pixel steps around
  both matched cells at the original resolution, image 0's warped by
  depth, an invalid warp moved to -1e5 so that it is never positive; the
  window pair of least distance is positive when 0 < d <= 3 original
  pixels;
- the loss, the gradient and the AdamW step of reference/train.py
  (``focal_positive``, ``fine_bce``, ``AdamW``), on the forward of
  reference/model.py with the batch's masks.

As in reference/train.py, the step's discrete decisions (the coarse
matches of each pass) are the program's, read from its forward; all else
is recomputed.

Departures from the published code: each 3x3 product of the warp is
taken as nine float32 products and torch's sum over each row's three, as
the port computes it, and not as a matrix product. The rounding of a
warped point picks a cell, and a sum in another order (torch's sum of
three is (a0 + a2) + a1 on the card and (a0 + a1) + a2 on the CPU; a
matrix product has its own, and TF32) rounds some of the 6400 points of a
view differently, which moves a GT cell now and then; reference/model.
warp_points writes a homography's products as the port does for the same
reason. And a keypoint off depth0's map reads depth 0, where the
published indexing wraps round to the far end of the row: on the
published padded maps (and on these, 2000 x 2000 under 1280-pixel views)
that end is padding, whose depth is 0.
"""

from __future__ import annotations

import torch

from portbench.reference import model as ref
from portbench.reference.train import AdamW, fine_bce, focal_positive


def _apply(M, v):
    """M [B, 3, 3] on the points v [B, L, 3]: the nine products, then
    torch's sum of each row's three."""
    return (M[:, None] * v[:, :, None]).sum(-1)


def _at(depth, x, y):
    """depth [B, H, W] at integer pixels x, y [B, L]; 0 off the map."""
    h, w = depth.shape[1:]
    on = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    d = torch.gather(depth.reshape(depth.shape[0], -1), 1,
                     y.clamp(0, h - 1) * w + x.clamp(0, w - 1))
    return torch.where(on, d, torch.zeros_like(d))


def warp_kpts(kpts0, depth0, depth1, T_0to1, K0, K1):
    """(valid [B, L], warped [B, L, 2]) of pixels kpts0 [B, L, 2]."""
    r = torch.round(kpts0).long()
    d0 = _at(depth0, r[..., 0], r[..., 1])
    lifted = torch.stack([kpts0[..., 0] * d0, kpts0[..., 1] * d0, d0], -1)
    cam0 = _apply(torch.linalg.inv(K0), lifted)
    cam1 = _apply(T_0to1[:, :3, :3], cam0) + T_0to1[:, None, :3, 3]
    proj = _apply(K1, cam1)
    warped = proj[..., :2] / (proj[..., 2:] + 1e-4)
    h, w = depth1.shape[1:]
    covis = ((warped[..., 0] > 0) & (warped[..., 0] < w - 1)
             & (warped[..., 1] > 0) & (warped[..., 1] < h - 1))
    q = torch.where(covis[..., None], warped,
                    torch.zeros_like(warped)).long()
    d1 = _at(depth1, q[..., 0], q[..., 1])
    consistent = ((d1 - cam1[..., 2]) / d1).abs() < 0.2  # inf, nan: False
    return (d0 != 0) & covis & consistent, warped


def coarse_gt(batch, grid_hw):
    """(gt_j [B, L], gt_valid [B, L]) of a posed-RGBD batch."""
    h, w = grid_hw
    b, L = batch["depth0"].shape[0], h * w
    dev = batch["depth0"].device
    cells = ref.cell_coords(torch.arange(L, device=dev), w)
    g0 = cells[None] * batch["mask0"].reshape(b, L, 1)
    g1 = cells[None] * batch["mask1"].reshape(b, L, 1)
    s0, s1 = batch["scale0"][:, None], batch["scale1"][:, None]
    _, w0 = warp_kpts(g0 * s0, batch["depth0"], batch["depth1"],
                      batch["T_0to1"], batch["K0"], batch["K1"])
    _, w1 = warp_kpts(g1 * s1, batch["depth1"], batch["depth0"],
                      batch["T_1to0"], batch["K1"], batch["K0"])

    def nearest(pts):
        r = torch.round(pts).long()
        idx = r[..., 0] + r[..., 1] * w
        oob = (r[..., 0] < 0) | (r[..., 0] >= w) | (r[..., 1] < 0) \
            | (r[..., 1] >= h)
        return torch.where(oob, torch.zeros_like(idx), idx.clamp(0, L - 1))

    n1 = nearest(w0 / (ref.COARSE * s1))
    n0 = nearest(w1 / (ref.COARSE * s0))
    ok = torch.gather(n0, 1, n1) == torch.arange(L, device=dev)[None]
    ok[:, 0] = False
    return n1, ok


def fine_labels(i_ids, j_ids, batch, grid_w):
    """[B, M, 25, 25] in {0, 1}."""
    b, m = i_ids.shape
    r = ref.WINDOW // 2
    d = torch.arange(ref.WINDOW, device=i_ids.device)
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    off = torch.stack([gx.reshape(-1) - r, gy.reshape(-1) - r], -1).float() \
        * ref.FINE
    s0, s1 = batch["scale0"][:, None, None], batch["scale1"][:, None, None]
    k0 = (ref.cell_coords(i_ids, grid_w)[:, :, None] + off) * s0
    k1 = (ref.cell_coords(j_ids, grid_w)[:, :, None] + off) * s1
    ok, w0 = warp_kpts(k0.reshape(b, -1, 2), batch["depth0"],
                       batch["depth1"], batch["T_0to1"], batch["K0"],
                       batch["K1"])
    w0 = torch.where(ok[..., None], w0, torch.full_like(w0, -1e5))
    w0 = w0.reshape(b, m, -1, 2)
    dist = torch.sqrt(((w0[:, :, :, None] - k1[:, :, None]) ** 2).sum(-1))
    ww = dist.shape[-1]
    best = torch.nn.functional.one_hot(
        dist.reshape(b, m, -1).argmin(-1), ww * ww).reshape(b, m, ww, ww)
    return ((dist <= 3.0) & (dist > 0) & (best > 0)).float()


def loss(W, batch, prog, uniforms, cfg) -> torch.Tensor:
    """The step's loss from the batch, the program's matches of both
    passes and the step's RANSAC uniforms (reference/train.loss with the
    depth GT)."""
    P = W["params"]
    img0, img1 = batch["image0"][..., 0], batch["image1"][..., 0]
    b, H, Wd = img0.shape
    hw = (H // ref.COARSE, Wd // ref.COARSE)
    m0 = batch["mask0"].reshape(b, -1)
    m1 = batch["mask1"].reshape(b, -1)
    f = ref.features(W, img0, img1, m0, m1, train=True)
    with torch.no_grad():
        geo = ref.geometry(prog["m1_i"], prog["m1_j"], prog["m1_valid"], hw,
                           uniforms, cfg["geo"]["ransac_thr"],
                           cfg["geo"]["min_matches"])
        gt_j, gt_valid = coarse_gt(batch, hw)
        labels = fine_labels(prog["m2_i"], prog["m2_j"], batch, hw[1])
    g0, g1 = ref.gam(P, f.cnn0, f.cnn1, geo, cfg["geo"]["max_inliers"])
    fc = ref.fine_confidence(P, f.fine0, f.fine1, g0, g1, prog["m2_i"],
                             prog["m2_j"], hw[1])
    lc = focal_positive(g0, g1, gt_j, gt_valid, m0, m1)
    ld = focal_positive(f.f0, f.f1, gt_j, gt_valid, m0, m1)
    return lc + ld + fine_bce(fc, labels, prog["m2_valid"])


def steps(W, batches, progs, uniforms, cfg, lr: float):
    """Follow the program's first len(batches) depth steps. Returns (the
    losses, the first step's clipped gradient by leaf, the parameters by
    leaf at the start), as reference/train.steps."""
    P = W["params"]
    start = {k: v.clone() for k, v in P.items()}
    opt = AdamW(P, lr)
    losses, first = [], None
    for batch, prog, u in zip(batches, progs, uniforms):
        for v in P.values():
            v.requires_grad_(True)
            v.grad = None
        total = loss(W, batch, prog, u, cfg)
        grads = torch.autograd.grad(total, list(P.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g)
                 for (k, v), g in zip(P.items(), grads)}
        for v in P.values():
            v.requires_grad_(False)
        clipped = opt.step(grads)
        losses.append(float(total.detach()))
        if first is None:
            first = clipped
        del total, grads
    return losses, first, start
