"""The plain reference of one homography training step, float32.

Supervision, loss and update of the published recipe, written out in
plain torch with autograd: the coarse ground truth of a pair under its
known homography (each coarse cell's corner point warped into the other
image and rounded to the nearest cell, kept where the round trip returns
to the same cell; cell 0 never supervised), the fine labels (the 5x5
windows of 2-pixel steps around both matched cells, image 0's warped
through H; the closest window pair is positive when 0 < d <= 3 px), the
focal loss on the positive cells of the dual-softmax confidence before and
after the GAM (alpha 0.25, gamma 2), the binary cross-entropy of the fine
confidence over the matched slots, then the global-norm clip to 0.5 and
AdamW (betas 0.9, 0.999, eps 1e-8 outside the square root, decoupled
weight decay 0.1 on every parameter).

The step's discrete decisions (which cells match in each coarse pass) are
the program's, read from its forward: the reference follows the program
step by step from them and recomputes all else: features with the batch's
BatchNorm statistics, the RANSAC fit from the step's uniforms, the GAM,
the fine confidence, the labels, the loss, the gradient and the update.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import model as ref


def coarse_gt(H_0to1, H_1to0, grid_hw, mask0, mask1):
    """(gt_j [B, L], gt_valid [B, L]): the cycle-consistent coarse GT."""
    h, w = grid_hw
    b, L = H_0to1.shape[0], h * w
    cells = ref.cell_coords(torch.arange(L, device=H_0to1.device), w)
    g0 = cells[None] * mask0.reshape(b, L, 1)
    g1 = cells[None] * mask1.reshape(b, L, 1)

    def nearest(pts):
        r = torch.round(pts).long()
        idx = r[..., 0] + r[..., 1] * w
        oob = (r[..., 0] < 0) | (r[..., 0] >= w) | (r[..., 1] < 0) \
            | (r[..., 1] >= h)
        return torch.where(oob, torch.zeros_like(idx), idx.clamp(0, L - 1))

    n1 = nearest(ref.warp_points(g0, H_0to1) / ref.COARSE)
    n0 = nearest(ref.warp_points(g1, H_1to0) / ref.COARSE)
    ok = torch.gather(n0, 1, n1) == torch.arange(L, device=n1.device)[None]
    ok[:, 0] = False
    return n1, ok


def fine_labels(i_ids, j_ids, H_0to1, grid_w):
    """[B, M, 25, 25] in {0, 1}: the window pair of least distance, when
    0 < d <= 3 px."""
    b, m = i_ids.shape
    r = ref.WINDOW // 2
    d = torch.arange(ref.WINDOW, device=i_ids.device)
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    off = torch.stack([gx.reshape(-1) - r, gy.reshape(-1) - r], -1).float() \
        * ref.FINE
    k0 = ref.cell_coords(i_ids, grid_w)[:, :, None] + off
    k1 = ref.cell_coords(j_ids, grid_w)[:, :, None] + off
    w0 = ref.warp_points(k0.reshape(b, -1, 2), H_0to1).reshape(b, m, -1, 2)
    dist = torch.sqrt(((w0[:, :, :, None] - k1[:, :, None]) ** 2).sum(-1))
    ww = dist.shape[-1]
    best = torch.nn.functional.one_hot(
        dist.reshape(b, m, -1).argmin(-1), ww * ww).reshape(b, m, ww, ww)
    return ((dist <= 3.0) & (dist > 0) & (best > 0)).float()


def focal_positive(f0, f1, gt_j, gt_valid, mask0, mask1, alpha=0.25,
                   gamma=2.0):
    """Mean focal loss of the dual-softmax confidence at the GT cells."""
    conf = ref.dual_softmax(f0, f1, 0.1, mask0, mask1)
    b = conf.shape[0]
    c = conf[torch.arange(b, device=conf.device)[:, None],
             torch.arange(conf.shape[1], device=conf.device)[None], gt_j]
    c = torch.clamp(c, 1e-6, 1 - 1e-6)
    ok = gt_valid & (mask0 > 0) & (torch.gather(mask1, 1, gt_j) > 0)
    lp = -alpha * (1 - c) ** gamma * torch.log(c)
    w = ok.float()
    return (lp * w).sum() / torch.clamp(w.sum(), min=1.0)


def fine_bce(fc, labels, valid):
    conf = torch.clamp(fc, 1e-6, 1 - 1e-6)
    v = valid[:, :, None, None]
    out = 0.0
    for half, x in (((labels == 1) & v, -torch.log(conf)),
                    ((labels == 0) & v, -torch.log(1 - conf))):
        n = half.float().sum()
        mean = (x * half.float()).sum() / torch.clamp(n, min=1.0)
        out = out + torch.where(n > 0, mean, torch.zeros_like(mean))
    return out


def loss(W, batch, prog, uniforms, cfg) -> torch.Tensor:
    """The step's loss from the batch, the program's matches of both
    passes (prog: m1_i, m1_j, m1_valid, m2_i, m2_j, m2_valid) and the
    step's RANSAC uniforms."""
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
        gt_j, gt_valid = coarse_gt(batch["H_0to1"], batch["H_1to0"], hw,
                                   batch["mask0"], batch["mask1"])
        labels = fine_labels(prog["m2_i"], prog["m2_j"], batch["H_0to1"],
                             hw[1])
    g0, g1 = ref.gam(P, f.cnn0, f.cnn1, geo, cfg["geo"]["max_inliers"])
    fc = ref.fine_confidence(P, f.fine0, f.fine1, g0, g1, prog["m2_i"],
                             prog["m2_j"], hw[1])
    lc = focal_positive(g0, g1, gt_j, gt_valid, m0, m1)
    ld = focal_positive(f.f0, f.f1, gt_j, gt_valid, m0, m1)
    return lc + ld + fine_bce(fc, labels, prog["m2_valid"])


class AdamW:
    """torch's AdamW arithmetic written out, with optax's global-norm
    clip before it."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 clip: float = 0.5, wd: float = 0.1, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.p = params
        self.lr, self.clip, self.wd, self.betas, self.eps = \
            lr, clip, wd, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        clipped = {}
        for k, p in self.p.items():
            g = grads[k] * scale
            clipped[k] = g
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.sub_(self.lr / c1 * self.m[k] / denom)
        return clipped


def steps(W, batches, progs, uniforms, cfg, lr: float):
    """Follow the program's first len(batches) steps. Returns (the losses,
    the first step's clipped gradient by leaf, the parameters by leaf at
    the start)."""
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
