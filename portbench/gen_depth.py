"""Posed-RGBD pairs made from the seed: textured-plane rooms rendered with
exact depth, laid out as the published MegaDepth loader lays out a pair.

The scene and the renderer are the mathematics of the port's
``data/planes.py`` (``room_scene`` with ``cluttered``: a back wall, a
floor, a side wall, a ceiling strip and two free-standing slabs with
jittered extents; a pinhole view composites the textured quads through
their plane-induced homographies with a z-buffer, a quad covering the
pixels whose texture position, rounded half to even, lies on it; depth is
the camera z of the point seen, 0 where no quad is seen), written here in
torch and run on the device; nothing of the port is imported. The
textures are ``portbench/gen.textures`` (multi-octave noise) and each view
gets ``gen.photometric``'s jitter.

A view is rendered at its original size, a longer edge of
``orig_long`` pixels in aspect 4:3 landscape, 3:4 portrait or 1:1 (of the
eight views of a batch of four pairs three are landscape, three portrait
and two square, in an order drawn from the seed), with a focal length of
0.8-1.2 times the longer edge and the principal point at the centre. As
``loftr_src/utils/dataset.py`` prepares a MegaDepth view, the grey image
is resized to a longer edge of ``pad`` (half the original: the mean of
each 2x2 block, which is what cv2.resize's bilinear rule gives at exactly
half), padded bottom-right to ``pad`` x ``pad`` with zeros, with the mask
of its /8 cells and ``scale`` = original / resized (2, 2); depth stays at
the original resolution, padded bottom-right with zeros to ``depth_pad``
squared; K is the original view's.

A pair is two views of one room: camera 0 at the room's front looking at
its back wall, camera 1 turned from it by 5-30 degrees and moved by
0.2-1.5 units (mostly level). The turn's axis is drawn on the sphere in
camera 0's frame with its part along the optical axis scaled by 0.2: the
turn is mostly a pan and a tilt, with a little roll, as between two
upright photographs of one building. A pair is kept only if its
overlap score is at least ``min_overlap`` (the published
``min_overlap_score``, 0.4): the smaller, over its two views, of the share
of a view's pixels with depth (sampled every 1/80 of its longer edge)
whose point is seen by the other view: it projects inside that view and
the depth that view sees there, cast exactly, is within 0.2 of the point's
own (relative). Rejected cameras are drawn again.

Scene and camera numbers come from a CPU generator in float64, the
textures and the noise from a generator on the device; geometry runs in
float64, and depth, K and poses are handed over in float32. The same seed
gives the same batches.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench import gen

TEX_HW = (384, 512)
ASPECTS = ((3, 4), (4, 3), (1, 1))      # (h, w): landscape, portrait, square
BATCH_ASPECTS = (0, 0, 0, 1, 1, 1, 2, 2)
ROT_DEG = (5.0, 30.0)
ROLL = 0.2                # the turn axis's part along the optical axis
BASELINE = (0.2, 1.5)
FOCAL = (0.8, 1.2)
CANDIDATES = 16
ROUNDS = 64


def _u(g, lo, hi, *shape):
    return lo + (hi - lo) * torch.rand(shape or (1,), generator=g,
                                       dtype=torch.float64)


def room(g: torch.Generator) -> Dict[str, torch.Tensor]:
    """One room of six quads (origin, e1, e2: [6, 3] float64)."""
    zb = 8.0 * float(_u(g, 0.85, 1.15))
    side = 4.5 if float(_u(g, 0, 1)) < 0.5 else -4.5
    o, e1, e2 = [], [], []

    def quad(a, b, c):
        o.append(a)
        e1.append(b)
        e2.append(c)

    quad([-5.0, -3.0, zb], [10.0, 0, 0], [0, 6.0, 0])                # back
    quad([-5.0, float(_u(g, 1.8, 2.5)), 2.0], [10.0, 0, 0],
         [0, float(_u(g, 0.8, 1.5)), zb - 2.0])                      # floor
    quad([side, -3.0, 2.0], [0, 0, zb - 2.0], [0, 6.0, 0])           # side
    quad([-5.0, float(_u(g, -3.0, -2.2)), 2.5], [10.0, 0, 0],
         [0, float(_u(g, -0.8, -0.2)), zb - 2.5])                    # ceiling
    for _ in range(2):                                               # slabs
        cx = float(_u(g, -2.5, 2.5))
        zc = zb * float(_u(g, 0.42, 0.75))
        quad([cx - 1.2, float(_u(g, -1.2, 0.6)), zc],
             [float(_u(g, 2.0, 3.0)), 0, float(_u(g, -0.8, 0.8))],
             [float(_u(g, -0.4, 0.4)), float(_u(g, 1.8, 2.6)), 0])
    t = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    return {"origin": t(o), "e1": t(e1), "e2": t(e2), "zb": zb}


def look_at(center: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """World->camera rotation [3, 3] of a camera at ``center`` looking at
    ``target``, image y along world +y (planes.look_at's up of -y)."""
    z = target - center
    z = z / z.norm()
    x = torch.linalg.cross(torch.tensor([0.0, -1.0, 0.0],
                                        dtype=torch.float64), z)
    x = x / x.norm()
    return torch.stack([x, torch.linalg.cross(z, x), z])


def axis_angle(axis: torch.Tensor, angle: float) -> torch.Tensor:
    """Rotation [3, 3] by ``angle`` radians about the unit ``axis``."""
    k = torch.zeros((3, 3), dtype=torch.float64)
    k[0, 1], k[0, 2], k[1, 2] = -axis[2], axis[1], -axis[0]
    k = k - k.T
    return (torch.eye(3, dtype=torch.float64) + math.sin(angle) * k
            + (1 - math.cos(angle)) * k @ k)


def pose(R: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """World->camera [4, 4] of rotation R and centre c."""
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :3] = R
    T[:3, 3] = -R @ c
    return T


def intrinsics(g, hw) -> torch.Tensor:
    h, w = hw
    f = max(h, w) * float(_u(g, *FOCAL))
    return torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                        dtype=torch.float64)


def cast(scene, K, T, pts) -> Tuple[torch.Tensor, ...]:
    """What each camera sees at its pixels: K, T [C, 3, 3], [C, 4, 4];
    pts [C, N, 2] float64 (x, y) on the scene's device. Returns (depth
    [C, N], 0 where no quad is seen; the quad seen [C, N], -1 for none;
    its texture position s, t [C, N] in texture pixels)."""
    dev = pts.device
    o, e1, e2 = (scene[k].to(dev) for k in ("origin", "e1", "e2"))
    th, tw = TEX_HW
    R, t = T[:, :3, :3].to(dev), T[:, :3, 3].to(dev)
    # image <- texture homography of each quad [C, P, 3, 3], planes.py's
    cols = torch.stack([e1 / (tw - 1), e2 / (th - 1), o], -1)       # [P,3,3]
    M = R[:, None] @ cols[None]
    M[..., 2] += t[:, None]
    Hinv = torch.linalg.inv(K.to(dev)[:, None] @ M)
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)        # [C,N,3]
    uvw = torch.einsum("cpij,cnj->cpni", Hinv, p)
    s = uvw[..., 0] / uvw[..., 2]
    tt = uvw[..., 1] / uvw[..., 2]
    cover = ((torch.round(s) >= 0) & (torch.round(s) < tw)
             & (torch.round(tt) >= 0) & (torch.round(tt) < th))
    # camera z of the quad's point at (s, t): affine in (s, t)
    zrow = torch.einsum("ci,pik->cpk", R[:, 2], cols)             # [C,P,3]
    z = (zrow[..., 0, None] * s + zrow[..., 1, None] * tt
         + zrow[..., 2, None] + t[:, 2, None, None])
    z = torch.where(cover & torch.isfinite(z) & (z > 0.1), z,
                    torch.full_like(z, math.inf))
    depth, which = z.min(1)
    seen = torch.isfinite(depth)
    pick = which[:, None]
    return (torch.where(seen, depth, torch.zeros_like(depth)),
            torch.where(seen, which, torch.full_like(which, -1)),
            torch.gather(s, 1, pick)[:, 0], torch.gather(tt, 1, pick)[:, 0])


def _project(K, T_ab, X):
    """Camera-a points X [C, N, 3] into camera b: (pixels [C, N, 2],
    z [C, N])."""
    Xb = X @ T_ab[:, :3, :3].transpose(1, 2) + T_ab[:, None, :3, 3]
    p = Xb @ K.transpose(1, 2)
    return p[..., :2] / p[..., 2:], Xb[..., 2]


def _lift(K, pts, depth):
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    return (p @ torch.linalg.inv(K).transpose(1, 2)) * depth[..., None]


def overlap(scene, views, device) -> torch.Tensor:
    """Overlap score [C] of candidate pairs: ``views`` is a pair (K [C, 3,
    3], T [C, 4, 4], hw) per view, the two in order (module docstring)."""
    out = []
    for a, b in ((0, 1), (1, 0)):
        Ka, Ta, (ha, wa) = views[a]
        Kb, Tb, (hb, wb) = views[b]
        step = max(ha, wa) / 80.0
        ys, xs = torch.meshgrid(
            torch.arange(step / 2, ha, step, dtype=torch.float64),
            torch.arange(step / 2, wa, step, dtype=torch.float64),
            indexing="ij")
        pts = torch.stack([xs, ys], -1).reshape(1, -1, 2).to(device)
        pts = pts.expand(Ka.shape[0], -1, -1)
        da = cast(scene, Ka, Ta, pts)[0]
        T_ab = (Tb @ torch.linalg.inv(Ta)).to(device)
        q, zb = _project(Kb.to(device), T_ab, _lift(Ka.to(device), pts, da))
        inside = ((q[..., 0] > 0) & (q[..., 0] < wb - 1) & (q[..., 1] > 0)
                  & (q[..., 1] < hb - 1) & (zb > 0))
        q = torch.where(inside[..., None], q, torch.zeros_like(q))
        db = cast(scene, Kb, Tb, q)[0]
        seen = inside & (db > 0) & ((db - zb).abs() < 0.2 * db)
        has = (da > 0).sum(-1).clamp(min=1)
        out.append(((seen & (da > 0)).sum(-1) / has).float())
    return torch.minimum(out[0], out[1])


def render(scene, textures, K, T, hw, device) -> Tuple[torch.Tensor, ...]:
    """(image [h, w] in [0, 1], depth [h, w] float32) of one view;
    ``textures`` [6, th, tw] on the device."""
    h, w = hw
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64,
                                         device=device),
                            torch.arange(w, dtype=torch.float64,
                                         device=device), indexing="ij")
    pts = torch.stack([xs, ys], -1).reshape(1, -1, 2)
    depth, which, s, t = cast(scene, K[None], T[None], pts)
    th, tw = TEX_HW
    grid = torch.stack([2 * s / (tw - 1) - 1, 2 * t / (th - 1) - 1],
                       -1).float()                                 # [1, N, 2]
    grid = grid.expand(textures.shape[0], -1, -1)[:, None]
    vals = F.grid_sample(textures[:, None], grid, align_corners=True,
                         padding_mode="border")[:, 0, 0]           # [P, N]
    img = torch.gather(vals, 0, which.clamp(min=0))[0]
    img = torch.where(which[0] >= 0, img, torch.zeros_like(img))
    return (img.reshape(h, w).clamp(0, 1),
            depth[0].reshape(h, w).float())


def cameras(g, scene, sizes, min_overlap: float, device):
    """(K0, T0, K1, T1) float64 of one pair whose overlap score is at
    least ``min_overlap``, and that score: candidates drawn CANDIDATES at
    a time, the first that passes kept."""
    zb = scene["zb"]
    for _ in range(ROUNDS):
        cand = []
        for _ in range(CANDIDATES):
            c0 = torch.cat([_u(g, -1, 1), _u(g, -0.4, 0.4), _u(g, -0.5, 0.5)])
            tgt = torch.cat([_u(g, -1.5, 1.5), _u(g, -0.8, 0.8),
                             torch.tensor([zb], dtype=torch.float64)])
            R0 = look_at(c0, tgt)
            axis = torch.randn(3, generator=g, dtype=torch.float64)
            axis[2] *= ROLL
            angle = math.radians(float(_u(g, *ROT_DEG)))
            R1 = axis_angle(axis / axis.norm(), angle) @ R0
            step = torch.randn(3, generator=g, dtype=torch.float64)
            step[1] *= 0.3                        # mostly level moves
            c1 = c0 + step / step.norm() * float(_u(g, *BASELINE))
            cand.append((intrinsics(g, sizes[0]), pose(R0, c0),
                         intrinsics(g, sizes[1]), pose(R1, c1)))
        K0, T0, K1, T1 = (torch.stack(x) for x in zip(*cand))
        score = overlap(scene, ((K0, T0, sizes[0]), (K1, T1, sizes[1])),
                        device)
        ok = (score >= min_overlap).nonzero()
        if len(ok):
            k = int(ok[0, 0])
            return K0[k], T0[k], K1[k], T1[k], float(score[k])
    raise RuntimeError("no camera pair reached the overlap score")


def _prepare(img, depth, pad, depth_pad):
    """The published loader's layout of one view: (image [pad, pad],
    mask [pad/8, pad/8], depth [depth_pad, depth_pad], scale [2])."""
    h, w = img.shape
    r = F.avg_pool2d(img[None, None], 2)[0, 0]
    hr, wr = r.shape
    out = torch.zeros((pad, pad), device=img.device)
    out[:hr, :wr] = r
    mask = torch.zeros((pad // 8, pad // 8), device=img.device)
    mask[:hr // 8, :wr // 8] = 1.0
    d = torch.zeros((depth_pad, depth_pad), device=img.device)
    d[:h, :w] = depth
    scale = torch.tensor([w / wr, h / hr], device=img.device)
    return out, mask, d, scale


def depth_batches(seed: int, n: int, batch: int, orig_long: int, pad: int,
                  depth_pad: int, device,
                  min_overlap: float = 0.4) -> List[Dict[str, torch.Tensor]]:
    """n batches of ``batch`` posed-RGBD pairs on ``device``: image0/1
    [B, pad, pad, 1], mask0/1 [B, pad/8, pad/8], depth0/1 [B, depth_pad,
    depth_pad], K0/K1 [B, 3, 3], T_0to1/T_1to0 [B, 4, 4], scale0/1 [B, 2],
    all float32; plus ``overlap`` [B], each pair's score."""
    if orig_long != 2 * pad or depth_pad < orig_long:
        raise ValueError(f"views of {orig_long} pixels need an input of half "
                         f"that ({pad} given) and a depth pad of at least "
                         f"{orig_long} ({depth_pad} given)")
    g = torch.Generator().manual_seed(int(seed))
    dgen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [(orig_long * a // max(a, b), orig_long * b // max(a, b))
             for a, b in ASPECTS]
    out = []
    for _ in range(n):
        order = torch.randperm(2 * batch, generator=g).tolist()
        aspects = [BATCH_ASPECTS[k % len(BATCH_ASPECTS)] for k in order]
        keys = ("image", "mask", "depth", "scale", "K", "T")
        views = {k + str(v): [] for k in keys for v in (0, 1)}
        rel = {"T_0to1": [], "T_1to0": [], "overlap": []}
        for p in range(batch):
            scene = room(g)
            hw = [sizes[aspects[2 * p]], sizes[aspects[2 * p + 1]]]
            K0, T0, K1, T1, score = cameras(g, scene, hw, min_overlap,
                                            device)
            tex = gen.textures(6, TEX_HW, dgen, device)
            for v, (K, T) in enumerate(((K0, T0), (K1, T1))):
                img, depth = render(scene, tex, K, T, hw[v], device)
                img = gen.photometric(img[None], dgen, g)[0]
                im, m, d, s = _prepare(img, depth, pad, depth_pad)
                for k, x in zip(keys, (im, m, d, s, K, T)):
                    views[k + str(v)].append(x)
            rel["T_0to1"].append(T1 @ torch.linalg.inv(T0))
            rel["T_1to0"].append(T0 @ torch.linalg.inv(T1))
            rel["overlap"].append(score)
        f32 = lambda xs: torch.stack(xs).float().to(device)  # noqa: E731
        b = {"image0": f32(views["image0"])[..., None],
             "image1": f32(views["image1"])[..., None],
             "mask0": f32(views["mask0"]), "mask1": f32(views["mask1"]),
             "depth0": f32(views["depth0"]), "depth1": f32(views["depth1"]),
             "K0": f32(views["K0"]), "K1": f32(views["K1"]),
             "scale0": f32(views["scale0"]), "scale1": f32(views["scale1"]),
             "T_0to1": f32(rel["T_0to1"]), "T_1to0": f32(rel["T_1to0"]),
             "overlap": torch.tensor(rel["overlap"], device=device)}
        out.append(b)
    return out
