"""The plain reference of the GeoFormer forward, float32, written out.

Plain torch operations only: no kernel, no cache, no batching trick, and
nothing of the measured program. It follows the published model (ResNet-FPN
to 1/8 and 1/2, sine position encoding with the released checkpoints'
frequency schedule, four (self, cross) LoFTR layers of linear attention,
dual-softmax matching, batched RANSAC, the geometrized attention module of
two (self, cross) pairs over RANSAC inliers and 5x5 homography windows, the
fine 5x5 window stage with one (self, cross) pair, and its dual-softmax
decode). Its parameters are the released checkpoint's arrays under their
own names and layouts (HWIO convolution kernels, [in, out] dense kernels),
read here from the ``.npz`` file.

Every stage is a function of its own, so that a check can run the stages
one by one and judge at each decision what the program chose there. Set
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.
allow_tf32`` to False before calling it on a card: on an H100 a float32
product otherwise runs in TF32.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

COARSE, FINE, WINDOW = 8, 2, 5


def load_params(path: str, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"params": {...}, "stats": {...}}: the checkpoint's float arrays as
    float32 tensors on ``device``, under their names without the
    collection prefix ("backbone/conv1/kernel")."""
    out = {"params": {}, "stats": {}}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            col, _, name = key.partition("/")
            if col == "params":
                out["params"][name] = torch.from_numpy(
                    np.asarray(z[key], np.float32)).to(device)
            elif col == "batch_stats":
                out["stats"][name] = torch.from_numpy(
                    np.asarray(z[key], np.float32)).to(device)
    return out


# ----------------------------------------------------------- backbone -----

def _conv(P, name, x, stride=1):
    k = P[f"{name}/kernel"]                        # [kh, kw, in, out]
    return F.conv2d(x, k.permute(3, 2, 0, 1), stride=stride,
                    padding=k.shape[0] // 2)


def _bn(W, name, x, train: bool):
    """BatchNorm, eps 1e-5: running statistics, or (train) the batch's
    mean and biased variance over (N, H, W)."""
    P, S = W["params"], W["stats"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0)
    else:
        mean, var = S[f"{name}/mean"], S[f"{name}/var"]
    inv = torch.rsqrt(var + 1e-5) * P[f"{name}/scale"]
    return (x - mean[:, None, None]) * inv[:, None, None] \
        + P[f"{name}/bias"][:, None, None]


def _block(W, name, x, stride, train):
    P = W["params"]
    y = F.relu(_bn(W, f"{name}/bn1", _conv(P, f"{name}/conv1", x, stride),
                   train))
    y = _bn(W, f"{name}/bn2", _conv(P, f"{name}/conv2", y), train)
    if stride != 1:
        x = _bn(W, f"{name}/bn_down", _conv(P, f"{name}/conv_down", x,
                                             stride), train)
    return F.relu(x + y)


def backbone(W, images, train: bool = False):
    """images [N, H, W] in [0, 1] -> (coarse [N, H/8, W/8, 256], fine
    [N, H/2, W/2, 128]), channels last."""
    P = W["params"]
    x = images[:, None]
    x0 = F.relu(_bn(W, "backbone/bn1", _conv(P, "backbone/conv1", x, 2),
                    train))
    x1 = _block(W, "backbone/layer1_1",
                _block(W, "backbone/layer1_0", x0, 1, train), 1, train)
    x2 = _block(W, "backbone/layer2_1",
                _block(W, "backbone/layer2_0", x1, 2, train), 1, train)
    x3 = _block(W, "backbone/layer3_1",
                _block(W, "backbone/layer3_0", x2, 2, train), 1, train)

    def up(t, like):
        return F.interpolate(t, size=like.shape[2:], mode="bilinear",
                             align_corners=True)

    x3_out = _conv(P, "backbone/l3_out", x3)
    x2_out = _conv(P, "backbone/l2_out", x2)
    m2 = _conv(P, "backbone/l2_m1", x2_out + up(x3_out, x2_out))
    m2 = F.leaky_relu(_bn(W, "backbone/l2_bn", m2, train), 0.01)
    x2_out = _conv(P, "backbone/l2_m2", m2)
    x1_out = _conv(P, "backbone/l1_out", x1)
    m1 = _conv(P, "backbone/l1_m1", x1_out + up(x2_out, x1_out))
    m1 = F.leaky_relu(_bn(W, "backbone/l1_bn", m1, train), 0.01)
    x1_out = _conv(P, "backbone/l1_m2", m1)
    return x3_out.permute(0, 2, 3, 1), x1_out.permute(0, 2, 3, 1)


def position_encoding(h: int, w: int, d: int, device) -> torch.Tensor:
    """[h, w, d] sine encoding of 1-indexed positions; the released
    checkpoints' frequencies exp(-2 i) (the source's operator precedence:
    (-log(1e4) / d) // 2 == -1 for d = 256)."""
    div = np.exp(np.arange(0, d // 2, 2, dtype=np.float64)
                 * (-math.log(10000.0) / d // 2))
    y = np.arange(1, h + 1, dtype=np.float64)[:, None, None]
    x = np.arange(1, w + 1, dtype=np.float64)[None, :, None]
    pe = np.zeros((h, w, d), np.float32)
    pe[:, :, 0::4] = np.sin(x * div)
    pe[:, :, 1::4] = np.cos(x * div)
    pe[:, :, 2::4] = np.sin(y * div)
    pe[:, :, 3::4] = np.cos(y * div)
    return torch.from_numpy(pe).to(device)


# ----------------------------------------------------------- attention ----

def _dense(P, name, x):
    y = x @ P[f"{name}/kernel"]
    b = P.get(f"{name}/bias")
    return y if b is None else y + b


def _layer_norm(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}/scale"],
                        P[f"{name}/bias"], 1e-5)


def _heads(x, nhead):
    return x.reshape(*x.shape[:-1], nhead, x.shape[-1] // nhead)


def linear_attention(q, k, v, q_mask=None, kv_mask=None):
    """elu + 1 feature maps; q [B, L, H, D], k, v [B, S, H, D]."""
    Q, K = F.elu(q) + 1, F.elu(k) + 1
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None]
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None]
        v = v * kv_mask[:, :, None, None]
    s = v.shape[1]
    KV = torch.einsum("bshd,bshv->bhdv", K, v / s)
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Q, K.sum(dim=1)) + 1e-6)
    return torch.einsum("blhd,bhdv->blhv", Q, KV) * Z[..., None] * s


def masked_attention(q, k, v, kv_mask, fill=-1e8):
    """Softmax attention over the keys of kv_mask [B, S] (masked logits set
    to ``fill`` before the 1/sqrt(D) scale)."""
    logits = torch.einsum("blhd,bshd->blsh", q, k)
    logits = logits.masked_fill(~kv_mask[:, None, :, None], fill)
    attn = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=2)
    return torch.einsum("blsh,bshd->blhd", attn, v)


def window_attention(q, k, v, kv_mask, fill=-1e8):
    """Each query over its own window: q [B, L, H, D], k, v [B, L, W, H, D],
    kv_mask [B, L, W]; a query with no valid key gets zeros."""
    logits = torch.einsum("blhd,blwhd->blwh", q, k)
    logits = logits.masked_fill(~kv_mask[..., None], fill)
    attn = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=2)
    out = torch.einsum("blwh,blwhd->blhd", attn, v)
    return torch.where(kv_mask.any(-1)[..., None, None], out,
                       torch.zeros_like(out))


def encoder(P, name, x, source, nhead, attend, act=F.relu):
    """One LoFTR encoder layer: bias-free projections, ``attend(q, k, v)``
    on heads, merge, LayerNorm, a concat MLP, LayerNorm, residual."""
    q = _heads(_dense(P, f"{name}/q_proj", x), nhead)
    k = _heads(_dense(P, f"{name}/k_proj", source), nhead)
    v = _heads(_dense(P, f"{name}/v_proj", source), nhead)
    msg = attend(q, k, v)
    msg = msg.reshape(*x.shape[:-1], -1)
    msg = _layer_norm(P, f"{name}/norm1", _dense(P, f"{name}/merge", msg))
    y = torch.cat([x, msg], dim=-1)
    y = _dense(P, f"{name}/mlp1", act(_dense(P, f"{name}/mlp0", y)))
    return x + _layer_norm(P, f"{name}/norm2", y)


def coarse_transformer(P, f0, f1, m0=None, m1=None):
    """Four (self, cross) layers of 8-head linear attention; in each cross
    layer image 1 attends to the already updated image 0."""
    for i in range(8):
        name = f"loftr_coarse/layer_{i}"
        if i % 2 == 0:
            f0 = encoder(P, name, f0, f0, 8, lambda q, k, v: linear_attention(
                q, k, v, m0, m0))
            f1 = encoder(P, name, f1, f1, 8, lambda q, k, v: linear_attention(
                q, k, v, m1, m1))
        else:
            f0 = encoder(P, name, f0, f1, 8, lambda q, k, v: linear_attention(
                q, k, v, m0, m1))
            f1 = encoder(P, name, f1, f0, 8, lambda q, k, v: linear_attention(
                q, k, v, m1, m0))
    return f0, f1


def dual_softmax(f0, f1, temperature=0.1, m0=None, m1=None):
    """[B, L, S] confidence: softmax over rows times softmax over columns
    of <f0, f1> / (C T), invalid pairs filled with -1e9."""
    sim = torch.einsum("blc,bsc->bls", f0, f1) / (f0.shape[-1] * temperature)
    if m0 is not None and m1 is not None:
        valid = (m0[:, :, None] > 0) & (m1[:, None, :] > 0)
        sim = sim.masked_fill(~valid, -1e9)
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


class Features(NamedTuple):
    cnn0: torch.Tensor       # [B, h, w, 256] coarse CNN features
    cnn1: torch.Tensor
    fine0: torch.Tensor      # [B, H/2, W/2, 128]
    fine1: torch.Tensor
    f0: torch.Tensor         # [B, L, 256] after the coarse transformer
    f1: torch.Tensor


def features(W, image0, image1, m0=None, m1=None, train=False) -> Features:
    """The backbone over both images at once, then the coarse transformer.
    image0/1 [B, H, W]; m0/m1 [B, L] coarse validity (or None)."""
    P = W["params"]
    b = image0.shape[0]
    c, f = backbone(W, torch.cat([image0, image1]), train)
    h, w = c.shape[1:3]
    pe = position_encoding(h, w, c.shape[-1], c.device)
    f0 = (c[:b] + pe).reshape(b, h * w, -1)
    f1 = (c[b:] + pe).reshape(b, h * w, -1)
    f0, f1 = coarse_transformer(P, f0, f1, m0, m1)
    return Features(c[:b], c[b:], f[:b], f[b:], f0, f1)


# -------------------------------------------------------------- RANSAC ----

def warp_points(points, H, eps=1e-6):
    """points [..., N, 2] through H [..., 3, 3]; a zero denominator is
    replaced by eps."""
    x, y = points[..., 0], points[..., 1]
    h = H[..., None, :, :]
    u = h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]
    v = h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]
    d = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    d = torch.where(d == 0, torch.full_like(d, eps), d)
    return torch.stack([u / d, v / d], dim=-1)


def solve8(A, b):
    """Gauss-Jordan with partial pivoting on [..., 8, 8] systems; a
    singular system gives inf or nan."""
    n = 8
    M = torch.cat([A, b[..., None]], dim=-1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = M[..., :, k].abs()
        col = torch.where(rows >= k, col, torch.full_like(col, -1.0))
        p = col.argmax(dim=-1)
        perm = rows.expand(*p.shape, n).clone()
        perm[..., k] = p
        perm.scatter_(-1, p[..., None], k)
        M = torch.gather(M, -2, perm[..., None].expand(*perm.shape, n + 1))
        pivot = M[..., k, :] / M[..., k, k:k + 1]
        M = torch.cat([M[..., :k, :], pivot[..., None, :],
                       M[..., k + 1:, :]], dim=-2)
        upd = M[..., :, k:k + 1] * pivot[..., None, :]
        M = M - torch.where((rows != k)[:, None], upd, torch.zeros_like(upd))
    return M[..., :, n]


def four_point_homography(src, dst):
    """[..., 4, 2] -> [..., 3, 3], h33 = 1."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1)
    ay = torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)
    sol = solve8(torch.cat([ax, ay], dim=-2), torch.cat([u, v], dim=-1))
    return torch.cat([sol, torch.ones_like(sol[..., :1])],
                     dim=-1).reshape(*sol.shape[:-1], 3, 3)


def _normalization(pts, w):
    wsum = torch.clamp(w.sum(-1), min=1e-8)
    mean = (pts * w[..., None]).sum(1) / wsum[:, None]
    d = torch.sqrt(((pts - mean[:, None]) ** 2).sum(-1) + 1e-12)
    scale = math.sqrt(2.0) / torch.clamp((d * w).sum(-1) / wsum, min=1e-8)
    T = torch.zeros((pts.shape[0], 3, 3), dtype=pts.dtype, device=pts.device)
    T[:, 0, 0] = scale
    T[:, 1, 1] = scale
    T[:, 0, 2] = -scale * mean[:, 0]
    T[:, 1, 2] = -scale * mean[:, 1]
    T[:, 2, 2] = 1.0
    return T


def dlt_homography(pts0, pts1, weights):
    """Weighted Hartley-normalized DLT (smallest eigenvector of A^T A)."""
    T0, T1 = _normalization(pts0, weights), _normalization(pts1, weights)
    p0, p1 = warp_points(pts0, T0), warp_points(pts1, T1)
    x, y, u, v = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    ay = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    sw = torch.sqrt(torch.clamp(weights, min=0.0))[..., None]
    A = torch.cat([ax * sw, ay * sw], dim=1)
    _, vecs = torch.linalg.eigh(A.transpose(1, 2) @ A)
    H = torch.linalg.inv_ex(T1)[0] @ vecs[..., :, 0].reshape(-1, 3, 3) @ T0
    h22 = H[:, 2, 2]
    return H / torch.where(h22.abs() < 1e-12, torch.ones_like(h22),
                           h22)[:, None, None]


def _err2(H, pts0, pts1):
    return ((warp_points(pts0[:, None], H) - pts1[:, None]) ** 2).sum(-1)


def ransac(pts0, pts1, valid, uniforms, thr=8.0, refine=2):
    """4-point hypotheses drawn by Gumbel top-4 from ``uniforms`` [B, K, N]
    over the valid entries, MSAC scoring, the best hypothesis, then two
    rounds of weighted DLT on its widened inlier set, each kept when its
    MSAC cost is no worse. Returns (H, inliers [B, N], ok [B])."""
    b = valid.shape[0]
    validf = valid.float()
    g = -torch.log(-torch.log(uniforms.clamp(min=1e-20)))
    g = torch.where(valid[:, None, :], g, torch.full_like(g, -math.inf))
    idx = torch.topk(g, 4, dim=-1).indices
    bi = torch.arange(b, device=valid.device)[:, None, None]
    Hs = four_point_homography(pts0[bi, idx], pts1[bi, idx])
    finite = torch.isfinite(Hs).all(-1).all(-1)
    e2 = _err2(Hs, pts0, pts1)
    t2 = float(thr * thr)
    cost = (torch.clamp(e2, max=t2) * validf[:, None]).sum(-1)
    cost = torch.where(finite, cost, torch.full_like(cost, math.inf))
    best = cost.argmin(dim=1)
    ar = torch.arange(b, device=valid.device)
    H = Hs[ar, best]
    eye = torch.eye(3, device=H.device).expand_as(H)
    H = torch.where(torch.isfinite(H).all(-1).all(-1)[:, None, None], H, eye)
    inliers = ((e2 < t2) & valid[:, None])[ar, best]

    def msac(Hc):
        return (torch.clamp(_err2(Hc[:, None], pts0, pts1)[:, 0], max=t2)
                * validf).sum(-1)

    for i in range(refine):
        m = min(2.0 ** (refine - 1 - i), 4.0)
        e = _err2(H[:, None], pts0, pts1)[:, 0]
        w = ((e < t2 * m * m) & valid).float() * validf
        Hn = dlt_homography(pts0, pts1, w)
        good = torch.isfinite(Hn).all(-1).all(-1) & (w.sum(-1) >= 4)
        Hn = torch.where(good[:, None, None], Hn, H)
        new_inl = (_err2(Hn[:, None], pts0, pts1)[:, 0] < t2) & valid
        keep = msac(Hn) <= msac(H)
        H = torch.where(keep[:, None, None], Hn, H)
        inliers = torch.where(keep[:, None], new_inl, inliers)
    ok = (valid.sum(-1) >= 4) & (inliers.sum(-1) >= 4) \
        & torch.isfinite(H).all(-1).all(-1)
    return H, inliers, ok


def cell_coords(ids, grid_w, scale=COARSE):
    """Cell index -> pixel (x, y) of its corner, float32."""
    return torch.stack([(ids % grid_w) * scale, (ids // grid_w) * scale],
                       -1).float()


class Geometry(NamedTuple):
    H: torch.Tensor          # [B, 3, 3]
    has_H: torch.Tensor      # [B]
    map0: torch.Tensor       # [B, L0] inlier cells of image 0
    map1: torch.Tensor
    num_inliers: torch.Tensor


def geometry(i_ids, j_ids, valid, grid_hw, uniforms, thr=8.0,
             min_matches=8) -> Geometry:
    """RANSAC on the first-pass matches and the inlier membership maps
    (all matches where no homography was found)."""
    h, w = grid_hw
    H, inl, ok = ransac(cell_coords(i_ids, w), cell_coords(j_ids, w), valid,
                        uniforms, thr)
    has_H = ok & (valid.sum(-1) > min_matches)
    member = torch.where(has_H[:, None], inl & valid, valid)
    maps = []
    for cells in (i_ids, j_ids):
        m = torch.zeros((valid.shape[0], h * w + 1), dtype=torch.bool,
                        device=valid.device)
        m.scatter_(1, torch.where(member, cells, h * w), True)
        maps.append(m[:, :h * w])
    return Geometry(H, has_H, maps[0], maps[1], inl.sum(-1))


# ----------------------------------------------------------------- GAM ----

def first_true(mask, capacity):
    """Indices of the first ``capacity`` True entries of each row of mask
    [B, N] (0 in the slots left over) and the slots' validity."""
    b, n = mask.shape
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    idx = F.pad(order, (0, max(0, capacity - n)))[:, :capacity]
    ok = torch.arange(capacity, device=mask.device)[None] < \
        mask.sum(-1, keepdim=True).clamp(max=capacity)
    return torch.where(ok, idx, torch.zeros_like(idx)), ok


def _take(feat, idx):
    """feat [B, N, C] at idx [B, ...] -> [B, ..., C]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(feat, 1, flat[..., None].expand(-1, -1,
                                                       feat.shape[-1]))
    return out.reshape(*idx.shape, feat.shape[-1])


def _windows(H, grid_hw):
    """The 5x5 cells around each source cell's warped corner point in the
    other grid: (cells [B, L, 25], in-grid mask [B, L, 25])."""
    h, w = grid_hw
    r = WINDOW // 2
    dev = H.device
    src = cell_coords(torch.arange(h * w, device=dev), w)
    warped = warp_points(src[None], H)
    off = torch.arange(-r, r + 1, dtype=torch.float32, device=dev) * COARSE
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    kp = warped[:, :, None] + torch.stack([ox, oy], -1).reshape(-1, 2)
    inb = ((kp[..., 0] >= 0) & (kp[..., 0] < w * COARSE)
           & (kp[..., 1] >= 0) & (kp[..., 1] < h * COARSE))
    kp = torch.where(inb[..., None], kp, torch.zeros_like(kp))
    cx = torch.floor(kp[..., 0] / COARSE).long().clamp(0, w - 1)
    cy = torch.floor(kp[..., 1] / COARSE).long().clamp(0, h - 1)
    return cy * w + cx, inb


def gam(P, cnn0, cnn1, geo: Geometry, max_inliers: int):
    """The geometrized attention module: self layers over the (first
    ``max_inliers``) inlier tokens of the same image, cross layers over the
    5x5 windows around each cell's warp into the other image; a pair
    without a homography keeps its features through the cross layers, an
    image without inliers through the self layers."""
    b, h, w, c = cnn0.shape
    pe = position_encoding(h, w, c, cnn0.device)
    f0 = (cnn0 + pe).reshape(b, h * w, c)
    f1 = (cnn1 + pe).reshape(b, h * w, c)
    idx0, ok0 = first_true(geo.map0, max_inliers)
    idx1, ok1 = first_true(geo.map1, max_inliers)
    any0 = geo.map0.any(-1)[:, None, None]
    any1 = geo.map1.any(-1)[:, None, None]
    eye = torch.eye(3, device=geo.H.device)
    H = torch.where(geo.has_H[:, None, None], geo.H, eye)
    cells1, inb1 = _windows(H, (h, w))
    cells0, inb0 = _windows(torch.linalg.inv_ex(H)[0], (h, w))
    sel = geo.has_H[:, None, None]
    for i in range(4):
        name = f"geo_module/layer_{i}"
        if i % 2 == 0:
            o0 = encoder(P, name, f0, _take(f0, idx0), 4,
                         lambda q, k, v: masked_attention(q, k, v, ok0),
                         torch.tanh)
            o1 = encoder(P, name, f1, _take(f1, idx1), 4,
                         lambda q, k, v: masked_attention(q, k, v, ok1),
                         torch.tanh)
            f0, f1 = torch.where(any0, o0, f0), torch.where(any1, o1, f1)
        else:
            o0 = encoder(P, name, f0, _take(f1, cells1), 4,
                         lambda q, k, v: window_attention(q, k, v, inb1),
                         torch.tanh)
            o1 = encoder(P, name, f1, _take(f0, cells0), 4,
                         lambda q, k, v: window_attention(q, k, v, inb0),
                         torch.tanh)
            f0, f1 = torch.where(sel, o0, f0), torch.where(sel, o1, f1)
    return f0, f1


# ---------------------------------------------------------------- fine ----

def fine_windows(fine, ids, grid_w):
    """[B, M, 25, C] fine-map windows centred on the cells ``ids`` (zero
    padding at the borders)."""
    b, hf, wf, c = fine.shape
    r = WINDOW // 2
    stride = COARSE // FINE
    padded = F.pad(fine, (0, 0, r, r, r, r))
    rows = (ids // grid_w) * stride
    cols = (ids % grid_w) * stride
    d = torch.arange(WINDOW, device=ids.device)
    lin = (rows[..., None, None] + d[:, None]) * (wf + 2 * r) \
        + cols[..., None, None] + d[None, :]
    return _take(padded.reshape(b, -1, c), lin.reshape(b, ids.shape[1], -1))


def fine_confidence(P, fine0, fine1, g0, g1, i_ids, j_ids, grid_w):
    """[B, M, 25, 25] window-to-window dual-softmax confidence at the coarse
    matches (i_ids, j_ids): windows fused with the projected coarse
    features, then one (self, cross) pair of 8-head linear attention."""
    b, m = i_ids.shape
    ws = []
    for fine, g, ids in ((fine0, g0, i_ids), (fine1, g1, j_ids)):
        win = fine_windows(fine, ids, grid_w)
        cc = _dense(P, "fine_preprocess/down_proj", _take(g, ids))
        cat = torch.cat([win, cc[:, :, None].expand(-1, -1, win.shape[2],
                                                     -1)], -1)
        ws.append(_dense(P, "fine_preprocess/merge_feat", cat)
                  .reshape(b * m, WINDOW * WINDOW, -1))
    t0, t1 = ws

    def lin(q, k, v):
        return linear_attention(q, k, v)

    t0 = encoder(P, "loftr_fine/layer_0", t0, t0, 8, lin)
    t1 = encoder(P, "loftr_fine/layer_0", t1, t1, 8, lin)
    t0 = encoder(P, "loftr_fine/layer_1", t0, t1, 8, lin)
    t1 = encoder(P, "loftr_fine/layer_1", t1, t0, 8, lin)
    return dual_softmax(t0, t1).reshape(b, m, WINDOW * WINDOW,
                                        WINDOW * WINDOW)
