"""Inputs made from the seed: textured image pairs under known homographies.

Frozen copies of the repository's generators, so that a later change to
the program cannot move the yardstick:

- the texture is the multi-octave noise of the port's
  ``eval/synthetic.textured_pair`` (octaves of 64, 16 and 4 pixels, weights
  1, 0.6 and 0.3, bicubic upsampling, normalized to [0, 1]);
- the homography is the four-corner perturbation of the port's
  ``eval/hpatches_synth._corner_h`` (corner jitter uniform in +-mag of the
  image size), half the pairs "illumination"-like (mag 0.015) and half
  "viewpoint"-like (mag 0.22), as the 52 i_ and 56 v_ HPatches sequences;
- the photometric jitter is that of ``_photometric`` there (gamma
  U(0.6, 1.6), gain U(0.7, 1.2), offset U(-0.1, 0.1), and Gaussian noise
  of 0.02 on half the images);
- the warp is ``textured_pair``'s: img1(p) = img0(H^-1 p), bilinear, zeros
  outside.

Textures, warps and noise are made on the device in a few batched calls
from a ``torch.Generator`` there; the homographies and the jitter's
scalars come from a CPU generator, so they are the same on any machine.
The same seed gives the same pool.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

OCTAVES = ((64, 1.0), (16, 0.6), (4, 0.3))
MAGS = (0.015, 0.22)


def textures(n: int, hw: Tuple[int, int], gen: torch.Generator,
             device) -> torch.Tensor:
    """[n, h, w] float32 multi-octave noise textures in [0, 1]."""
    h, w = hw
    img = torch.zeros((n, 1, h, w), device=device)
    for cell, weight in OCTAVES:
        lo = torch.rand((n, 1, h // cell + 4, w // cell + 4), generator=gen,
                        device=device)
        up = F.interpolate(lo, scale_factor=cell, mode="bicubic")
        img += weight * up[..., :h, :w]
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    return ((img - lo) / (hi - lo))[:, 0]


def corner_homographies(n: int, hw: Tuple[int, int],
                        cpu_gen: torch.Generator) -> torch.Tensor:
    """[n, 3, 3] float64 homographies from perturbed image corners; even
    indices at MAGS[0], odd at MAGS[1]."""
    h, w = hw
    src = torch.tensor([[0, 0], [w, 0], [w, h], [0, h]], dtype=torch.float64)
    mag = torch.tensor([MAGS[i % 2] for i in range(n)], dtype=torch.float64)
    jit = (torch.rand((n, 4, 2), generator=cpu_gen, dtype=torch.float64)
           * 2 - 1) * mag[:, None, None] * torch.tensor([w, h],
                                                       dtype=torch.float64)
    dst = src[None] + jit
    rows = []
    for k in range(4):
        x, y = src[k]
        u, v = dst[:, k, 0], dst[:, k, 1]
        z, o = torch.zeros(n, dtype=torch.float64), torch.ones(
            n, dtype=torch.float64)
        rows.append(torch.stack([x * o, y * o, o, z, z, z, -u * x, -u * y],
                                -1))
        rows.append(torch.stack([z, z, z, x * o, y * o, o, -v * x, -v * y],
                                -1))
    A = torch.stack(rows, 1)
    b = torch.stack([dst[:, k // 2, k % 2] for k in range(8)], 1)
    sol = torch.linalg.solve(A, b)
    return torch.cat([sol, torch.ones((n, 1), dtype=torch.float64)],
                     1).reshape(n, 3, 3)


def warp(img: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """img [n, h, w] -> img(H^-1 p) per image, bilinear, zeros outside."""
    n, h, w = img.shape
    f64 = dict(dtype=torch.float64, device=img.device)
    ys, xs = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64),
                            indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    Hinv = torch.linalg.inv(H).to(img.device)
    src = p[None] @ Hinv.transpose(1, 2)                      # [n, hw, 3]
    src = src[..., :2] / src[..., 2:]
    grid = torch.stack([2 * src[..., 0] / (w - 1) - 1,
                        2 * src[..., 1] / (h - 1) - 1], -1)
    grid = grid.reshape(n, h, w, 2).float()
    return F.grid_sample(img[:, None], grid, align_corners=True)[:, 0]


def photometric(img: torch.Tensor, gen: torch.Generator,
                cpu_gen: torch.Generator) -> torch.Tensor:
    n = img.shape[0]
    u = torch.rand((n, 4), generator=cpu_gen, dtype=torch.float64)
    gamma = (0.6 + 1.0 * u[:, 0]).float().to(img.device)[:, None, None]
    gain = (0.7 + 0.5 * u[:, 1]).float().to(img.device)[:, None, None]
    off = (-0.1 + 0.2 * u[:, 2]).float().to(img.device)[:, None, None]
    noisy = (u[:, 3] < 0.5).float().to(img.device)[:, None, None]
    noise = torch.randn(img.shape, generator=gen, device=img.device)
    out = torch.clamp(img, 0, 1) ** gamma * gain + off + 0.02 * noisy * noise
    return torch.clamp(out, 0, 1)


def pair_pool(seed: int, n: int, hw: Tuple[int, int], device):
    """(img0 [n, h, w], img1 [n, h, w] on ``device``, H [n, 3, 3] float64
    on the host):
    n textured pairs with img1 = photometric(img0 warped by H)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    cpu_gen = torch.Generator().manual_seed(int(seed))
    img0 = textures(n, hw, gen, device)
    H = corner_homographies(n, hw, cpu_gen)
    img1 = photometric(warp(img0, H), gen, cpu_gen)
    return img0, img1, H


def _four_point(src, dst):
    """[n, 3, 3] float64 homographies mapping the 4 points src -> dst
    ([n, 4, 2] each)."""
    n = src.shape[0]
    z = torch.zeros(n, dtype=torch.float64)
    o = torch.ones(n, dtype=torch.float64)
    rows = []
    for k in range(4):
        x, y = src[:, k, 0], src[:, k, 1]
        u, v = dst[:, k, 0], dst[:, k, 1]
        rows.append(torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1))
        rows.append(torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1))
    b = torch.stack([dst[:, k // 2, k % 2] for k in range(8)], 1)
    sol = torch.linalg.solve(torch.stack(rows, 1), b)
    return torch.cat([sol, o[:, None]], 1).reshape(n, 3, 3)


def training_homographies(n: int, hw: Tuple[int, int],
                          cpu_gen: torch.Generator) -> torch.Tensor:
    """[n, 3, 3] float64: the port's data/synthetic sample_homography
    recipe: the four corners moved by integers in [-max(h, w) // 3,
    max(h, w) // 3), or with probability 0.2 in [-5, 5); with probability
    0.2 an axis flip, which replaces the warp with probability 0.6 and is
    composed after it otherwise."""
    h, w = hw
    rg = max(h, w)
    kw = dict(generator=cpu_gen)
    big = torch.randint(-rg // 3, rg // 3, (n, 4, 2), **kw).double()
    small = torch.randint(-5, 5, (n, 4, 2), **kw).double()
    u = torch.rand((n, 3), dtype=torch.float64, **kw)
    flip_y = torch.randint(0, 2, (n,), **kw)
    corners = torch.tensor([[0, 0], [0, h], [w, 0], [w, h]],
                           dtype=torch.float64).expand(n, 4, 2)
    warp_ = torch.where((u[:, 0] < 0.2)[:, None, None], small, big)
    H = _four_point(corners, corners + warp_)
    flips = torch.tensor([[[-1, 0, w], [0, 1, 0], [0, 0, 1]],
                          [[1, 0, 0], [0, -1, h], [0, 0, 1]]],
                         dtype=torch.float64)[flip_y]
    return torch.where((u[:, 1] < 0.2)[:, None, None],
                       torch.where((u[:, 2] < 0.6)[:, None, None], flips,
                                   H @ flips), H)


def training_batches(seed: int, n: int, batch: int, hw: Tuple[int, int],
                     device, coarse: int = 8):
    """n supervised batches of ``batch`` homography pairs, as the port's
    data/synthetic.make_pair_batch makes them (frozen copy): texture,
    warp, on the warped view brightness U(-0.1, 0.1), contrast U(0.8,
    1.2), gamma U(0.75, 1.35), a 3x3 box blur for 30 %, noise of 0.02;
    coarse validity of each cell's centre; the pair swapped (with H^-1)
    for half. Each: image0/image1 [B, H, W, 1], H_0to1/H_1to0 [B, 3, 3],
    mask0/mask1 [B, H/8, W/8], on the device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    cpu_gen = torch.Generator().manual_seed(int(seed))
    h, w = hw
    total = n * batch
    base = textures(total, hw, gen, device)
    H = training_homographies(total, hw, cpu_gen)
    img1 = warp(base, H)
    u = torch.rand((total, 5), dtype=torch.float64, generator=cpu_gen)
    per = (lambda x: x.float().to(device)[:, None, None])
    img1 = torch.clamp((img1 + per(u[:, 0] * 0.2 - 0.1))
                       * per(u[:, 1] * 0.4 + 0.8), 0, 1) \
        ** per(u[:, 2] * 0.6 + 0.75)
    box = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=device)
    blur = F.conv2d(img1[:, None], box, padding=1)[:, 0]
    img1 = torch.where(per(u[:, 3]) < 0.3, blur, img1)
    img1 = torch.clamp(img1 + 0.02 * torch.randn(img1.shape, generator=gen,
                                                 device=device), 0, 1)
    hc, wc = h // coarse, w // coarse
    ys, xs = torch.meshgrid(torch.arange(hc, dtype=torch.float64),
                            torch.arange(wc, dtype=torch.float64),
                            indexing="ij")
    ctr = torch.stack([xs * coarse + coarse / 2, ys * coarse + coarse / 2,
                       torch.ones_like(xs)], -1).reshape(-1, 3)
    Hinv = torch.linalg.inv(H)
    src = ctr[None] @ Hinv.transpose(1, 2)
    src = src[..., :2] / src[..., 2:]
    inb = ((src[..., 0] >= 0) & (src[..., 0] < w) & (src[..., 1] >= 0)
           & (src[..., 1] < h)).reshape(total, hc, wc).float().to(device)
    ones = torch.ones_like(inb)
    swap = (u[:, 4] < 0.5).to(device)
    s4, s3 = swap[:, None, None], swap[:, None, None]
    out = {"image0": torch.where(s4, img1, base)[..., None],
           "image1": torch.where(s4, base, img1)[..., None],
           "H_0to1": torch.where(s3, Hinv.float().to(device),
                                 H.float().to(device)),
           "H_1to0": torch.where(s3, H.float().to(device),
                                 Hinv.float().to(device)),
           "mask0": torch.where(s3, inb, ones),
           "mask1": torch.where(s3, ones, inb)}
    return [{k: v[i * batch:(i + 1) * batch].contiguous()
             for k, v in out.items()} for i in range(n)]
