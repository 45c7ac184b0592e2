"""Self-supervised homography pairs from procedural textures.

Counterpart of geoformer_tpu/data/synthetic.py: the host supplies base
grayscale images (the procedural bank of cpp/synthgen.cpp, an image
directory, or a mix of both); homography sampling, warping, photometric
jitter, the optional camera-realism stack (data/augment.sensor_aug), coarse
validity masks and the 50 % pair swap run as tensor ops on the device of
the base images. The numpy textures (procedural_texture to
mixed_texture_bank) are copies of the JAX package's: the bank falls back
to them where there is no C++ compiler to build cpp/synthgen.cpp, and
says so in one printed line. (The JAX package falls back on any failure
of its build; here a build that fails raises.)

Every random number of make_pair_batch is one entry of a dict of draws
(``pair_draws``), which a caller may give instead of a generator, so that a
test can hand both packages the same numbers.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from geoformer_tpu_torch.data.augment import sensor_aug, sensor_aug_draws
from geoformer_tpu_torch.data.native import (
    NoCompiler,
    native_textures,
    native_textures_mixed,
)
from geoformer_tpu_torch.eval.image_io import UnreadableImage, read_gray
from geoformer_tpu_torch.geometry.homography import (
    grid_points,
    sample_homography,
    sample_homography_draws,
    warp_points,
)
from geoformer_tpu_torch.ops.image_warp import warp_image
from geoformer_tpu_torch.ops.resize import resize_linear_u8


def pair_draws(b: int, hw: Tuple[int, int], generator=None,
               device=None, sensor: bool = False) -> Dict[str, torch.Tensor]:
    """The random draws of make_pair_batch for b base images of size hw:
    those of sample_homography_draws, then per sample "bright" U(-0.1, 0.1),
    "contrast" U(0.8, 1.2), "gamma" U(0.75, 1.35), "u_blur" and "u_swap"
    U(0, 1), all [b], and the standard normal "noise" [b, H, W]; with
    ``sensor``, "sensor0" and "sensor1", the sensor_aug_draws of each
    view."""
    kw = dict(generator=generator, device=device)
    draws = sample_homography_draws(b, hw, generator, device)
    draws.update(
        bright=torch.rand((b,), **kw) * 0.2 - 0.1,
        contrast=torch.rand((b,), **kw) * 0.4 + 0.8,
        gamma=torch.rand((b,), **kw) * 0.6 + 0.75,
        u_blur=torch.rand((b,), **kw),
        u_swap=torch.rand((b,), **kw),
        noise=torch.randn((b, *hw), **kw),
    )
    if sensor:
        for view in ("sensor0", "sensor1"):
            draws[view] = sensor_aug_draws((b, *hw, 1), generator, device)
    return draws


def make_pair_batch(base: torch.Tensor, generator=None, coarse_scale: int = 8,
                    sensor: bool = False,
                    draws: Optional[Dict[str, torch.Tensor]] = None):
    """Turn base images [B, H, W] into supervised homography pairs.

    Sample H, warp, jitter the warped view (brightness, contrast, gamma, a
    3x3 box blur for 30 % of samples, noise 0.02), build coarse validity
    masks from the warp, and swap the pair (with H^-1) for half the samples.
    sensor=True passes both views through the camera-realism stack
    (sensor_aug), each with its own draws, after the jitter. The draws come
    from ``generator`` (on the device of ``base``) unless given.

    Returns dict: image0/image1 [B, H, W, 1], H_0to1/H_1to0 [B, 3, 3],
    mask0/mask1 [B, H/8, W/8] (f32).
    """
    b, h, w = base.shape
    if draws is None:
        draws = pair_draws(b, (h, w), generator, base.device, sensor)
    Hs = sample_homography(draws, (h, w))
    img0 = base[..., None].float()
    img1 = warp_image(img0, Hs)

    def per_sample(x):
        return x.reshape(b, 1, 1, 1)

    img1 = torch.clamp((img1 + per_sample(draws["bright"]))
                       * per_sample(draws["contrast"]), 0.0, 1.0) \
        ** per_sample(draws["gamma"])
    box = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=base.device)
    blur = F.conv2d(img1.permute(0, 3, 1, 2), box, padding=1).permute(
        0, 2, 3, 1)
    do_blur = per_sample(draws["u_blur"]) < 0.3
    img1 = torch.clamp(torch.where(do_blur, blur, img1)
                       + 0.02 * draws["noise"][..., None], 0.0, 1.0)
    if sensor:
        img0 = sensor_aug(img0, draws=draws["sensor0"])
        img1 = sensor_aug(img1, draws=draws["sensor1"])

    # coarse-resolution validity: the cell centre maps inside the source
    hc, wc = h // coarse_scale, w // coarse_scale
    centers = grid_points(hc, wc, coarse_scale, device=base.device) \
        + coarse_scale / 2
    Hinv = torch.linalg.inv(Hs)
    src = warp_points(centers[None], Hinv)
    inb = ((src[..., 0] >= 0) & (src[..., 0] < w)
           & (src[..., 1] >= 0) & (src[..., 1] < h))
    mask1 = inb.reshape(b, hc, wc).float()
    mask0 = torch.ones((b, hc, wc), device=base.device)

    swap = draws["u_swap"] < 0.5
    s4, s3 = per_sample(swap), swap[:, None, None]
    return {"image0": torch.where(s4, img1, img0),
            "image1": torch.where(s4, img0, img1),
            "H_0to1": torch.where(s3, Hinv, Hs),
            "H_1to0": torch.where(s3, Hs, Hinv),
            "mask0": torch.where(s3, mask1, mask0),
            "mask1": torch.where(s3, mask0, mask1)}


def procedural_texture(rng: np.random.Generator, hw: Tuple[int, int],
                       n_blobs: int = 60) -> np.ndarray:
    """Structured grayscale texture (numpy fallback of cpp/synthgen.cpp):
    gaussian blobs + bands for low-frequency structure, value-noise octaves
    for high-frequency detail, and hard-edged rectangles / line segments /
    checker patches for the corners sub-pixel localization learns from."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.15 * (xx / w) + 0.1 * (yy / h)
    cx = rng.uniform(0, w, n_blobs)
    cy = rng.uniform(0, h, n_blobs)
    s = rng.uniform(4, 40, n_blobs)
    a = rng.uniform(-0.6, 1.0, n_blobs)
    for i in range(n_blobs):
        img += a[i] * np.exp(-(((xx - cx[i]) ** 2 + (yy - cy[i]) ** 2)
                               / (2 * s[i] ** 2)))
    for _ in range(6):
        th = rng.uniform(0, np.pi)
        f = rng.uniform(0.01, 0.08)
        ph = rng.uniform(0, 2 * np.pi)
        img += 0.15 * np.sin(2 * np.pi * f *
                             (np.cos(th) * xx + np.sin(th) * yy) + ph)

    # value-noise octaves
    for cell in (32, 16, 8):
        amp = 0.10 * cell / 32 + 0.05
        gh, gw = h // cell + 2, w // cell + 2
        lat = rng.uniform(-1, 1, (gh, gw)).astype(np.float32)
        fy, fx = yy / cell, xx / cell
        y0 = fy.astype(np.int32)
        x0 = fx.astype(np.int32)
        ty, tx = fy - y0, fx - x0
        img += amp * ((1 - ty) * ((1 - tx) * lat[y0, x0]
                                  + tx * lat[y0, x0 + 1])
                      + ty * ((1 - tx) * lat[y0 + 1, x0]
                              + tx * lat[y0 + 1, x0 + 1]))

    # hard-edged rotated rectangles
    for _ in range(10):
        rcx, rcy = rng.uniform(0, w), rng.uniform(0, h)
        hw2, hh2 = rng.uniform(4, 0.25 * w), rng.uniform(4, 0.25 * h)
        th = rng.uniform(0, np.pi)
        amp = rng.uniform(-0.5, 0.5)
        u = np.cos(th) * (xx - rcx) + np.sin(th) * (yy - rcy)
        v = -np.sin(th) * (xx - rcx) + np.cos(th) * (yy - rcy)
        img += amp * ((np.abs(u) <= hw2) & (np.abs(v) <= hh2))

    # line segments
    for _ in range(12):
        ax_, ay_ = rng.uniform(0, w), rng.uniform(0, h)
        th = rng.uniform(0, 2 * np.pi)
        ln = rng.uniform(20, 0.8 * max(h, w))
        bx_, by_ = ax_ + ln * np.cos(th), ay_ + ln * np.sin(th)
        half = 0.5 * rng.uniform(1, 3)
        amp = rng.uniform(-0.6, 0.6)
        vx, vy = bx_ - ax_, by_ - ay_
        t = np.clip(((xx - ax_) * vx + (yy - ay_) * vy)
                    / max(vx * vx + vy * vy, 1e-6), 0, 1)
        d2 = (ax_ + t * vx - xx) ** 2 + (ay_ + t * vy - yy) ** 2
        img += amp * (d2 <= half * half)

    # occasional checkerboard patch
    if rng.uniform() < 0.35:
        cell = rng.uniform(6, 20)
        cx0, cy0 = int(rng.uniform(0, 0.6 * w)), int(rng.uniform(0, 0.6 * h))
        cw, ch = int(rng.uniform(0.25 * w, 0.5 * w)), int(
            rng.uniform(0.25 * h, 0.5 * h))
        amp = rng.uniform(0.25, 0.5)
        px = ((xx - cx0) / cell).astype(np.int32)
        py = ((yy - cy0) / cell).astype(np.int32)
        patch = ((px + py) % 2 * 2 - 1).astype(np.float32) * amp
        inside = ((xx >= cx0) & (xx < cx0 + cw)
                  & (yy >= cy0) & (yy < cy0 + ch))
        img += patch * inside

    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img.astype(np.float32)


def _value_noise(rng: np.random.Generator, hw: Tuple[int, int],
                 cell: int) -> np.ndarray:
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gh, gw = h // cell + 2, w // cell + 2
    lat = rng.uniform(-1, 1, (gh, gw)).astype(np.float32)
    fy, fx = yy / cell, xx / cell
    y0, x0 = fy.astype(np.int32), fx.astype(np.int32)
    ty, tx = fy - y0, fx - x0
    return ((1 - ty) * ((1 - tx) * lat[y0, x0] + tx * lat[y0, x0 + 1])
            + ty * ((1 - tx) * lat[y0 + 1, x0] + tx * lat[y0 + 1, x0 + 1]))


def dead_leaves_texture(rng: np.random.Generator,
                        hw: Tuple[int, int]) -> np.ndarray:
    """Dead-leaves model (numpy twin of cpp texture_dead_leaves): occluding
    anti-aliased disks with p(r) ~ r^-3 radii — natural-image statistics
    (1/f-like spectrum, occlusion edges at every scale)."""
    h, w = hw
    img = np.full((h, w), rng.uniform(0.2, 0.8), np.float32)
    rmin, rmax = 2.5, 0.35 * min(h, w)
    q2 = (rmin / rmax) ** 2
    for _ in range(4000):
        r = rmin / np.sqrt(1.0 - rng.uniform() * (1.0 - q2))
        cx, cy = rng.uniform(-r, w + r), rng.uniform(-r, h + r)
        col = rng.uniform(0.05, 0.95)
        gx = rng.uniform(-0.25, 0.25) / max(r, 1.0)
        gy = rng.uniform(-0.25, 0.25) / max(r, 1.0)
        x0, x1 = max(0, int(cx - r - 1)), min(w, int(cx + r) + 2)
        y0, y1 = max(0, int(cy - r - 1)), min(h, int(cy + r) + 2)
        if x0 >= x1 or y0 >= y1:
            continue
        dx = np.arange(x0, x1, dtype=np.float32) - cx
        dy = (np.arange(y0, y1, dtype=np.float32) - cy)[:, None]
        d = np.sqrt(dx * dx + dy * dy)
        alpha = np.clip(r - d + 0.5, 0.0, 1.0)
        shade = np.clip(col + gx * dx + gy * dy, 0.0, 1.0)
        win = img[y0:y1, x0:x1]
        img[y0:y1, x0:x1] = alpha * shade + (1 - alpha) * win
    img += 0.04 * _value_noise(rng, hw, 4)
    return _normalize_robust(img)


def _normalize_robust(img: np.ndarray) -> np.ndarray:
    """2%-98% percentile stretch to [0,1] (cpp normalize_robust twin):
    real-photo-like contrast instead of min-max's timid std."""
    lo, hi = np.percentile(img, [2.0, 98.0])
    return np.clip((img - lo) / max(hi - lo, 1e-3), 0.0, 1.0
                   ).astype(np.float32)


def fbm_texture(rng: np.random.Generator, hw: Tuple[int, int]) -> np.ndarray:
    """Fractal value noise (~1/f^2 spectrum) + hard-edged rectangles
    (numpy twin of cpp texture_fbm)."""
    h, w = hw
    img = np.zeros((h, w), np.float32)
    amp = 0.5
    cell = 128
    while cell >= 4:
        if cell < min(h, w):
            img += amp * _value_noise(rng, hw, cell)
        amp *= 0.62
        cell //= 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(6):
        rcx, rcy = rng.uniform(0, w), rng.uniform(0, h)
        hw2, hh2 = rng.uniform(4, 0.25 * w), rng.uniform(4, 0.25 * h)
        th = rng.uniform(0, np.pi)
        a = rng.uniform(-0.35, 0.35)
        u = np.cos(th) * (xx - rcx) + np.sin(th) * (yy - rcy)
        v = -np.sin(th) * (xx - rcx) + np.cos(th) * (yy - rcy)
        img += a * ((np.abs(u) <= hw2) & (np.abs(v) <= hh2))
    return _normalize_robust(img)


def mixed_texture_bank(rng: np.random.Generator, hw: Tuple[int, int],
                       n: int) -> np.ndarray:
    """[n, H, W] bank, one third each structured / dead-leaves / fBm."""
    gens = (procedural_texture, dead_leaves_texture, fbm_texture)
    return np.stack([gens[i % 3](rng, hw) for i in range(n)])


def load_image_dir(root: str, hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """[n, H, W] float32 grey images in [0, 1] of every *.jpg, *.png and
    *.ppm file under ``root`` (sorted, recursive), each resized to hw as
    cv2.resize does; None if there is none. A file that cv2 cannot read
    either is skipped, as the JAX package skips it; a format that cv2
    reads and the port does not (a progressive JPEG, say) raises
    ValueError."""
    paths = sorted(sum((glob.glob(os.path.join(root, "**", e), recursive=True)
                        for e in ("*.jpg", "*.png", "*.ppm")), []))
    out = []
    for p in paths:
        try:
            im = read_gray(p)
        except UnreadableImage:
            continue
        out.append(resize_linear_u8(im, hw).astype(np.float32) / 255.0)
    return np.stack(out) if out else None


def _procedural_bank(hw: Tuple[int, int], seed: int, texture_style: str,
                     rng: np.random.Generator,
                     size: int = 256) -> np.ndarray:
    """[n, H, W] procedural bank: ``size`` textures of cpp/synthgen.cpp from
    ``seed``; where no compiler can build it, max(64, size // 4) numpy
    textures drawn from ``rng``."""
    gen = native_textures_mixed if texture_style == "mixed" \
        else native_textures
    try:
        return gen(size, hw[0], hw[1], seed)
    except NoCompiler as e:
        print(f"texture bank: {e}; using the numpy textures", flush=True)
    n = max(64, size // 4)
    if texture_style == "mixed":
        return mixed_texture_bank(rng, hw, n)
    return np.stack([procedural_texture(rng, hw) for _ in range(n)])


def base_image_stream(hw: Tuple[int, int], batch: int, seed: int = 0,
                      image_dir: Optional[str] = None,
                      texture_style: str = "mixed",
                      image_fraction: float = 1.0,
                      bank_size: int = 256,
                      bank_refresh: int = 0) -> Iterator[np.ndarray]:
    """Endless stream of [batch, H, W] float32 base images, as the JAX
    package draws them with numpy's default_rng(seed): from the images of
    ``image_dir`` (load_image_dir) with per-sample probability
    ``image_fraction``, the rest from a procedural bank of ``bank_size``
    textures (_procedural_bank; "mixed": structured, dead-leaves and fBm;
    "structured": the first family only). An empty or absent image
    directory means the procedural bank alone. bank_refresh > 0 rebuilds
    the bank from seed + 1009 * (n // bank_refresh) before the n-th batch
    whenever n is a positive multiple of bank_refresh; the draws keep
    coming from the one rng."""
    if texture_style not in ("mixed", "structured"):
        raise ValueError(f"texture_style {texture_style!r}")
    rng = np.random.default_rng(seed)
    img_bank = load_image_dir(image_dir, hw) if image_dir else None
    if img_bank is None:
        image_fraction = 0.0
    proc_bank = None
    if image_fraction < 1.0:
        proc_bank = _procedural_bank(hw, seed, texture_style, rng, bank_size)
    n_yield = 0
    while True:
        if (bank_refresh > 0 and proc_bank is not None and n_yield > 0
                and n_yield % bank_refresh == 0):
            proc_bank = _procedural_bank(
                hw, seed + 1009 * (n_yield // bank_refresh), texture_style,
                rng, bank_size)
        n_yield += 1
        if proc_bank is None:
            yield img_bank[rng.integers(0, len(img_bank), size=batch)]
        elif image_fraction <= 0.0:
            yield proc_bank[rng.integers(0, len(proc_bank), size=batch)]
        else:
            use_img = rng.random(batch) < image_fraction
            out = proc_bank[rng.integers(0, len(proc_bank), size=batch)].copy()
            n_img = int(use_img.sum())
            if n_img:
                out[use_img] = img_bank[
                    rng.integers(0, len(img_bank), size=n_img)]
            yield out
