"""Self-supervised homography pairs from procedural textures.

Counterpart of make_pair_batch, load_image_dir and base_image_stream in
geoformer_tpu/data/synthetic.py: the host supplies base grayscale images
(the procedural bank of cpp/synthgen.cpp, an image directory, or a mix of
both); homography sampling, warping, photometric jitter, coarse validity
masks and the 50 % pair swap run as tensor ops on the device of the base
images.

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

from geoformer_tpu_torch.data.native import (
    native_textures,
    native_textures_mixed,
)
from geoformer_tpu_torch.eval.image_io import read_gray
from geoformer_tpu_torch.geometry.homography import (
    grid_points,
    sample_homography,
    sample_homography_draws,
    warp_points,
)
from geoformer_tpu_torch.ops.image_warp import warp_image
from geoformer_tpu_torch.ops.resize import resize_linear_u8


def pair_draws(b: int, hw: Tuple[int, int], generator=None,
               device=None) -> Dict[str, torch.Tensor]:
    """The random draws of make_pair_batch for b base images of size hw:
    those of sample_homography_draws, then per sample "bright" U(-0.1, 0.1),
    "contrast" U(0.8, 1.2), "gamma" U(0.75, 1.35), "u_blur" and "u_swap"
    U(0, 1), all [b], and the standard normal "noise" [b, H, W]."""
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
    return draws


def make_pair_batch(base: torch.Tensor, generator=None, coarse_scale: int = 8,
                    sensor: bool = False,
                    draws: Optional[Dict[str, torch.Tensor]] = None):
    """Turn base images [B, H, W] into supervised homography pairs.

    Sample H, warp, jitter the warped view (brightness, contrast, gamma, a
    3x3 box blur for 30 % of samples, noise 0.02), build coarse validity
    masks from the warp, and swap the pair (with H^-1) for half the samples.
    The draws come from ``generator`` (on the device of ``base``) unless
    given. sensor=True (the camera-realism stack) is not ported yet.

    Returns dict: image0/image1 [B, H, W, 1], H_0to1/H_1to0 [B, 3, 3],
    mask0/mask1 [B, H/8, W/8] (f32).
    """
    if sensor:
        raise NotImplementedError("sensor augmentation is not ported yet")
    b, h, w = base.shape
    if draws is None:
        draws = pair_draws(b, (h, w), generator, base.device)
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


def load_image_dir(root: str, hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """[n, H, W] float32 grey images in [0, 1] of every *.jpg, *.png and
    *.ppm file under ``root`` (sorted, recursive), each resized to hw as
    cv2.resize does; None if there is none. Unlike the JAX package, which
    skips the files cv2 cannot read, a file the port cannot decode (JPEG
    above all) raises ValueError."""
    paths = sorted(sum((glob.glob(os.path.join(root, "**", e), recursive=True)
                        for e in ("*.jpg", "*.png", "*.ppm")), []))
    if not paths:
        return None
    return np.stack([resize_linear_u8(read_gray(p), hw).astype(np.float32)
                     / 255.0 for p in paths])


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
    textures made by cpp/synthgen.cpp from ``seed`` ("mixed": structured,
    dead-leaves and fBm; "structured": the first family only). An empty or
    absent image directory means the procedural bank alone. bank_refresh is
    not ported yet."""
    if bank_refresh:
        raise NotImplementedError("bank_refresh is not ported yet")
    if texture_style not in ("mixed", "structured"):
        raise ValueError(f"texture_style {texture_style!r}")
    rng = np.random.default_rng(seed)
    img_bank = load_image_dir(image_dir, hw) if image_dir else None
    if img_bank is None:
        image_fraction = 0.0
    proc_bank = None
    if image_fraction < 1.0:
        gen = native_textures_mixed if texture_style == "mixed" \
            else native_textures
        proc_bank = gen(bank_size, hw[0], hw[1], seed)
    while True:
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
