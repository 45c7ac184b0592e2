"""Photometric augmentation stacks, as tensor ops on the images' device.

Counterpart of every function of geoformer_tpu/data/augment.py: the
'dark' and 'mobile' stacks, their stages (brightness/contrast, gamma,
gaussian noise, motion blur), and the camera-realism 'sensor' stack
(defocus -> vignette -> shot/read noise -> JPEG blocking).

Images are [B, H, W, 1] (the pair data's layout) or [B, H, W] in [0, 1],
and every function returns the shape it was given. (The JAX motion_blur
turns [B, H, W] into [B, H, W, 1], and its per-sample draws of shape
[B, 1, 1, 1] broadcast a [B, H, W] image to [B, B, H, W]; the port keeps
the input's shape, which is the JAX result for [B, H, W, 1].)

Every random stage takes its numbers from a torch.Generator, or as a dict
(``<stage>_draws`` makes it), so that a test can hand both packages the
numbers JAX draws. A draw is the value the stage uses (a brightness
offset, a JPEG quality), per sample of shape [B], or the standard normal
noise of the image's shape.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Draws = Dict[str, torch.Tensor]


def _uniform(b: int, lo: float, hi: float, generator, device) -> torch.Tensor:
    return torch.rand((b,), generator=generator, device=device) * (hi - lo) \
        + lo


def _per_sample(x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """[B] (or [B, k]) -> broadcastable against img [B, H, W(, 1)]."""
    return x.reshape(x.shape[0], *([1] * (img.ndim - 1)))


def _grey(img: torch.Tensor):
    """img -> ([B, H, W] view, function restoring img's shape)."""
    if img.ndim == 4:
        return img[..., 0], lambda x: x[..., None]
    return img, lambda x: x


def _depthwise(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-sample 2-D correlation with zero "SAME" padding: x [B, H, W],
    kernels [B, kh, kw] (odd sizes) -> [B, H, W]."""
    b, kh, kw = kernels.shape
    out = F.conv2d(x[None], kernels[:, None], padding=(kh // 2, kw // 2),
                   groups=b)
    return out[0]


# ---------------------------------------------------------------- stages --

def brightness_contrast_draws(shape, generator=None, device=None,
                              brightness: float = 0.2,
                              contrast: float = 0.2) -> Draws:
    """"bright" U(-brightness, brightness), "contrast" U(1 - contrast,
    1 + contrast), per sample."""
    b = shape[0]
    return {"bright": _uniform(b, -brightness, brightness, generator, device),
            "contrast": _uniform(b, 1 - contrast, 1 + contrast, generator,
                                 device)}


def random_brightness_contrast(img, generator=None, draws=None,
                               brightness: float = 0.2,
                               contrast: float = 0.2):
    if draws is None:
        draws = brightness_contrast_draws(img.shape, generator, img.device,
                                          brightness, contrast)
    return torch.clamp((img + _per_sample(draws["bright"], img))
                       * _per_sample(draws["contrast"], img), 0.0, 1.0)


def gamma_draws(shape, generator=None, device=None,
                gamma_range=(0.8, 1.2)) -> Draws:
    """"gamma" U(gamma_range), per sample."""
    return {"gamma": _uniform(shape[0], *gamma_range, generator, device)}


def random_gamma(img, generator=None, draws=None, gamma_range=(0.8, 1.2)):
    if draws is None:
        draws = gamma_draws(img.shape, generator, img.device, gamma_range)
    return torch.clamp(img, 1e-6, 1.0) ** _per_sample(draws["gamma"], img)


def noise_draws(shape, generator=None, device=None) -> Draws:
    """"noise": standard normal of the image's shape."""
    return {"noise": torch.randn(tuple(shape), generator=generator,
                                 device=device)}


def gaussian_noise(img, generator=None, draws=None, sigma: float = 0.02):
    if draws is None:
        draws = noise_draws(img.shape, generator, img.device)
    return torch.clamp(img + sigma * draws["noise"], 0.0, 1.0)


def motion_blur_draws(shape, generator=None, device=None) -> Draws:
    """"angle" U(0, pi), per sample."""
    return {"angle": _uniform(shape[0], 0.0, math.pi, generator, device)}


def motion_blur(img, generator=None, draws=None, max_kernel: int = 5):
    """Random-direction motion blur: a k x k soft line kernel (gaussian
    falloff from the oriented line through the centre), per sample."""
    if draws is None:
        draws = motion_blur_draws(img.shape, generator, img.device)
    k = max_kernel
    angle = draws["angle"].float()
    idx = torch.arange(k, dtype=torch.float32, device=img.device) \
        - (k - 1) / 2
    gy, gx = torch.meshgrid(idx, idx, indexing="ij")
    d = torch.abs(-torch.sin(angle)[:, None, None] * gx
                  + torch.cos(angle)[:, None, None] * gy)
    kern = torch.exp(-(d ** 2) / 0.5)
    kern = kern / kern.sum(dim=(1, 2), keepdim=True)          # [B, k, k]
    x, back = _grey(img)
    return back(_depthwise(x, kern))


def shot_read_noise_draws(shape, generator=None, device=None,
                          gain_range=(2e-4, 4e-3),
                          read_range=(1e-5, 4e-4)) -> Draws:
    """"gain" and "read", log-uniform over their ranges, per sample, and
    the standard normal "noise" of the image's shape."""
    b = shape[0]

    def logu(lo, hi):
        return torch.exp(_uniform(b, math.log(lo), math.log(hi), generator,
                                  device))

    return {"gain": logu(*gain_range), "read": logu(*read_range),
            **noise_draws(shape, generator, device)}


def shot_read_noise(img, generator=None, draws=None,
                    gain_range=(2e-4, 4e-3), read_range=(1e-5, 4e-4)):
    """Heteroscedastic sensor noise: variance = gain * signal + read^2."""
    if draws is None:
        draws = shot_read_noise_draws(img.shape, generator, img.device,
                                      gain_range, read_range)
    gain = _per_sample(draws["gain"], img)
    read2 = _per_sample(draws["read"], img) ** 2
    sigma = torch.sqrt(gain * torch.clamp(img, 0.0, 1.0) + read2)
    return torch.clamp(img + sigma * draws["noise"], 0.0, 1.0)


# libjpeg's luminance quantization table
_JPEG_LUMA_Q = (
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 35, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99))


def dct8_matrix(device=None) -> torch.Tensor:
    """The orthonormal 8-point DCT-II matrix (its inverse is its
    transpose), f32."""
    n = torch.arange(8, dtype=torch.float32, device=device)
    k = n[:, None]
    c = torch.cos((2 * n[None] + 1) * k * math.pi / 16)
    scale = torch.where(k == 0, torch.tensor(math.sqrt(1 / 8), device=device),
                        torch.tensor(math.sqrt(2 / 8), device=device))
    return scale * c


def jpeg_draws(shape, generator=None, device=None,
               quality_range=(30, 90)) -> Draws:
    """"quality" U(quality_range), per sample (not rounded, as in JAX)."""
    return {"quality": _uniform(shape[0], *quality_range, generator, device)}


def jpeg_blocking(img, generator=None, draws=None, quality_range=(30, 90)):
    """JPEG luma artifacts: 8x8 block DCT, quantization with libjpeg's
    luminance table at a random quality (its quality scaling), inverse DCT.
    H and W are padded to multiples of 8 by repeating the edge and cropped
    back; the quantization rounds half to even, as jnp.round does."""
    if draws is None:
        draws = jpeg_draws(img.shape, generator, img.device, quality_range)
    x, back = _grey(img)
    b, h, w = x.shape
    q = draws["quality"].float().reshape(b, 1, 1, 1, 1)
    scale = torch.where(q < 50, 5000.0 / q, 200.0 - 2.0 * q)
    table = torch.tensor(_JPEG_LUMA_Q, dtype=torch.float32, device=img.device)
    qtbl = torch.clamp(torch.floor((table * scale + 50.0) / 100.0), 1, 255)
    ph, pw = (-h) % 8, (-w) % 8
    x = F.pad(x[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
    hb, wb = (h + ph) // 8, (w + pw) // 8
    blocks = x.reshape(b, hb, 8, wb, 8).permute(0, 1, 3, 2, 4) * 255.0 \
        - 128.0
    D = dct8_matrix(img.device)
    coef = D @ blocks @ D.T
    coef = torch.round(coef / qtbl) * qtbl
    rec = (D.T @ coef @ D + 128.0) / 255.0
    out = rec.permute(0, 1, 3, 2, 4).reshape(b, hb * 8, wb * 8)[:, :h, :w]
    return back(torch.clamp(out, 0.0, 1.0))


def vignette_draws(shape, generator=None, device=None,
                   strength_range=(0.0, 0.6)) -> Draws:
    """"strength" U(strength_range) per sample, "center" U(-0.2, 0.2)
    [B, 2] (x, y offsets of the optical centre)."""
    b = shape[0]
    return {"strength": _uniform(b, *strength_range, generator, device),
            "center": torch.rand((b, 2), generator=generator, device=device)
            * 0.4 - 0.2}


def vignette(img, generator=None, draws=None, strength_range=(0.0, 0.6)):
    """Radial illumination falloff around a jittered optical centre."""
    if draws is None:
        draws = vignette_draws(img.shape, generator, img.device,
                               strength_range)
    h, w = img.shape[1:3]
    s = draws["strength"].float().reshape(-1, 1, 1)
    ctr = draws["center"].float()
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None]
    nx = (xx / (w - 1) - 0.5) * 2 - ctr[:, 0, None, None]
    ny = (yy / (h - 1) - 0.5) * 2 - ctr[:, 1, None, None]
    r2 = (nx ** 2 + ny ** 2) / 2.0
    fall = 1.0 - s * torch.clamp(r2, 0.0, 1.0)
    return img * (fall[..., None] if img.ndim == 4 else fall)


def defocus_draws(shape, generator=None, device=None,
                  sigma_range=(0.0, 1.6)) -> Draws:
    """"sigma" U(sigma_range), per sample."""
    return {"sigma": _uniform(shape[0], *sigma_range, generator, device)}


def defocus_blur(img, generator=None, draws=None, sigma_range=(0.0, 1.6),
                 ksize: int = 7):
    """Gaussian defocus with a per-sample sigma: a separable ksize-tap
    kernel (sigma floored at 0.05), zero "SAME" padding; a sample with
    sigma < 0.1 keeps its image exactly."""
    if draws is None:
        draws = defocus_draws(img.shape, generator, img.device, sigma_range)
    sig = draws["sigma"].float()[:, None]
    idx = torch.arange(ksize, dtype=torch.float32, device=img.device) \
        - (ksize - 1) / 2
    kern = torch.exp(-(idx[None] ** 2) / (2 * torch.clamp(sig, min=0.05) ** 2))
    kern = kern / kern.sum(-1, keepdim=True)                  # [B, k]
    x, back = _grey(img)
    x = _depthwise(x, kern[:, :, None])                       # along H
    x = _depthwise(x, kern[:, None, :])                       # along W
    keep = _per_sample(draws["sigma"] < 0.1, img)
    return torch.where(keep, img, back(x))


# ---------------------------------------------------------------- stacks --

def dark_aug_draws(shape, generator=None, device=None) -> Dict[str, Draws]:
    return {"brightness_contrast": brightness_contrast_draws(
                shape, generator, device, 0.4, 0.4),
            "gamma": gamma_draws(shape, generator, device, (1.0, 2.0)),
            "noise": noise_draws(shape, generator, device)}


def dark_aug(img, generator=None, draws=None):
    """'dark' stack: strong brightness/contrast drop, darkening gamma in
    [1, 2], noise 0.03."""
    if draws is None:
        draws = dark_aug_draws(img.shape, generator, img.device)
    img = random_brightness_contrast(img, draws=draws["brightness_contrast"])
    img = random_gamma(img, draws=draws["gamma"])
    return gaussian_noise(img, draws=draws["noise"], sigma=0.03)


def mobile_aug_draws(shape, generator=None, device=None) -> Dict[str, Draws]:
    return {"motion_blur": motion_blur_draws(shape, generator, device),
            "brightness_contrast": brightness_contrast_draws(
                shape, generator, device),
            "noise": noise_draws(shape, generator, device)}


def mobile_aug(img, generator=None, draws=None):
    """'mobile' stack: motion blur, brightness/contrast jitter, noise
    0.02."""
    if draws is None:
        draws = mobile_aug_draws(img.shape, generator, img.device)
    img = motion_blur(img, draws=draws["motion_blur"])
    img = random_brightness_contrast(img, draws=draws["brightness_contrast"])
    return gaussian_noise(img, draws=draws["noise"], sigma=0.02)


def sensor_aug_draws(shape, generator=None, device=None) -> Dict[str, Draws]:
    return {"defocus": defocus_draws(shape, generator, device),
            "vignette": vignette_draws(shape, generator, device),
            "noise": shot_read_noise_draws(shape, generator, device),
            "jpeg": jpeg_draws(shape, generator, device)}


def sensor_aug(img, generator=None, draws=None):
    """Camera-realism stack in physical order: defocus -> vignette ->
    shot/read noise -> JPEG."""
    if draws is None:
        draws = sensor_aug_draws(img.shape, generator, img.device)
    img = defocus_blur(img, draws=draws["defocus"])
    img = vignette(img, draws=draws["vignette"])
    img = shot_read_noise(img, draws=draws["noise"])
    return jpeg_blocking(img, draws=draws["jpeg"])


def build_augmentor(method: Optional[str]):
    """The stack named by ``method`` (None: the identity), called as
    ``aug(img, generator=None, draws=None)``."""
    if method is None:
        return lambda img, generator=None, draws=None: img
    stacks = {"dark": dark_aug, "mobile": mobile_aug, "sensor": sensor_aug}
    if method not in stacks:
        raise ValueError(f"unknown augmentor {method}")
    return stacks[method]
