"""Match figures without matplotlib.

error_colors, dynamic_alpha and compose_pair are copies of the same
functions of geoformer_tpu/utils/plotting.py. render_matches draws what
the JAX make_matching_figure draws, the two images side by side on one
canvas with each match as a segment between its endpoints and a dot at
each end, green with dynamic_alpha(n) opacity by default, but with numpy
onto an RGB uint8 array at the canvas's own size: one-pixel aliased
segments and 3x3-pixel dots, blended in order. It is not pixel-equal to
matplotlib's figure, which renders the canvas at 75 dpi per 100 canvas
pixels with anti-aliased lines and round markers. The JAX figure's text
box ("step N", "n matches") goes into the image summary's metadata
(``summary_description``), not into the pixels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def error_colors(errs: np.ndarray, thr: float, alpha: float = 1.0):
    """Green->red by err/(2*thr) (plotting.py:9-19 color ramp)."""
    x = 1.0 - np.clip(errs / (thr * 2), 0, 1)
    c = np.clip(np.stack([2 - x * 2, x * 2, np.zeros_like(x)], -1), 0, 1)
    return np.concatenate([c, np.full_like(c[:, :1], alpha)], -1)


def dynamic_alpha(n: int) -> float:
    """Fewer lines -> more opaque (plotting.py:139-156 semantics)."""
    if n == 0:
        return 1.0
    milestones = [(0, 1.0), (300, 0.4), (1000, 0.1), (2000, 0.02)]
    for (a, va), (b_, vb) in zip(milestones[:-1], milestones[1:]):
        if n <= b_:
            return va + (n - a) / (b_ - a) * (vb - va)
    return 0.02


def compose_pair(img0: np.ndarray, img1: np.ndarray, gap: int = 10):
    """Stack two grayscale images side by side on one canvas.

    Returns (canvas [H, W], x_offset of img1 on the canvas).
    """
    h = max(img0.shape[0], img1.shape[0])
    w = img0.shape[1] + gap + img1.shape[1]
    canvas = np.ones((h, w), np.float32)
    canvas[: img0.shape[0], : img0.shape[1]] = img0
    x1 = img0.shape[1] + gap
    canvas[: img1.shape[0], x1: x1 + img1.shape[1]] = img1
    return canvas, x1


def _blend(rgb: np.ndarray, ys: np.ndarray, xs: np.ndarray,
           color: np.ndarray) -> None:
    """Alpha-blend RGBA ``color`` onto the pixels (ys, xs) that lie on
    the canvas, each once."""
    h, w = rgb.shape[:2]
    on = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    flat = np.unique(ys[on] * w + xs[on])
    px = rgb.reshape(-1, 3)
    px[flat] = (1 - color[3]) * px[flat] + color[3] * color[:3]


def render_matches(img0: np.ndarray, img1: np.ndarray, mkpts0: np.ndarray,
                   mkpts1: np.ndarray,
                   color: Optional[np.ndarray] = None) -> np.ndarray:
    """The match figure as [H, W0 + 10 + W1, 3] uint8: img0 and img1
    ([H, W] in [0, 1]) on compose_pair's canvas, a segment from each
    mkpts0 (x, y) to its mkpts1 on img1, and a dot at both ends, in
    ``color`` [n, 4] RGBA (default green at dynamic_alpha(n))."""
    canvas, x1 = compose_pair(np.asarray(img0), np.asarray(img1))
    rgb = np.repeat(np.clip(canvas, 0, 1)[..., None], 3, axis=-1) \
        .astype(np.float64)
    p0 = np.asarray(mkpts0, np.float64).reshape(-1, 2)
    p1 = np.asarray(mkpts1, np.float64).reshape(-1, 2) + np.array([x1, 0.0])
    n = len(p0)
    if color is None:
        color = np.broadcast_to(np.array([0.0, 1.0, 0.0, dynamic_alpha(n)]),
                                (n, 4))
    dot = np.arange(-1, 2)
    for a, b, c in zip(p0, p1, np.asarray(color, np.float64)):
        steps = int(np.ceil(np.abs(b - a).max())) + 1
        t = np.linspace(0.0, 1.0, steps)[:, None]
        seg = np.rint(a + t * (b - a)).astype(np.int64)
        _blend(rgb, seg[:, 1], seg[:, 0], c)
        for end in np.rint([a, b]).astype(np.int64):
            ys, xs = np.meshgrid(end[1] + dot, end[0] + dot, indexing="ij")
            _blend(rgb, ys.ravel(), xs.ravel(), c)
    return np.rint(rgb * 255).astype(np.uint8)


def log_val_match_figure(writer, out, batch, step: int,
                         tag: str = "val/matches") -> None:
    """Write the first pair's predicted matches as an image summary.

    ``writer``: a tb_events.EventWriter; ``out``: the model's MatchOutput
    (its ``.fine.mkpts0/mkpts1/valid``); ``batch``: image0/image1
    [B, H, W, 1] in [0, 1]. The figure's text ("step N", "n matches")
    is the summary's description."""
    ok = out.fine.valid[0].cpu().numpy().astype(bool)
    mk0 = out.fine.mkpts0[0].float().cpu().numpy()[ok]
    mk1 = out.fine.mkpts1[0].float().cpu().numpy()[ok]
    img0 = batch["image0"][0, ..., 0].float().cpu().numpy()
    img1 = batch["image1"][0, ..., 0].float().cpu().numpy()
    writer.add_image(tag, render_matches(img0, img1, mk0, mk1), step,
                     description=f"step {step}\n{int(ok.sum())} matches")
