"""Match figures and the GAM window view without matplotlib.

error_colors, dynamic_alpha and compose_pair are copies of the same
functions of geoformer_tpu/utils/plotting.py. render_matches draws what
the JAX make_matching_figure draws, the two images side by side on one
canvas with each match as a segment between its endpoints and a dot at
each end, green with dynamic_alpha(n) opacity by default, but with numpy
onto an RGB uint8 array at the canvas's own size: one-pixel aliased
segments and 3x3-pixel dots, blended in order. It is not pixel-equal to
matplotlib's figure, which renders the canvas at 75 dpi per 100 canvas
pixels with anti-aliased lines and round markers. render_geo_windows
draws make_geo_window_figure's view the same way, from the points of
geo_window_points. There is no font renderer: the JAX figures' text
("step N", "n matches", "no homography ...") goes into the image
summary's metadata (``summary_description``) or, for a figure file
(write_png), into a PNG text chunk, not into the pixels.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from geoformer_tpu_torch.utils.tb_events import encode_png


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


def _canvas_rgb(img0, img1):
    """(compose_pair's canvas as float64 RGB [H, W, 3], x offset of img1)."""
    canvas, x1 = compose_pair(np.asarray(img0), np.asarray(img1))
    rgb = np.repeat(np.clip(canvas, 0, 1)[..., None], 3, axis=-1)
    return rgb.astype(np.float64), x1


def _segment(rgb, a, b, color) -> None:
    """A one-pixel segment from a to b (x, y), each pixel blended once."""
    steps = int(np.ceil(np.abs(b - a).max())) + 1
    t = np.linspace(0.0, 1.0, steps)[:, None]
    seg = np.rint(a + t * (b - a)).astype(np.int64)
    _blend(rgb, seg[:, 1], seg[:, 0], color)


def _dot(rgb, p, color, half: int = 1) -> None:
    """A (2 half + 1)^2-pixel square dot at p (x, y)."""
    p = np.rint(p).astype(np.int64)
    d = np.arange(-half, half + 1)
    ys, xs = np.meshgrid(p[1] + d, p[0] + d, indexing="ij")
    _blend(rgb, ys.ravel(), xs.ravel(), color)


def _u8(rgb: np.ndarray) -> np.ndarray:
    return np.rint(rgb * 255).astype(np.uint8)


def render_matches(img0: np.ndarray, img1: np.ndarray, mkpts0: np.ndarray,
                   mkpts1: np.ndarray,
                   color: Optional[np.ndarray] = None) -> np.ndarray:
    """The match figure as [H, W0 + 10 + W1, 3] uint8: img0 and img1
    ([H, W] in [0, 1]) on compose_pair's canvas, a segment from each
    mkpts0 (x, y) to its mkpts1 on img1, and a dot at both ends, in
    ``color`` [n, 4] RGBA (default green at dynamic_alpha(n))."""
    rgb, x1 = _canvas_rgb(img0, img1)
    p0 = np.asarray(mkpts0, np.float64).reshape(-1, 2)
    p1 = np.asarray(mkpts1, np.float64).reshape(-1, 2) + np.array([x1, 0.0])
    n = len(p0)
    if color is None:
        color = np.broadcast_to(np.array([0.0, 1.0, 0.0, dynamic_alpha(n)]),
                                (n, 4))
    for a, b, c in zip(p0, p1, np.asarray(color, np.float64)):
        _segment(rgb, a, b, c)
        _dot(rgb, a, c)
        _dot(rgb, b, c)
    return _u8(rgb)


def geo_window_points(H: np.ndarray, hw0: Tuple[int, int],
                      hw1: Tuple[int, int], scale: int = 8,
                      window_size: int = 5, stride: int = 777, gap: int = 10):
    """What make_geo_window_figure (geoformer_tpu/utils/plotting.py:150-176)
    draws, in float64: every stride-th coarse cell of image0 ((h0, w0) =
    hw0) as a query pixel (x, y), its (2r+1)^2 window of cells around its
    warp by H into image1 ((h1, w1) = hw1), and the in-bounds window points
    on the canvas (x shifted by w0 + gap). Returns (queries [Q, 2] that
    keep at least one window point, window points [N, 2], segments
    [N, 2, 2] from each point's query to it)."""
    h0c, w0c = hw0[0] // scale, hw0[1] // scale
    h1, w1 = hw1
    x1 = hw0[1] + gap
    r = window_size // 2
    H = np.asarray(H, np.float64)
    ids = np.arange(0, h0c * w0c, stride)
    q = np.stack([(ids % w0c) * scale, (ids // w0c) * scale], -1).astype(
        np.float64)
    ph = np.concatenate([q, np.ones((len(q), 1))], 1) @ H.T
    ctr = ph[:, :2] / np.where(np.abs(ph[:, 2:]) < 1e-9, 1e-9, ph[:, 2:])
    offs = np.stack(np.meshgrid(np.arange(-r, r + 1) * scale,
                                np.arange(-r, r + 1) * scale,
                                indexing="xy"), -1).reshape(-1, 2)
    win = ctr[:, None, :] + offs[None]                      # [Q, W*W, 2]
    inb = ((win[..., 0] >= 0) & (win[..., 0] < w1)
           & (win[..., 1] >= 0) & (win[..., 1] < h1))
    keep = inb.any(1)
    pts = win[inb] + np.array([x1, 0.0])
    start = np.repeat(q, inb.sum(1), axis=0)
    return q[keep], pts, np.stack([start, pts], axis=1).reshape(-1, 2, 2)


NO_H_TEXT = "no homography (RANSAC failed) — cross layers identity"


def render_geo_windows(img0: np.ndarray, img1: np.ndarray, H: np.ndarray,
                       has_H: bool = True, scale: int = 8,
                       window_size: int = 5, stride: int = 777
                       ) -> np.ndarray:
    """The GAM window view as [H, W0 + 10 + W1, 3] uint8: where each
    (subsampled) image0 coarse cell looks in image1 under the fitted H,
    with geo_window_points' segments in green at alpha 0.08, the window
    points as lime 1-pixel dots and the query points as cyan 3x3 dots.
    With has_H false the cross layers were the identity and the canvas is
    bare (NO_H_TEXT says so, in the file's text)."""
    rgb, _ = _canvas_rgb(img0, img1)
    if not has_H:
        return _u8(rgb)
    qs, pts, segs = geo_window_points(H, np.shape(img0), np.shape(img1),
                                      scale, window_size, stride)
    for a, b in segs:
        _segment(rgb, a, b, np.array([0.0, 1.0, 0.0, 0.08]))
    for p in pts:
        _dot(rgb, p, np.array([0.0, 1.0, 0.0, 1.0]), half=0)
    for p in qs:
        _dot(rgb, p, np.array([0.0, 1.0, 1.0, 1.0]))
    return _u8(rgb)


def write_png(path: str, img: np.ndarray, text: Optional[str] = None
              ) -> None:
    """Write an [H, W] or [H, W, 3] uint8 image as a PNG
    (tb_events.encode_png); ``text`` goes into an iTXt chunk (UTF-8) with
    the keyword "Description"."""
    data = encode_png(img)
    if text is not None:
        body = b"Description\0\0\0\0\0" + text.encode("utf-8")
        chunk = (struct.pack(">I", len(body)) + b"iTXt" + body
                 + struct.pack(">I", zlib.crc32(b"iTXt" + body)))
        iend = len(data) - 12
        data = data[:iend] + chunk + data[iend:]
    with open(path, "wb") as f:
        f.write(data)


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
