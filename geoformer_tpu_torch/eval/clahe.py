"""Contrast-limited adaptive histogram equalisation of uint8 images.

A numpy copy of what ``cv2.createCLAHE(clipLimit, tileGridSize).apply``
computes for CV_8U (imgproc/src/clahe.cpp), which the JAX package's retinal
enhancement calls:

- an image whose sides are not both multiples of the tile grid is padded
  at the bottom by ``ty - h % ty`` rows and at the right by ``tx - w % tx``
  columns with BORDER_REFLECT_101 (a whole tile of padding on a side that
  already divides, as OpenCV does);
- each tile's 256-bin histogram is clipped at
  ``max(int(clip * tile_area / 256), 1)``; the clipped counts go back
  ``clipped // 256`` to every bin, then the residual one count every
  ``max(256 // residual, 1)`` bins from bin 0;
- the LUT is ``saturate_cast<uchar>(cdf * (255.f / tile_area))`` in float32
  (round half to even);
- each pixel blends the LUTs of its four neighbouring tiles bilinearly in
  float32, with ``txf = x * (1.f / tile_w) - 0.5f`` and the outer tiles
  clamped, then rounds half to even.
"""

from __future__ import annotations

import numpy as np

HIST = 256


def _tile_luts(src: np.ndarray, tiles_y: int, tiles_x: int, th: int, tw: int,
               clip: float) -> np.ndarray:
    """[tiles_y, tiles_x, 256] uint8 LUTs of a padded image."""
    area = th * tw
    t = src.reshape(tiles_y, th, tiles_x, tw).transpose(0, 2, 1, 3)
    t = t.reshape(tiles_y * tiles_x, area).astype(np.int64)
    n = len(t)
    hist = np.zeros((n, HIST), np.int64)
    np.add.at(hist, (np.repeat(np.arange(n), area), t.ravel()), 1)
    if clip > 0:
        limit = max(int(clip * area / HIST), 1)
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit)
        batch = clipped // HIST
        residual = clipped - batch * HIST
        hist += batch[:, None]
        step = np.maximum(HIST // np.maximum(residual, 1), 1)
        i = np.arange(HIST)[None, :]
        # bins 0, step, 2 step, ... get one more, residual of them
        hist += ((i % step[:, None] == 0)
                 & (i // step[:, None] < residual[:, None])).astype(np.int64)
    cdf = np.cumsum(hist, 1).astype(np.float32)
    scale = np.float32(HIST - 1) / np.float32(area)
    lut = np.clip(np.rint(cdf * scale), 0, 255).astype(np.uint8)
    return lut.reshape(tiles_y, tiles_x, HIST)


def _axis_weights(n: int, tile: int, tiles: int):
    """(lower tile, upper tile, weight of the upper) of each of n rows or
    columns, in OpenCV's float32 arithmetic."""
    inv = np.float32(1.0) / np.float32(tile)
    f = np.arange(n, dtype=np.float32) * inv - np.float32(0.5)
    lo = np.floor(f).astype(np.int64)
    a = (f - lo.astype(np.float32)).astype(np.float32)
    return (np.maximum(lo, 0), np.minimum(lo + 1, tiles - 1), a,
            (np.float32(1.0) - a).astype(np.float32))


def clahe(img: np.ndarray, clip_limit: float = 2.0,
          tile_grid=(8, 8)) -> np.ndarray:
    """cv2.createCLAHE(clip_limit, tile_grid).apply(img) of a [h, w] uint8
    image (tile_grid is (tiles_x, tiles_y), as OpenCV takes it)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"clahe: a [h, w] uint8 image, got {img.dtype} "
                         f"{img.shape}")
    tiles_x, tiles_y = tile_grid
    h, w = img.shape
    src = img
    if w % tiles_x or h % tiles_y:
        src = np.pad(img, ((0, tiles_y - h % tiles_y),
                           (0, tiles_x - w % tiles_x)), mode="reflect")
    th, tw = src.shape[0] // tiles_y, src.shape[1] // tiles_x
    lut = _tile_luts(src, tiles_y, tiles_x, th, tw, clip_limit)
    lut = lut.astype(np.float32)
    y1, y2, ya, ya1 = _axis_weights(h, th, tiles_y)
    x1, x2, xa, xa1 = _axis_weights(w, tw, tiles_x)
    v = img.astype(np.int64)
    r1 = lut[y1[:, None], x1[None, :], v]          # upper row, left
    r2 = lut[y1[:, None], x2[None, :], v]
    r3 = lut[y2[:, None], x1[None, :], v]
    r4 = lut[y2[:, None], x2[None, :], v]
    top = r1 * xa1[None, :] + r2 * xa[None, :]
    bottom = r3 * xa1[None, :] + r4 * xa[None, :]
    res = top * ya1[:, None] + bottom * ya[:, None]
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
