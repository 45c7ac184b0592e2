"""Homography image warping (bilinear, zero border).

Counterpart of geoformer_tpu/ops/image_warp.py. Convention of
cv2.warpPerspective(src, M): the output at destination pixel p takes the
value src[M^{-1} p].
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.geometry.homography import grid_points, warp_points


def warp_image(img: torch.Tensor, H: torch.Tensor,
               inverse_map: bool = False) -> torch.Tensor:
    """Warp img [B, H, W, C] by per-sample homographies H [B, 3, 3]
    (src -> dst unless ``inverse_map``). Returns [B, H, W, C], zeros
    outside the source."""
    b, h, w, c = img.shape
    Minv = H if inverse_map else torch.linalg.inv(H)
    src = warp_points(grid_points(h, w, device=img.device)[None], Minv)  # [B, HW, 2]
    x, y = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(b, h * w, c)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        vals = torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))
        return torch.where(inb[..., None], vals, torch.zeros_like(vals))

    out = (tap(x0i, y0i) * (1 - fx) * (1 - fy)
           + tap(x0i + 1, y0i) * fx * (1 - fy)
           + tap(x0i, y0i + 1) * (1 - fx) * fy
           + tap(x0i + 1, y0i + 1) * fx * fy)
    return out.reshape(b, h, w, c)
