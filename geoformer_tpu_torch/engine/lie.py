"""Lie group maps: SO(3)/SE(3) exp and log, f32-stable.

Counterpart of geoformer_tpu/engine/lie.py. Camera poses live in se(3)
tangent coordinates [w, v] (rotation first) during optimization.

Every small-angle ratio takes the double-where form (a safe argument
inside, the series selected outside), so forward-mode derivatives through
these maps (torch.func.jacfwd in engine/pnp.py) stay finite at the
identity.
"""

from __future__ import annotations

import contextlib

import torch

# Small-angle switch for the series branches. In f32 the closed forms break
# down long before 1e-5: (1 - cos th) is exactly 0 for th < ~3e-4, which
# turns A/(2B) into inf inside se3_log. At 1e-2 the two-term series are
# accurate to ~1e-12 relative.
_EPS = 1e-2


@contextlib.contextmanager
def full_f32():
    """Within the block, f32 matmuls and convolutions on CUDA run at full
    f32 (TF32 off), whatever the caller set; the flags are restored after.
    The engine's solves (PnP, the SL(3) graph) break at reduced
    precision."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinants of [..., 3, 3] matrices by the triple product: no LU,
    so no status check and no host sync on CUDA."""
    return (M[..., :, 0] * torch.linalg.cross(M[..., :, 1],
                                              M[..., :, 2])).sum(-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], dim=-2)


def _safe_ratios(w: torch.Tensor):
    """th^2, A = sin(th)/th, B = (1-cos th)/th^2, C = (th - sin th)/th^3,
    each [..., 1, 1], NaN-free in value and derivative at th = 0."""
    th2 = (w ** 2).sum(-1, keepdim=True)[..., None]
    small = th2 < _EPS ** 2
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1 - torch.cos(th)) / th2_safe)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2_safe * th))
    return th2, A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues. [..., 3] -> [..., 3, 3]."""
    _, A, B, _ = _safe_ratios(w)
    W = hat(w)
    return _eye3(W) + A * W + B * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]."""
    # keepdim: python scalars with a 0-dim tensor promote forward-mode
    # tangents to f64 (torch.func.jacfwd of an unbatched so3_log)
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos = torch.clamp((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    small = cos > 1.0 - _EPS ** 2
    cos_safe = torch.where(small, torch.zeros_like(cos), cos)
    th = torch.arccos(cos_safe)
    # th/(2 sin th): series 1/2 + th^2/12 near zero
    ratio_big = th / (2 * torch.sin(th))
    th2_approx = 2 * (1.0 - cos)  # th^2 + O(th^4)
    ratio = torch.where(small, 0.5 + th2_approx / 12.0, ratio_big)
    return ratio * vee


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] (w, v) -> [..., 4, 4] homogeneous transform."""
    w, v = xi[..., :3], xi[..., 3:]
    _, A, B, C = _safe_ratios(w)
    W = hat(w)
    W2 = W @ W
    eye = _eye3(W)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    # [0, 0, 0, 1] built on the device: no copy from the host
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])],
                       -1)[..., None, :]
    return torch.cat([top, bottom], -2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] (w, v)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    th2, A, B, _ = _safe_ratios(w)
    small = th2 < _EPS ** 2
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    W = hat(w)
    # V^{-1} = I - W/2 + coef * W^2, coef = (1 - A/(2B))/th^2 -> 1/12 at 0
    coef = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                       (1.0 - A / (2 * B)) / th2_safe)
    Vinv = _eye3(W) - W / 2 + coef * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T [..., 4, 4] applied to pts [..., N, 3]."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) \
        + T[..., None, :3, 3]
