"""The GAM's two attention kernels: CUDA on the card, plain torch beside them.

Counterpart of geoformer_tpu/ops/pallas_attention.py (forward halves only):

* K1 ``box_window_attention`` replaces ``_box_forward`` and its Pallas
  kernels ``_box_fwd_tiled_kernel`` (the default) and ``_box_fwd_kernel``
  (whole-KV, same out and LSE). Source: ``csrc/box_window_attention.cu``.
* K2 ``masked_kv_attention`` replaces ``_mka_forward`` and its Pallas kernel
  ``_mka_kernel``. Source: ``csrc/masked_kv_attention.cu``.

A wrapper given CPU tensors computes the plain version. Given CUDA tensors it
launches the kernel or raises; it never falls back. Each launch adds one to
``LAUNCHES[name]``, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from geoformer_tpu_torch.ops.attention import full_attention
from geoformer_tpu_torch.ops.cuda_lib import load_library

# name -> number of kernel launches since the last reset_launch_counts()
LAUNCHES = {"box_window_attention": 0, "masked_kv_attention": 0}

_HEAD_DIM = 64  # the kernels' compiled head width (d_model 256 / 4 heads)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_cuda_inputs(name, floats, others):
    """Same device, contiguous, and (q, k, v) aligned for paired loads."""
    dev = floats[0].device
    for t in floats + others:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in floats:
        if t.dtype != floats[0].dtype:
            raise TypeError(f"{name}: q, k, v dtypes differ")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must be 16-byte aligned")
    if floats[0].dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {floats[0].dtype} not supported "
                        f"(float32 or bfloat16)")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------- K1 -------

def box_window_attention_plain(q, k, v, centers, grid_hw, radius: int = 2,
                               mask_fill: float = -1e8):
    """Box-window attention over the whole token set (materializes
    [B, L, S, H]); the counterpart of box_attention_reference, plus the LSE.

    Returns (out [B, L, H, D] in q.dtype, lse [B, L, H] f32). Rows whose box
    misses the grid get out = 0 and lse = scale * mask_fill + log(S)."""
    hd, wd = grid_hw
    s = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    sidx = torch.arange(s, device=q.device, dtype=torch.int32)
    box = (((sidx % wd)[None, None, :] - centers[..., 0:1]).abs() <= radius) \
        & (((sidx // wd)[None, None, :] - centers[..., 1:2]).abs() <= radius)
    logits = torch.einsum("blhd,bshd->blsh", q.float(), k.float())
    z = scale * logits.masked_fill(~box[..., None], mask_fill)
    lse = torch.logsumexp(z, dim=2)
    out = torch.einsum("blsh,bshd->blhd", torch.softmax(z, dim=2), v.float())
    row_ok = box.any(dim=2)
    out = torch.where(row_ok[..., None, None], out, 0.0)
    return out.to(q.dtype), lse


def box_window_attention(q, k, v, centers, grid_hw, radius: int = 2,
                         mask_fill: float = -1e8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-free GAM cross attention: query l attends to the destination
    cells (sx, sy) with |sx - cx| <= r and |sy - cy| <= r around its centre.

    Args:
        q: [B, L, H, D]; k, v: [B, S, H, D] with S = grid_hw[0] * grid_hw[1].
        centers: [B, L, 2] int32 (cx, cy) in destination cells; off-grid
            values are allowed.
    Returns:
        (out [B, L, H, D] in q.dtype, lse [B, L, H] f32).
    """
    if q.device.type == "cpu":
        return box_window_attention_plain(q, k, v, centers, grid_hw, radius,
                                          mask_fill)
    if q.device.type != "cuda":
        raise ValueError(f"box_window_attention: no kernel for {q.device}")
    b, l, h, d = q.shape
    s = k.shape[1]
    hd, wd = grid_hw
    if (d != _HEAD_DIM or k.shape != (b, s, h, d) or v.shape != k.shape
            or centers.shape != (b, l, 2) or s != hd * wd):
        raise ValueError(
            f"box_window_attention: shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} centers "
            f"{tuple(centers.shape)} grid {grid_hw} (head dim must be "
            f"{_HEAD_DIM}, S = grid_h * grid_w)")
    if centers.dtype != torch.int32:
        raise TypeError("box_window_attention: centers must be int32")
    _check_cuda_inputs("box_window_attention", (q, k, v), (centers,))
    lib = load_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, l, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.gam_box_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), centers.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, l, s, h, hd, wd, radius,
            1.0 / math.sqrt(d), mask_fill, _DTYPES[q.dtype],
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"box_window_attention: CUDA launch error {err}")
    LAUNCHES["box_window_attention"] += 1
    return out, lse


# ---------------------------------------------------------------- K2 -------

def masked_kv_attention_plain(q, k, v, kv_mask, mask_fill: float = -1e8):
    """full_attention with a column mask, computed in f32 as the kernel
    contract has it (the TPU kernel accumulates in f32 and returns f32)."""
    return full_attention(q.float(), k.float(), v.float(), kv_mask=kv_mask,
                          mask_fill=mask_fill)


def masked_kv_attention(q, k, v, kv_mask, mask_fill: float = -1e8
                        ) -> torch.Tensor:
    """Masked-KV softmax attention. q: [B, L, H, D]; k, v: [B, S, H, D];
    kv_mask: [B, S] (true keeps the column). Returns f32 [B, L, H, D]; a
    batch row whose mask is all false gets the mean of its S value rows."""
    if q.device.type == "cpu":
        return masked_kv_attention_plain(q, k, v, kv_mask, mask_fill)
    if q.device.type != "cuda":
        raise ValueError(f"masked_kv_attention: no kernel for {q.device}")
    b, l, h, d = q.shape
    s = k.shape[1]
    if (d != _HEAD_DIM or s == 0 or k.shape != (b, s, h, d)
            or v.shape != k.shape or tuple(kv_mask.shape) != (b, s)):
        raise ValueError(
            f"masked_kv_attention: shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} mask "
            f"{tuple(kv_mask.shape)} (head dim must be {_HEAD_DIM}, S > 0)")
    mask = kv_mask.to(torch.bool).contiguous()
    _check_cuda_inputs("masked_kv_attention", (q, k, v), (mask,))
    lib = load_library()
    out = torch.empty((b, l, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.gam_masked_kv_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, l, s, h, 1.0 / math.sqrt(d), mask_fill,
            _DTYPES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"masked_kv_attention: CUDA launch error {err}")
    LAUNCHES["masked_kv_attention"] += 1
    return out
