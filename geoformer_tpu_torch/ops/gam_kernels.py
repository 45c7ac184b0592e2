"""The GAM's attention kernels: CUDA on the card, plain torch beside them.

Counterpart of geoformer_tpu/ops/pallas_attention.py:

* K1 ``box_window_attention_fwd`` replaces ``_box_forward`` and its Pallas
  kernels ``_box_fwd_tiled_kernel`` (the default) and ``_box_fwd_kernel``
  (whole-KV, same out and LSE). Source: ``csrc/box_window_attention.cu``.
* K5 and K4 ``box_window_attention_bwd`` replace ``_box_bwd_pallas`` and
  its kernels ``_box_bwd_dq_kernel`` and ``_box_bwd_dkv_kernel``. Source:
  ``csrc/box_window_attention_bwd.cu``.
* K2 ``masked_kv_attention_fwd`` replaces ``_mka_forward`` and its Pallas
  kernel ``_mka_kernel``. Source: ``csrc/masked_kv_attention.cu``.
* K3 ``masked_kv_attention_bwd`` replaces ``_mka_bwd_pallas`` and its
  kernel ``_mka_bwd_kernel``. Source: ``csrc/masked_kv_attention_bwd.cu``.

``box_window_attention`` and ``masked_kv_attention`` are the differentiable
ops (``torch.autograd.Function``, the counterparts of the two
``custom_vjp``s); the mask and the centres get no gradient.

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
LAUNCHES = {"box_window_attention": 0, "masked_kv_attention": 0,
            "masked_kv_attention_bwd": 0, "box_window_attention_bwd_dkv": 0,
            "box_window_attention_bwd_dq": 0}

_HEAD_DIM = 64  # the kernels' compiled head width (d_model 256 / 4 heads)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its accumulation type: f32 for f32 and bf16, f64 for f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch error {err}")
    LAUNCHES[name] += 1


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")


def _check_box_shapes(name, q, k, v, centers, grid_hw):
    b, l, h, d = q.shape
    s = k.shape[1]
    hd, wd = grid_hw
    if (d != _HEAD_DIM or k.shape != (b, s, h, d) or v.shape != k.shape
            or centers.shape != (b, l, 2) or s != hd * wd):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} centers {tuple(centers.shape)} grid {grid_hw} "
            f"(head dim must be {_HEAD_DIM}, S = grid_h * grid_w)")
    if centers.dtype != torch.int32:
        raise TypeError(f"{name}: centers must be int32")


def _check_mka_shapes(name, q, k, v, kv_mask):
    b, l, h, d = q.shape
    s = k.shape[1]
    if (d != _HEAD_DIM or s == 0 or k.shape != (b, s, h, d)
            or v.shape != k.shape or tuple(kv_mask.shape) != (b, s)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} mask {tuple(kv_mask.shape)} (head dim must "
            f"be {_HEAD_DIM}, S > 0)")


# ---------------------------------------------------------------- K1 -------

def _box_mask(centers, grid_hw, radius, s, device):
    """[B, L, S] box membership of every destination cell."""
    wd = grid_hw[1]
    sidx = torch.arange(s, device=device, dtype=torch.int32)
    return (((sidx % wd)[None, None, :] - centers[..., 0:1]).abs()
            <= radius) & (((sidx // wd)[None, None, :]
                           - centers[..., 1:2]).abs() <= radius)


def box_window_attention_plain(q, k, v, centers, grid_hw, radius: int = 2,
                               mask_fill: float = -1e8):
    """Box-window attention over the whole token set (materializes
    [B, L, S, H]); the counterpart of box_attention_reference, plus the LSE.

    Returns (out [B, L, H, D] in q.dtype, lse [B, L, H] in the accumulation
    type, f32 for f32 and bf16). Rows whose box misses the grid get out = 0
    and lse = scale * mask_fill + log(S)."""
    s = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    box = _box_mask(centers, grid_hw, radius, s, q.device)
    logits = torch.einsum("blhd,bshd->blsh", _acc(q), _acc(k))
    z = scale * logits.masked_fill(~box[..., None], mask_fill)
    lse = torch.logsumexp(z, dim=2)
    out = torch.einsum("blsh,bshd->blhd", torch.softmax(z, dim=2), _acc(v))
    row_ok = box.any(dim=2)
    out = torch.where(row_ok[..., None, None], out, 0.0)
    return out.to(q.dtype), lse


def box_window_attention_fwd(q, k, v, centers, grid_hw, radius: int = 2,
                             mask_fill: float = -1e8
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1. Gather-free GAM cross attention: query l attends to the
    destination cells (sx, sy) with |sx - cx| <= r and |sy - cy| <= r
    around its centre.

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
    _require_cuda("box_window_attention", q)
    _check_box_shapes("box_window_attention", q, k, v, centers, grid_hw)
    _check_cuda_inputs("box_window_attention", (q, k, v), (centers,))
    b, l, h, d = q.shape
    s = k.shape[1]
    hd, wd = grid_hw
    lib = load_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, l, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("box_window_attention", lib.gam_box_window_attention,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), centers.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, l, s, h, hd, wd, radius,
                1.0 / math.sqrt(d), mask_fill, _DTYPES[q.dtype],
                _stream(q.device))
    return out, lse


# ------------------------------------------------------------- K4, K5 ------

def box_window_attention_bwd_plain(q, k, v, centers, out, lse, g, grid_hw,
                                   radius: int = 2):
    """K1's backward by the explicit formulas of the TPU kernels K4/K5,
    from the forward's out and LSE (materializes [B, L, S, H]):

        p = exp(scale q.k - lse) on in-box cells of rows whose box meets the
        grid, 0 elsewhere; delta = rowsum(g * out);
        dl = p (g.v - delta) scale; dq = dl k; dk = dl^T q; dv = p^T g.

    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    s = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, ga = _acc(q), _acc(k), _acc(v), _acc(g)
    box = _box_mask(centers, grid_hw, radius, s, q.device)[..., None]
    delta = (ga * _acc(out)).sum(-1)                           # [B, L, H]
    z = scale * torch.einsum("blhd,bshd->blsh", qa, ka) \
        - lse.to(qa.dtype)[:, :, None, :]
    p = torch.exp(z.masked_fill(~box, float("-inf")))
    dp = torch.einsum("blhd,bshd->blsh", ga, va)
    dl = p * (dp - delta[:, :, None, :]) * scale
    dq = torch.einsum("blsh,bshd->blhd", dl, ka)
    dk = torch.einsum("blsh,blhd->bshd", dl, qa)
    dv = torch.einsum("blsh,blhd->bshd", p, ga)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _box_bwd_launch(name, fn, q, k, v, centers, gf, lse, delta, outs,
                    scratch, grid_hw, radius):
    """Checks the inputs of K4/K5 and launches one of them."""
    _require_cuda(name, q)
    _check_box_shapes(name, q, k, v, centers, grid_hw)
    if gf.shape != q.shape or gf.dtype != torch.float32 or \
            lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"{name}: g must be f32 {tuple(q.shape)}, lse and "
                         f"delta f32 {tuple(q.shape[:3])}")
    _check_cuda_inputs(name, (q, k, v), (centers, gf, lse, delta))
    b, l, h, d = q.shape
    hd, wd = grid_hw
    with torch.cuda.device(q.device):
        _launch(name, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                gf.data_ptr(), centers.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), *(t.data_ptr() for t in scratch + outs),
                b, l, k.shape[1], h, hd, wd, radius, 1.0 / math.sqrt(d),
                _DTYPES[q.dtype], _stream(q.device))


def box_window_attention_bwd_dq(q, k, v, centers, lse, delta, gf, grid_hw,
                                radius: int = 2) -> torch.Tensor:
    """K5: f32 dq [B, L, H, D] of box-window attention from the forward's
    LSE, delta = rowsum(g * out) and the f32 output gradient gf (all
    contiguous, on the card; box_window_attention_bwd is the entry point
    that also takes CPU tensors)."""
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _box_bwd_launch("box_window_attention_bwd_dq",
                    load_library().gam_box_window_attention_bwd_dq, q, k, v,
                    centers, gf, lse, delta, [dq], [], grid_hw, radius)
    return dq


def box_window_attention_bwd_dkv(q, k, v, centers, lse, delta, gf, grid_hw,
                                 radius: int = 2):
    """K4: f32 (dk, dv) [B, S, H, D] of box-window attention, inputs as
    box_window_attention_bwd_dq. Scratch: the queries bucketed by centre
    cell (int32 starts [B, (Hg + 2r)(Wg + 2r) + 1] and order [B, L])."""
    b, l = q.shape[:2]
    hd, wd = grid_hw
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    starts = torch.empty((b, (hd + 2 * radius) * (wd + 2 * radius) + 1),
                         dtype=torch.int32, device=q.device)
    order = torch.empty((b, l), dtype=torch.int32, device=q.device)
    _box_bwd_launch("box_window_attention_bwd_dkv",
                    load_library().gam_box_window_attention_bwd_dkv, q, k, v,
                    centers, gf, lse, delta, [dk, dv], [starts, order],
                    grid_hw, radius)
    return dk, dv


def box_window_attention_bwd(q, k, v, centers, out, lse, g, grid_hw,
                             radius: int = 2):
    """K5 (dq) and K4 (dk/dv): the backward of box_window_attention_fwd
    from its out and LSE. delta = rowsum(g * out) is a torch op, as in the
    JAX package. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    if q.device.type == "cpu":
        return box_window_attention_bwd_plain(q, k, v, centers, out, lse, g,
                                              grid_hw, radius)
    _require_cuda("box_window_attention_bwd", q)
    gf = g.float().contiguous()
    lse = lse.float().contiguous()
    delta = (gf * out.float()).sum(-1).contiguous()
    dq = box_window_attention_bwd_dq(q, k, v, centers, lse, delta, gf,
                                     grid_hw, radius)
    dk, dv = box_window_attention_bwd_dkv(q, k, v, centers, lse, delta, gf,
                                          grid_hw, radius)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BoxWindowAttention(torch.autograd.Function):
    """Counterpart of the custom_vjp of box_window_attention
    (pallas_attention.py:499,613,686-704): K1 forward, K5/K4 backward from
    the saved out and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, centers, grid_hw, radius, mask_fill):
        out, lse = box_window_attention_fwd(q, k, v, centers, grid_hw,
                                            radius, mask_fill)
        ctx.save_for_backward(q, k, v, centers, out, lse)
        ctx.grid_hw, ctx.radius = grid_hw, radius
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, centers, out, lse = ctx.saved_tensors
        dq, dk, dv = box_window_attention_bwd(q, k, v, centers, out, lse, g,
                                              ctx.grid_hw, ctx.radius)
        return dq, dk, dv, None, None, None, None


def box_window_attention(q, k, v, centers, grid_hw, radius: int = 2,
                         mask_fill: float = -1e8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable K1 (backward K5/K4): (out, lse) as
    box_window_attention_fwd; the LSE and the centres get no gradient."""
    return _BoxWindowAttention.apply(q, k, v, centers, tuple(grid_hw),
                                     radius, mask_fill)


# ---------------------------------------------------------------- K2 -------

def masked_kv_attention_plain(q, k, v, kv_mask, mask_fill: float = -1e8):
    """full_attention with a column mask, computed in f32 (f64 for f64) as
    the kernel contract has it (the TPU kernel accumulates in f32 and returns
    f32)."""
    return full_attention(_acc(q), _acc(k), _acc(v), kv_mask=kv_mask,
                          mask_fill=mask_fill)


def masked_kv_attention_fwd(q, k, v, kv_mask, mask_fill: float = -1e8
                            ) -> torch.Tensor:
    """K2. Masked-KV softmax attention. q: [B, L, H, D]; k, v: [B, S, H, D];
    kv_mask: [B, S] (true keeps the column). Returns f32 [B, L, H, D]; a
    batch row whose mask is all false gets the mean of its S value rows."""
    if q.device.type == "cpu":
        return masked_kv_attention_plain(q, k, v, kv_mask, mask_fill)
    _require_cuda("masked_kv_attention", q)
    _check_mka_shapes("masked_kv_attention", q, k, v, kv_mask)
    b, l, h, d = q.shape
    s = k.shape[1]
    mask = kv_mask.to(torch.bool).contiguous()
    _check_cuda_inputs("masked_kv_attention", (q, k, v), (mask,))
    lib = load_library()
    out = torch.empty((b, l, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("masked_kv_attention", lib.gam_masked_kv_attention,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), b, l, s, h, 1.0 / math.sqrt(d), mask_fill,
                _DTYPES[q.dtype], _stream(q.device))
    return out


# ---------------------------------------------------------------- K3 -------

def masked_kv_attention_bwd_plain(q, k, v, kv_mask, g,
                                  mask_fill: float = -1e8):
    """The counterpart of _mka_bwd_jnp (pallas_attention.py:194-209),
    computed in f32 (f64 for f64): materializes [B, L, S, H]. Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, ga = _acc(q), _acc(k), _acc(v), _acc(g)
    keep = kv_mask[:, None, :, None].to(torch.bool)
    logits = torch.einsum("blhd,bshd->blsh", qa, ka).masked_fill(~keep,
                                                                 mask_fill)
    attn = torch.softmax(scale * logits, dim=2)
    dv = torch.einsum("blsh,blhd->bshd", attn, ga)
    d_attn = torch.einsum("blhd,bshd->blsh", ga, va)
    dot = (attn * d_attn).sum(dim=2, keepdim=True)
    dl = (attn * (d_attn - dot) * scale).masked_fill(~keep, 0.0)
    dq = torch.einsum("blsh,bshd->blhd", dl, ka)
    dk = torch.einsum("blsh,blhd->bshd", dl, qa)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def masked_kv_attention_bwd(q, k, v, kv_mask, g, mask_fill: float = -1e8):
    """K3: the backward of masked_kv_attention_fwd for the output gradient
    g [B, L, H, D]. Returns (dq, dk, dv) in the dtypes of q, k, v; a row
    whose mask is all false gets dv = colsum(g) / S and dq = dk = 0."""
    if q.device.type == "cpu":
        return masked_kv_attention_bwd_plain(q, k, v, kv_mask, g, mask_fill)
    _require_cuda("masked_kv_attention_bwd", q)
    _check_mka_shapes("masked_kv_attention_bwd", q, k, v, kv_mask)
    b, l, h, d = q.shape
    s = k.shape[1]
    gf = g.float().contiguous()
    if gf.shape != q.shape:
        raise ValueError("masked_kv_attention_bwd: g shape")
    mask = kv_mask.to(torch.bool).contiguous()
    _check_cuda_inputs("masked_kv_attention_bwd", (q, k, v), (mask, gf))
    lib = load_library()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    # per-row max, log-denominator and rowsum(attn * g.v), pass 1 -> pass 2
    stats = torch.empty((3, b, l, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("masked_kv_attention_bwd", lib.gam_masked_kv_attention_bwd,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                gf.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
                b, l, s, h,
                1.0 / math.sqrt(d), mask_fill, _DTYPES[q.dtype],
                _stream(q.device))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _MaskedKVAttention(torch.autograd.Function):
    """Counterpart of the custom_vjp of masked_kv_attention
    (pallas_attention.py:52,106,212-229): K2 forward, K3 backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, mask_fill):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.mask_fill = mask_fill
        return masked_kv_attention_fwd(q, k, v, kv_mask, mask_fill)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        dq, dk, dv = masked_kv_attention_bwd(q, k, v, kv_mask, g,
                                             ctx.mask_fill)
        return dq, dk, dv, None, None


def masked_kv_attention(q, k, v, kv_mask, mask_fill: float = -1e8
                        ) -> torch.Tensor:
    """Differentiable K2 (backward K3), as masked_kv_attention_fwd; the
    mask gets no gradient."""
    return _MaskedKVAttention.apply(q, k, v, kv_mask, mask_fill)
