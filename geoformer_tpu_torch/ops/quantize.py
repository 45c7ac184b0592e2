"""Dynamic int8 quantization for the eval-only int8 paths.

Counterpart of geoformer_tpu/ops/quantize.py: symmetric scales, one per
tensor for activations and one per output channel for weights, each
``max(amax, 1e-8) / 127``; values divided by their scale in f32, rounded
half to even and clipped to +-127; products accumulated in int32 and
dequantized as ``y.float() * (sx * sw)``, the scales multiplied first. Done
in this order, the integers and the f32 results are the JAX package's bit
for bit.

The products are ``torch._int_mm`` (cuBLASLt's int8 path on the card, a
plain int32 product on the CPU). On the card it takes more than 16 rows and
K and N multiples of 8, so operands are padded with zeros, which is exact;
a refusal raises, and no float product stands in for it. A convolution is
an im2col of the int8 values (strided views, one copy) times the weights.
Parameters stay f32 and checkpoints are unchanged. round() has no gradient,
so the models refuse int8 with ``train=True``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_MIN_ROWS = 17   # _int_mm on CUDA: more than 16 rows
_ALIGN = 8       # _int_mm on CUDA: K and N multiples of 8


def quantize_symmetric(x: torch.Tensor, dims: Optional[Sequence[int]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32) with x ~= q * scale. dims=None: one scale for the
    whole tensor; else the max-abs is reduced over ``dims`` (kept, so the
    scale broadcasts against x)."""
    x = x.float()
    if dims is None:
        lo, hi = torch.aminmax(x)
        amax = torch.maximum(-lo, hi)
    else:
        amax = x.abs().amax(dim=tuple(dims), keepdim=True)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which is an ulp off the quotient the CPU and XLA give
    scale = torch.clamp(amax, min=1e-8) / amax.new_tensor(127.0)
    q = (x / scale).round_().clamp_(-127.0, 127.0).to(torch.int8)
    return q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 -> [M, N] int32 through torch._int_mm, the
    operands zero-padded to its card-side shape rules (more than 16 rows;
    K and N multiples of 8)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, _MIN_ROWS), _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    y = torch._int_mm(a.contiguous(), b)
    return y[:m, :n] if (mp, np_) != (m, n) else y


def _dequant(y: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor):
    return y.float() * (sx * sw)


def int8_dense(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [..., Cin] times a dense weight [Cout, Cin] (torch layout) in int8
    with int32 accumulation; f32 out [..., Cout]."""
    xq, sx = quantize_symmetric(x)
    wq, sw = quantize_symmetric(weight, dims=(1,))       # [Cout, 1]
    y = int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    y = _dequant(y, sx, sw.reshape(-1))
    return y.reshape(*x.shape[:-1], weight.shape[0])


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, pad: int,
            k_cols: int) -> Tuple[torch.Tensor, int, int]:
    """NCHW int8 -> [N*Ho*Wo, k_cols] rows of (C, kh, kw) windows, zero
    padded on the image border and to k_cols columns."""
    n, c = xq.shape[:2]
    if pad:
        xq = F.pad(xq, (pad, pad, pad, pad))
    win = xq.unfold(2, kh, stride).unfold(3, kw, stride)  # [N,C,Ho,Wo,kh,kw]
    ho, wo = win.shape[2:4]
    k = c * kh * kw
    cols = xq.new_zeros((n, ho, wo, k_cols))
    cols[..., :k].view(n, ho, wo, c, kh, kw).copy_(
        win.permute(0, 2, 3, 1, 4, 5))
    return cols.view(n * ho * wo, k_cols), ho, wo


def conv_int32(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """The int32 accumulation of an int8 convolution: NCHW int8 x OIHW int8
    -> [N, Ho, Wo, Cout] int32 (channels last)."""
    cout, cin, kh, kw = wq.shape
    k = cin * kh * kw
    kp = _round_up(k, _ALIGN)
    cols, ho, wo = _im2col(xq, kh, kw, stride, padding, kp)
    wmat = F.pad(wq.reshape(cout, k), (0, kp - k)).t()   # [Kp, Cout]
    return int_mm(cols, wmat).reshape(xq.shape[0], ho, wo, cout)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """NCHW x OIHW convolution in int8 with int32 accumulation: f32 out =
    conv(q(x), q(w)) * scale_x * scale_w[out channel], NCHW."""
    xq, sx = quantize_symmetric(x)
    wq, sw = quantize_symmetric(weight, dims=(1, 2, 3))  # [Cout, 1, 1, 1]
    y = _dequant(conv_int32(xq, wq, stride, padding), sx, sw.reshape(-1))
    return y.permute(0, 3, 1, 2)
