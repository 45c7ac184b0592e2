"""Layers that hold f32 parameters and compute in the activation's type.

The JAX package keeps parameters in f32 and runs matmuls and convolutions
in the model's compute dtype (flax ``dtype=``); these layers do the same,
so one set of weights serves the f32 and the bf16 model. Parameter names
and layouts are PyTorch's ([out, in] for a dense kernel, OIHW for a
convolution); weights.py converts the JAX layouts. ``Int8Dense`` and
``Int8Conv`` hold the same parameters as ``Dense`` and ``Conv`` and compute
in dynamic int8 (ops/quantize.py), so the int8 toggle loads the same
checkpoints.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from geoformer_tpu_torch.core import mesh
from geoformer_tpu_torch.ops.quantize import int8_conv, int8_dense


def no_grad():
    """torch.no_grad() where autograd is on, and nothing where it is
    already off: a forward traced under no_grad (the serving export) then
    holds no grad-mode switches for torch.export to split around."""
    return (torch.no_grad() if torch.is_grad_enabled()
            else contextlib.nullcontext())


class Dense(nn.Module):
    """y = x W^T (+ b), computed in ``dtype`` (flax nn.Dense)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv(nn.Module):
    """Bias-free k x k convolution with (k//2) zero padding, NCHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride = stride
        self.padding = k // 2
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class Int8Dense(Dense):
    """Bias-free Dense computed in dynamic int8, output in ``dtype``
    (the JAX package's Int8Dense). Eval-only."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight).to(self.dtype)


class Int8Conv(Conv):
    """Conv computed in dynamic int8, output in ``dtype`` (the JAX
    package's Int8Conv). Eval-only."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv(x, self.weight, self.stride,
                         self.padding).to(self.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW (eps 1e-5, flax momentum 0.9), output in the
    input's type.

    Inference (``train=False``) normalizes with the running statistics
    (flax use_running_average). Training normalizes with the batch mean and
    the biased variance over (N, H, W), computed in f32 as flax computes them
    (E[x^2] - E[x]^2, clipped at 0), and updates the running statistics as
    flax does: ``ra <- 0.9 ra + 0.1 stat`` with the *biased* variance
    (F.batch_norm's training mode stores the unbiased one, so the update is
    written out). The update is in place.

    In a process group of several ranks (data parallelism, core/mesh.py)
    the batch statistics are the global batch's, as flax takes them under
    the JAX package's sharded step: each layer sums the stacked per-channel
    [sum x, sum x^2, count] over the ranks in one differentiable
    all-reduce, so every rank normalizes alike and keeps equal running
    statistics."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if mesh.world() > 1:
            c = xf.shape[1]
            n = torch.full((1,), xf.numel() // c, dtype=xf.dtype,
                           device=xf.device)
            stats = mesh.all_sum_grad(torch.cat([
                xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), n]))
            mean = stats[:c] / stats[-1]
            var = torch.clamp(stats[c:2 * c] / stats[-1] - mean * mean,
                              min=0.0)
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean.detach())
            self.running_var.mul_(m).add_((1 - m) * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Fill with N(0, 1/fan_in) truncated at two standard deviations, the
    flax default initializer, drawn from ``generator``."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(weight.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        weight.copy_(w)
