"""ResNet-FPN feature backbone.

Counterpart of geoformer_tpu/models/backbone.py (ResNetFPN, the (8, 2)
ladder): a 1-channel 7x7/2 stem, three 2-block residual stages at 1/2, 1/4
and 1/8, and a top-down FPN with aligned-corner bilinear upsampling and
leaky_relu(0.01). BatchNorm runs with running statistics, or with batch
statistics over all the images given (and updates the running ones) when
``train`` is set. Inputs and outputs keep the JAX layout (channels last);
inside, the layers run NCHW.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from geoformer_tpu_torch.models.layers import BatchNorm, Conv
from geoformer_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, dtype)
        self.bn2 = BatchNorm(planes)
        self.stride = stride
        if stride != 1:
            self.conv_down = Conv(cin, planes, 1, stride, dtype)
            self.bn_down = BatchNorm(planes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.stride != 1:
            x = self.bn_down(self.conv_down(x), train)
        return F.relu(x + y)


class ResNetFPN(nn.Module):
    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256),
                 dtype=torch.float32):
        super().__init__()
        d1, d2, d3 = block_dims
        self.dtype = dtype
        self.conv1 = Conv(1, initial_dim, 7, 2, dtype)
        self.bn1 = BatchNorm(initial_dim)
        self.layer1_0 = BasicBlock(initial_dim, d1, 1, dtype)
        self.layer1_1 = BasicBlock(d1, d1, 1, dtype)
        self.layer2_0 = BasicBlock(d1, d2, 2, dtype)
        self.layer2_1 = BasicBlock(d2, d2, 1, dtype)
        self.layer3_0 = BasicBlock(d2, d3, 2, dtype)
        self.layer3_1 = BasicBlock(d3, d3, 1, dtype)
        self.l3_out = Conv(d3, d3, 1, 1, dtype)
        self.l2_out = Conv(d2, d3, 1, 1, dtype)
        self.l2_m1 = Conv(d3, d3, 3, 1, dtype)
        self.l2_bn = BatchNorm(d3)
        self.l2_m2 = Conv(d3, d2, 3, 1, dtype)
        self.l1_out = Conv(d1, d2, 1, 1, dtype)
        self.l1_m1 = Conv(d2, d2, 3, 1, dtype)
        self.l1_bn = BatchNorm(d2)
        self.l1_m2 = Conv(d2, d1, 3, 1, dtype)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, 1] in [0, 1]. Returns (coarse [B, H/8, W/8, d3],
        fine [B, H/2, W/2, d1]), channels last."""
        x = x.permute(0, 3, 1, 2)
        x0 = F.relu(self.bn1(self.conv1(x), train))
        x1 = self.layer1_1(self.layer1_0(x0, train), train)      # 1/2
        x2 = self.layer2_1(self.layer2_0(x1, train), train)      # 1/4
        x3 = self.layer3_1(self.layer3_0(x2, train), train)      # 1/8

        x3_out = self.l3_out(x3)
        x2_out = self.l2_out(x2)
        m2 = x2_out + resize_bilinear_align_corners_nchw(
            x3_out, x2_out.shape[2:])
        m2 = F.leaky_relu(self.l2_bn(self.l2_m1(m2), train), 0.01)
        x2_out = self.l2_m2(m2)

        x1_out = self.l1_out(x1)
        m1 = x1_out + resize_bilinear_align_corners_nchw(
            x2_out, x1_out.shape[2:])
        m1 = F.leaky_relu(self.l1_bn(self.l1_m1(m1), train), 0.01)
        x1_out = self.l1_m2(m1)
        return x3_out.permute(0, 2, 3, 1), x1_out.permute(0, 2, 3, 1)


def build_backbone(cfg, dtype=torch.float32) -> ResNetFPN:
    """The (8, 2) ladder; the (16, 4) ladder and int8 convs wait."""
    if cfg.int8:
        raise NotImplementedError("int8 backbone is not ported yet")
    if tuple(cfg.resolution) != (8, 2):
        raise NotImplementedError(
            f"resolution ladder {cfg.resolution} is not ported yet")
    return ResNetFPN(cfg.initial_dim, cfg.block_dims, dtype=dtype)
