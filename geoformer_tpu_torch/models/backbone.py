"""ResNet-FPN feature backbone.

Counterpart of geoformer_tpu/models/backbone.py. ResNetFPN, the (8, 2)
ladder: a 1-channel 7x7/2 stem, three 2-block residual stages at 1/2, 1/4
and 1/8, and a top-down FPN with aligned-corner bilinear upsampling and
leaky_relu(0.01). ResNetFPN_16_4, the (16, 4) ladder: a fourth stage at
1/16 and the FPN from 1/16 down to 1/4 only. BatchNorm runs with running
statistics, or with batch statistics over all the images given (and
updates the running ones) when ``train`` is set. With ``int8`` every
convolution is an Int8Conv (eval-only: ``train`` then raises). Inputs and
outputs keep the JAX layout (channels last); inside, the layers run NCHW.

With ``seq`` (sequence parallelism, core/spmd.py) the input is this rank's
band of image rows, a whole number of coarse rows, and so are the outputs:
every k x k convolution takes its halo rows from the neighbouring bands
(3 for the 7x7 stem, 1 for a 3x3), and the aligned-corner upsampling maps
its output rows through the image's global heights (``_upsample``), which
can reach one row past the band. BatchNorm's statistics in training are
summed over every rank (models/layers.py), so each real row counts once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from geoformer_tpu_torch.core import mesh, spmd
from geoformer_tpu_torch.models.layers import BatchNorm, Conv, Int8Conv
from geoformer_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


def _upsample(x: torch.Tensor, out_hw, seq: bool) -> torch.Tensor:
    """Aligned-corner bilinear resize of NCHW ``x`` to ``out_hw``. With
    ``seq``, x and the output are this rank's bands of maps n times their
    heights: output row y reads input rows floor(y s) and the next, s =
    (h - 1) / (oh - 1) over the global heights, one halo row on each
    side; the two rows are blended by f32 weights (in place, at the input
    width), then resized across by F.interpolate, within an ulp of its
    whole-map result."""
    if not seq:
        return resize_bilinear_align_corners_nchw(x, out_hw)
    n, r = mesh.seq_world(), mesh.seq_rank()
    hb, ob = x.shape[2], out_hw[0]
    h_in, h_out = hb * n, ob * n
    xe = spmd.halo_rows(x, 1, 1)                 # global rows r*hb - 1 ...
    f32 = dict(dtype=torch.float32, device=x.device)
    scale = torch.tensor(float(h_in - 1), **f32) / torch.tensor(
        float(max(h_out - 1, 1)), **f32)
    src = torch.arange(r * ob, (r + 1) * ob, **f32) * scale
    i0 = src.long()
    lam = (src - i0.float()).clamp(0.0, 1.0)[None, None, :, None]
    i1 = i0 + (i0 < h_in - 1).long()
    rows = xe.index_select(2, i0 - (r * hb - 1)).float().mul_(1 - lam)
    rows = rows.add_(xe.index_select(2, i1 - (r * hb - 1)).float().mul_(lam))
    return resize_bilinear_align_corners_nchw(rows.to(x.dtype),
                                              (ob, out_hw[1]))


def _eval_only(int8: bool, train: bool) -> None:
    if int8 and train:
        raise ValueError("the int8 backbone is eval-only (round() has no "
                         "gradient)")


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32, int8: bool = False):
        super().__init__()
        conv = Int8Conv if int8 else Conv
        self.int8 = int8
        self.conv1 = conv(cin, planes, 3, stride, dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, 1, dtype)
        self.bn2 = BatchNorm(planes)
        self.stride = stride
        if stride != 1:
            self.conv_down = conv(cin, planes, 1, stride, dtype)
            self.bn_down = BatchNorm(planes)

    def forward(self, x: torch.Tensor, train: bool = False,
                seq: bool = False) -> torch.Tensor:
        _eval_only(self.int8, train)
        y = F.relu(self.bn1(self.conv1(x, seq), train))
        y = self.bn2(self.conv2(y, seq), train)
        if self.stride != 1:
            x = self.bn_down(self.conv_down(x, seq), train)
        return F.relu(x + y)


class ResNetFPN(nn.Module):
    """The (8, 2) ladder: coarse at 1/8 (block_dims[2] channels), fine at
    1/2 (block_dims[0])."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256),
                 dtype=torch.float32, int8: bool = False):
        super().__init__()
        d1, d2, d3 = block_dims
        conv = Int8Conv if int8 else Conv
        self.int8 = int8
        self.conv1 = conv(1, initial_dim, 7, 2, dtype)
        self.bn1 = BatchNorm(initial_dim)
        self.layer1_0 = BasicBlock(initial_dim, d1, 1, dtype, int8)
        self.layer1_1 = BasicBlock(d1, d1, 1, dtype, int8)
        self.layer2_0 = BasicBlock(d1, d2, 2, dtype, int8)
        self.layer2_1 = BasicBlock(d2, d2, 1, dtype, int8)
        self.layer3_0 = BasicBlock(d2, d3, 2, dtype, int8)
        self.layer3_1 = BasicBlock(d3, d3, 1, dtype, int8)
        self.l3_out = conv(d3, d3, 1, 1, dtype)
        self.l2_out = conv(d2, d3, 1, 1, dtype)
        self.l2_m1 = conv(d3, d3, 3, 1, dtype)
        self.l2_bn = BatchNorm(d3)
        self.l2_m2 = conv(d3, d2, 3, 1, dtype)
        self.l1_out = conv(d1, d2, 1, 1, dtype)
        self.l1_m1 = conv(d2, d2, 3, 1, dtype)
        self.l1_bn = BatchNorm(d2)
        self.l1_m2 = conv(d2, d1, 3, 1, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, 1] in [0, 1]. Returns (coarse [B, H/8, W/8, d3],
        fine [B, H/2, W/2, d1]), channels last."""
        _eval_only(self.int8, train)
        x = x.permute(0, 3, 1, 2)
        x0 = F.relu(self.bn1(self.conv1(x, seq), train))
        x1 = self.layer1_1(self.layer1_0(x0, train, seq), train, seq)  # 1/2
        x2 = self.layer2_1(self.layer2_0(x1, train, seq), train, seq)  # 1/4
        x3 = self.layer3_1(self.layer3_0(x2, train, seq), train, seq)  # 1/8

        x3_out = self.l3_out(x3)
        x2_out = self.l2_out(x2)
        m2 = x2_out + _upsample(x3_out, x2_out.shape[2:], seq)
        m2 = F.leaky_relu(self.l2_bn(self.l2_m1(m2, seq), train), 0.01)
        x2_out = self.l2_m2(m2, seq)

        x1_out = self.l1_out(x1)
        m1 = x1_out + _upsample(x2_out, x1_out.shape[2:], seq)
        m1 = F.leaky_relu(self.l1_bn(self.l1_m1(m1, seq), train), 0.01)
        x1_out = self.l1_m2(m1, seq)
        return x3_out.permute(0, 2, 3, 1), x1_out.permute(0, 2, 3, 1)


class ResNetFPN_16_4(nn.Module):
    """The (16, 4) ladder: four residual stages, the FPN from 1/16 down to
    1/4; coarse at 1/16 (block_dims[3] channels), fine at 1/4
    (block_dims[1])."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256, 512),
                 dtype=torch.float32, int8: bool = False):
        super().__init__()
        d1, d2, d3, d4 = block_dims
        conv = Int8Conv if int8 else Conv
        self.int8 = int8
        self.conv1 = conv(1, initial_dim, 7, 2, dtype)
        self.bn1 = BatchNorm(initial_dim)
        for li, (cin, cout) in enumerate(((initial_dim, d1), (d1, d2),
                                          (d2, d3), (d3, d4)), 1):
            stride = 1 if li == 1 else 2
            self.add_module(f"layer{li}_0",
                            BasicBlock(cin, cout, stride, dtype, int8))
            self.add_module(f"layer{li}_1",
                            BasicBlock(cout, cout, 1, dtype, int8))
        self.l4_out = conv(d4, d4, 1, 1, dtype)
        self.l3_out = conv(d3, d4, 1, 1, dtype)
        self.l3_m1 = conv(d4, d4, 3, 1, dtype)
        self.l3_bn = BatchNorm(d4)
        self.l3_m2 = conv(d4, d3, 3, 1, dtype)
        self.l2_out = conv(d2, d3, 1, 1, dtype)
        self.l2_m1 = conv(d3, d3, 3, 1, dtype)
        self.l2_bn = BatchNorm(d3)
        self.l2_m2 = conv(d3, d2, 3, 1, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, 1] in [0, 1]. Returns (coarse [B, H/16, W/16, d4],
        fine [B, H/4, W/4, d2]), channels last."""
        _eval_only(self.int8, train)
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2), seq), train))
        feats = []
        for li in (1, 2, 3, 4):
            x = getattr(self, f"layer{li}_0")(x, train, seq)
            x = getattr(self, f"layer{li}_1")(x, train, seq)
            feats.append(x)
        _, x2, x3, x4 = feats
        x4_out = self.l4_out(x4)
        x3_out = self.l3_out(x3)
        m3 = self.l3_m1(x3_out + _upsample(x4_out, x3_out.shape[2:], seq),
                        seq)
        m3 = F.leaky_relu(self.l3_bn(m3, train), 0.01)
        x3_out = self.l3_m2(m3, seq)
        x2_out = self.l2_out(x2)
        m2 = self.l2_m1(x2_out + _upsample(x3_out, x2_out.shape[2:], seq),
                        seq)
        m2 = F.leaky_relu(self.l2_bn(m2, train), 0.01)
        x2_out = self.l2_m2(m2, seq)
        return x4_out.permute(0, 2, 3, 1), x2_out.permute(0, 2, 3, 1)


def fine_channels(cfg) -> int:
    """Channels of the backbone's fine map: block_dims[0] on the (8, 2)
    ladder, block_dims[1] on the (16, 4) one."""
    return cfg.block_dims[1 if tuple(cfg.resolution) == (16, 4) else 0]


def build_backbone(cfg, dtype=torch.float32) -> nn.Module:
    """The ladder of ``cfg.resolution``: (8, 2) or (16, 4) (with four
    block_dims); ValueError for any other."""
    if tuple(cfg.resolution) == (8, 2):
        return ResNetFPN(cfg.initial_dim, cfg.block_dims, dtype, cfg.int8)
    if tuple(cfg.resolution) == (16, 4):
        if len(cfg.block_dims) != 4:
            raise ValueError(f"the (16, 4) ladder takes 4 block_dims, got "
                             f"{cfg.block_dims}")
        return ResNetFPN_16_4(cfg.initial_dim, cfg.block_dims, dtype,
                              cfg.int8)
    raise ValueError(f"unsupported resolution ladder {cfg.resolution}")
