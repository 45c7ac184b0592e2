"""Configuration of the PyTorch port.

The port's own copy of the model and training dataclasses of
geoformer_tpu/config.py, with the same fields and defaults, so a
configuration written for one package reads the same in the other.
Options that the port does not run yet (int8 paths, sequence parallelism,
the sinkhorn matcher) are kept as fields so the dataclasses stay
identical; the model raises NotImplementedError on them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """ResNet-FPN."""

    initial_dim: int = 128
    block_dims: Tuple[int, ...] = (128, 196, 256)  # stages at 1/2, 1/4, 1/8
    resolution: Tuple[int, int] = (8, 2)
    int8: bool = False


@dataclasses.dataclass(frozen=True)
class CoarseTransformerConfig:
    """Coarse LoFTR stack."""

    d_model: int = 256
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross") * 4
    attention: str = "linear"  # 'linear' | 'full'
    int8: bool = False


@dataclasses.dataclass(frozen=True)
class FineTransformerConfig:
    """Fine LoFTR stack over window tokens."""

    d_model: int = 128
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross")
    attention: str = "linear_flat"
    int8: bool = False


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Coarse dual-softmax matching."""

    thr: float = 0.2
    dsmax_temperature: float = 0.1
    match_type: str = "dual_softmax"  # 'dual_softmax' | 'sinkhorn'
    skh_iters: int = 3
    skh_init_bin_score: float = 1.0
    # Capacity for extracted coarse matches; <= 0 keeps one slot per cell.
    max_matches: int = -1
    force_one_match: bool = False
    streaming_extract: bool = True


@dataclasses.dataclass(frozen=True)
class GeoModuleConfig:
    """Geometrized Attention Module."""

    nhead: int = 4
    layer_names: Tuple[str, ...] = ("self", "cross") * 2
    window_size: int = 5
    ransac_iters: int = 512
    ransac_thr: float = 8.0
    min_matches: int = 8
    max_inliers: int = 1024
    refine_iters: int = 2
    # Hand-written GAM kernels: box-window cross layers (K1) and, with
    # use_pallas_self, masked-KV self layers (K2). The name is the JAX
    # package's; here it selects the CUDA kernels.
    use_pallas: bool = False
    use_pallas_self: bool = True
    int8: bool = False


@dataclasses.dataclass(frozen=True)
class FineMatchConfig:
    """Window-to-window fine matching."""

    temperature: float = 0.1
    thr: float = 0.1
    window_size: int = 5
    concat_coarse_feat: bool = True


@dataclasses.dataclass(frozen=True)
class GeoFormerConfig:
    """Full-model config, resolution ladder (8, 2)."""

    backbone: BackboneConfig = BackboneConfig()
    coarse: CoarseTransformerConfig = CoarseTransformerConfig()
    fine: FineTransformerConfig = FineTransformerConfig()
    match: MatchConfig = MatchConfig()
    geo: GeoModuleConfig = GeoModuleConfig()
    fine_match: FineMatchConfig = FineMatchConfig()
    coarse_scale: int = 8
    fine_scale: int = 2
    use_bf16: bool = False
    seq_axis: "str | None" = None

    def replace(self, **kw) -> "GeoFormerConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """GeoLoss: focal coarse terms (two passes) and BCE fine term."""

    coarse_type: str = "focal"  # 'focal' | 'cross_entropy'
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    coarse_weight: float = 1.0
    fine_weight: float = 1.0
    sparse_spvs: bool = True


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer and LR schedule."""

    optimizer: str = "adamw"
    canonical_lr: float = 6e-3
    canonical_bs: int = 64
    true_lr: float = 0.0  # 0 => derived: canonical_lr * world_bs / canonical_bs
    adamw_decay: float = 0.1
    warmup_steps: int = 4800       # canonical units (divided by LR scaling)
    warmup_actual: int = 0         # >0 => warmup in ACTUAL steps, no scaling
    warmup_ratio: float = 0.0
    scheduler: str = "multistep"  # 'multistep' | 'cosine' | 'exponential'
    mslr_milestones: Tuple[int, ...] = (3, 6, 9, 12)  # epochs
    mslr_gamma: float = 0.5
    cosa_tmax: int = 30
    elr_gamma: float = 0.999992
    gradient_clipping: float = 0.5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    batch_size: int = 8            # global batch
    steps_per_epoch: int = 1000
    num_epochs: int = 15
    seed: int = 66
    image_hw: Tuple[int, int] = (480, 640)
    ckpt_dir: str = "checkpoints"
    log_every: int = 50
    ckpt_every_steps: int = 1000


def bench_config(use_bf16: bool = True) -> GeoFormerConfig:
    """The configuration of the JAX package's bench.py (480x640 pairs):
    1024 coarse matches, 256 RANSAC hypotheses, 1024 inliers, both GAM
    kernels, the flat linear attention in the fine stack."""
    return GeoFormerConfig(
        match=MatchConfig(max_matches=1024),
        geo=GeoModuleConfig(ransac_iters=256, max_inliers=1024,
                            use_pallas=True, use_pallas_self=True),
        use_bf16=use_bf16)
