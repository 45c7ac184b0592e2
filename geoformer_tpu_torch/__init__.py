"""GeoFormer in PyTorch, with the GAM attention kernels in CUDA for Hopper.

A port of ``geoformer_tpu`` (JAX/Pallas on a TPU). It imports torch and
numpy only, never JAX and nothing of ``geoformer_tpu``; the JAX package is
the reference its tests hold it against. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, where every kernel is replaced by its
plain PyTorch version.
"""

from geoformer_tpu_torch.config import GeoFormerConfig  # noqa: F401
