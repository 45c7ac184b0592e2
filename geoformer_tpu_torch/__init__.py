"""GeoFormer in PyTorch, with the GAM attention kernels in CUDA for Hopper.

A port of ``geoformer_tpu`` (JAX/Pallas on a TPU). It imports torch and
numpy only, never JAX and nothing of ``geoformer_tpu``; the JAX package is
the reference its tests hold it against. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, where every kernel is replaced by its
plain PyTorch version. ``GeoFormer``, ``MatchOutput`` and
``GeoFormerConfig`` load on first use, so that a process that only serves
an exported bundle (``geoformer_tpu_torch.serving``) imports no model code.
"""

_LAZY = {"GeoFormer": "geoformer_tpu_torch.models.geoformer",
         "MatchOutput": "geoformer_tpu_torch.models.geoformer",
         "GeoFormerConfig": "geoformer_tpu_torch.config"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
