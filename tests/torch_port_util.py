"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*).

Inputs are made with seeded numpy and handed to both packages as arrays;
JAX variables cross over as the flat '/'-keyed dict of the npz layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from geoformer_tpu import config as jcfg
from geoformer_tpu_torch import config as tcfg


def flatten(tree, prefix: str = "") -> dict:
    """Flax variables -> {"params/a/b/kernel": np.ndarray} (npz layout)."""
    out = {}
    for k, v in dict(tree).items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor."""
    a = torch.from_numpy(np.array(x))
    return a if dtype is None else a.to(dtype)


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()
    return np.asarray(x)


def port_config(cfg: jcfg.GeoFormerConfig) -> tcfg.GeoFormerConfig:
    """The port's GeoFormerConfig with the same field values."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tcfg, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tcfg.GeoFormerConfig(**kw)


def small_config(**over) -> jcfg.GeoFormerConfig:
    """A narrow model for CPU parity: backbone (16, 24, 32), coarse d_model
    32 with 2 self/cross pairs, GAM 2 heads, fine d_model 16, 64 matches,
    32 RANSAC hypotheses, 64 inliers. Low thresholds give an untrained
    model matches, so the GAM and the fine stage have work to do."""
    kw = dict(
        backbone=jcfg.BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=jcfg.CoarseTransformerConfig(
            d_model=32, nhead=4, layer_names=("self", "cross") * 2),
        fine=jcfg.FineTransformerConfig(d_model=16, nhead=2),
        match=jcfg.MatchConfig(thr=1e-4, max_matches=64),
        geo=jcfg.GeoModuleConfig(nhead=2, ransac_iters=32, max_inliers=64),
        fine_match=jcfg.FineMatchConfig(thr=1e-3),
    )
    kw.update(over)
    return jcfg.GeoFormerConfig(**kw)


def smooth_images(rng: np.random.Generator, b: int, h: int, w: int,
                  shift: int = 8):
    """A smooth random texture [b, h, w, 1] in [0, 1] and its copy shifted
    right by ``shift`` pixels (a known translation)."""
    import scipy.ndimage as ndi

    lo = rng.random((b, h // 8 + 2, w // 8 + 2))
    img = np.stack([ndi.zoom(x, 8, order=3)[:h, :w] for x in lo])
    img = (img - img.min()) / (img.max() - img.min())
    img0 = img[..., None].astype(np.float32)
    return img0, np.roll(img0, shift, axis=2)


def assert_close(actual, expected, rtol: float, atol: float, what=""):
    np.testing.assert_allclose(n(actual), n(expected), rtol=rtol, atol=atol,
                               err_msg=what)
