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


def jax_forward_and_draws(cfg, variables, img0, img1, key, mask0=None,
                          mask1=None):
    """The JAX GeoFormer.apply output of a batch and the GAM's RANSAC
    samples [B, iters, 4] that this forward drew (the key it takes with
    make_rng("ransac"), split per row as _build_geo_state splits it, then
    ransac.py:110-112 on the first-pass matches), for injection into the
    port."""
    import jax
    import jax.numpy as jnp

    from geoformer_tpu.models import GeoFormer as JGeoFormer
    from geoformer_tpu.models.coarse_matching import coarse_match

    model = JGeoFormer(cfg)
    m = (None, None) if mask0 is None else (jnp.asarray(mask0),
                                            jnp.asarray(mask1))
    out, st = jax.jit(lambda v, a, b, k, m0, m1: model.apply(
        v, a, b, m0, m1, rngs={"ransac": k}, capture_intermediates=True,
        mutable=["intermediates"]))(variables, jnp.asarray(img0),
                                    jnp.asarray(img1), key, *m)
    b = img0.shape[0]
    f0, f1 = st["intermediates"]["loftr_coarse"]["__call__"][0]
    flat_m = [None if x is None else x.reshape(b, -1) for x in m]
    matches1 = coarse_match(f0, f1, cfg.match.thr,
                            cfg.match.dsmax_temperature,
                            cfg.match.max_matches, *flat_m, streaming=True)
    rkey = model.apply(variables, method=lambda mod: mod.make_rng("ransac"),
                       rngs={"ransac": key})
    iters = cfg.geo.ransac_iters

    def draw(k, v):
        g = jax.random.gumbel(k, (iters, v.shape[0]))
        return jax.lax.top_k(jnp.where(v[None, :], g, -jnp.inf), 4)[1]

    sample_idx = np.asarray(jax.vmap(draw)(jax.random.split(rkey, b),
                                           matches1.valid))
    return out, sample_idx


def jax_fit_sample_idx(n, seed, iters=2048, cap=4096):
    """The [iters, 4] sample indices the JAX fit_homography_np draws for n
    correspondences from jax.random.key(seed) (gumbel + top_k over the
    valid entries of its padded point set)."""
    import jax
    import jax.numpy as jnp

    from geoformer_tpu_torch.eval.hpatches import fit_capacity

    m = fit_capacity(n, cap)
    g = jax.random.gumbel(jax.random.key(seed), (iters, m))
    valid = jnp.arange(m) < min(n, cap)
    return np.asarray(jax.lax.top_k(jnp.where(valid[None], g, -jnp.inf),
                                    4)[1])


def match_bar(ref_ids, ref_kp, got_ids, got_kp):
    """The JAX package's parity bar for one pair (__graft_entry__.py):
    (overlap of the (i, j) match sets, largest keypoint distance over the
    common matches). *_ids: [K, 2] int (i, j) of valid matches; *_kp:
    [K, 4] (x0, y0, x1, y1) in the same order."""
    ref = {tuple(r): k for r, k in zip(ref_ids.tolist(), ref_kp)}
    got = {tuple(r): k for r, k in zip(got_ids.tolist(), got_kp)}
    common = ref.keys() & got.keys()
    overlap = len(common) / max(len(ref.keys() | got.keys()), 1)
    kp = max((np.abs(ref[c] - got[c]).max() for c in common), default=0.0)
    return overlap, float(kp)
