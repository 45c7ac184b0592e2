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
                          mask1=None, train: bool = False):
    """The JAX GeoFormer.apply output of a batch and the GAM's RANSAC
    samples [B, iters, 4] that this forward drew (the key it takes with
    make_rng("ransac"), split per row as _build_geo_state splits it, then
    ransac.py:110-112 on the first-pass matches), for injection into the
    port. ``train`` runs the train-mode forward (batch statistics, the
    force-one-match rule), as a train step does."""
    import jax
    import jax.numpy as jnp

    from geoformer_tpu.models import GeoFormer as JGeoFormer
    from geoformer_tpu.models.coarse_matching import coarse_match

    model = JGeoFormer(cfg)
    m = (None, None) if mask0 is None else (jnp.asarray(mask0),
                                            jnp.asarray(mask1))
    mutable = ["intermediates"] + (["batch_stats"] if train else [])
    out, st = jax.jit(lambda v, a, b, k, m0, m1: model.apply(
        v, a, b, m0, m1, train=train, rngs={"ransac": k},
        capture_intermediates=True, mutable=mutable))(
            variables, jnp.asarray(img0), jnp.asarray(img1), key, *m)
    b = img0.shape[0]
    f0, f1 = st["intermediates"]["loftr_coarse"]["__call__"][0]
    flat_m = [None if x is None else x.reshape(b, -1) for x in m]
    matches1 = coarse_match(f0, f1, cfg.match.thr,
                            cfg.match.dsmax_temperature,
                            cfg.match.max_matches, *flat_m,
                            force_one=cfg.match.force_one_match or train,
                            streaming=True)
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


class JaxDrawsMatcher:
    """Drive a JAX eval driver and the port's with the same RANSAC draws.

    ``patch_jax(monkeypatch, j_matcher_module)`` makes the JAX
    BatchedMatcher run each forward through one jitted function per bucket
    that also returns the GAM's draws ([B, iters, 4], as
    jax_forward_and_draws computes them), and records them in order.
    ``patch_port(monkeypatch, model)`` hands the recorded draws, in the
    same order, to the port model's forwards. ``patch_fits`` makes a
    driver module's fit_homography_np take the JAX fit's draws
    (jax_fit_sample_idx with seed 0, the JAX default)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.draws = []
        self._fns = {}
        self._next = 0

    def _fwd(self, hw):
        import jax
        import jax.numpy as jnp

        from geoformer_tpu.models import GeoFormer as JGeoFormer
        from geoformer_tpu.models.coarse_matching import coarse_match

        if hw in self._fns:
            return self._fns[hw]
        cfg = self.cfg
        model = JGeoFormer(cfg)
        iters = cfg.geo.ransac_iters

        def fwd(v, i0, i1, m0, m1):
            key = jax.random.key(0)
            out, st = model.apply(v, i0, i1, mask0=m0, mask1=m1,
                                  rngs={"ransac": key},
                                  capture_intermediates=True,
                                  mutable=["intermediates"])
            b = i0.shape[0]
            f0, f1 = st["intermediates"]["loftr_coarse"]["__call__"][0]
            matches1 = coarse_match(
                f0, f1, cfg.match.thr, cfg.match.dsmax_temperature,
                cfg.match.max_matches, m0.reshape(b, -1), m1.reshape(b, -1),
                streaming=True)
            rkey = model.apply(v, method=lambda mod: mod.make_rng("ransac"),
                               rngs={"ransac": key})

            def draw(k, valid):
                g = jax.random.gumbel(k, (iters, valid.shape[0]))
                return jax.lax.top_k(jnp.where(valid[None, :], g, -jnp.inf),
                                     4)[1]

            return out, jax.vmap(draw)(jax.random.split(rkey, b),
                                       matches1.valid)

        self._fns[hw] = jax.jit(fwd)
        return self._fns[hw]

    def patch_jax(self, monkeypatch, j_matcher_module):
        owner = self

        def _get_fn(matcher, hw):
            fn = owner._fwd(hw)

            def call(params, i0, i1, m0, m1):
                out, idx = fn(params, i0, i1, m0, m1)
                owner.draws.append(np.asarray(idx))
                return out
            return call

        monkeypatch.setattr(j_matcher_module.BatchedMatcher, "_get_fn",
                            _get_fn)

    def patch_port(self, model):
        """A forward pre-hook on the port model; returns its handle."""
        self._next = 0

        def hook(module, args, kwargs):
            idx = self.draws[self._next]
            self._next += 1
            kwargs["sample_idx"] = torch.tensor(idx, dtype=torch.long)
            return args, kwargs

        return model.register_forward_pre_hook(hook, with_kwargs=True)

    @staticmethod
    def patch_fits(monkeypatch, module):
        real = module.fit_homography_np

        def fit(p0, p1, thr, **kw):
            if len(p0) < 4:
                return None, None
            return real(p0, p1, thr, sample_idx=jax_fit_sample_idx(
                len(p0), 0), **kw)

        monkeypatch.setattr(module, "fit_homography_np", fit)


def depth_batch(seed: int, b: int = 2, hw=(64, 64), rows: int = 48,
                scale: float = 1.25, shift: int = 8, pad: int = 96,
                rendered: bool = False):
    """A padded posed-RGBD batch, numpy, in the depth steps' layout.

    Images: a smooth texture and its copy shifted by ``shift`` pixels
    (tests/torch_port_util.smooth_images), ``rows`` rows of content
    zero-padded to ``hw``, with coarse masks zero below the content. Depth,
    poses and intrinsics: two views of a rendered room (the port's
    renderer) at the original size, the content's times ``scale``, depths
    zero-padded to pad x pad, the second camera moved sideways;
    scale0/scale1 = ``scale``. With ``rendered`` the images are the two
    views' renders instead, resized to the content as the reader resizes
    (ops/resize.resize_linear_u8 of the 8-bit render)."""
    from geoformer_tpu_torch.data.planes import (
        look_at,
        render_planes,
        room_scene,
    )
    from geoformer_tpu_torch.ops.resize import resize_linear_u8

    rng = np.random.default_rng(seed)
    h, w = hw
    img0, img1 = smooth_images(rng, b, rows, w, shift)
    img0 = np.pad(img0, ((0, 0), (0, h - rows), (0, 0), (0, 0)))
    img1 = np.pad(img1, ((0, 0), (0, h - rows), (0, 0), (0, 0)))
    mask = np.zeros((b, h // 8, w // 8), np.float32)
    mask[:, :rows // 8] = 1.0
    oh, ow = int(rows * scale), int(w * scale)
    f = 0.9 * ow
    K = np.array([[f, 0, ow / 2], [0, f, oh / 2], [0, 0, 1]])
    d0s, d1s, Ts, ims = [], [], [], []
    for _ in range(b):
        planes = room_scene(rng, rng.random((6, 32, 48)).astype(np.float32),
                            cluttered=True)
        c0 = np.array([rng.uniform(-.5, .5), rng.uniform(-.2, .2), 0.0])
        c1 = c0 + np.array([rng.uniform(.3, .5), rng.uniform(-.1, .1),
                            rng.uniform(-.2, .2)])
        T0 = look_at(c0, [0, 0, 8])
        T1 = look_at(c1, [rng.uniform(-.3, .3), 0, 8])
        i0, d0 = render_planes(K, T0, planes, (oh, ow), return_depth=True)
        i1, d1 = render_planes(K, T1, planes, (oh, ow), return_depth=True)
        ims.append([resize_linear_u8((i * 255).astype(np.uint8), (rows, w))
                    .astype(np.float32) / 255.0 for i in (i0, i1)])
        d0s.append(np.pad(d0, ((0, pad - oh), (0, pad - ow))))
        d1s.append(np.pad(d1, ((0, pad - oh), (0, pad - ow))))
        Ts.append(T1 @ np.linalg.inv(T0))
    if rendered:
        img0 = np.zeros_like(img0)
        img1 = np.zeros_like(img1)
        for i, (a, c) in enumerate(ims):
            img0[i, :rows, :, 0] = a
            img1[i, :rows, :, 0] = c
    T = np.stack(Ts).astype(np.float32)
    Kb = np.tile(K.astype(np.float32), (b, 1, 1))
    sc = np.full((b, 2), scale, np.float32)
    return {"image0": img0, "image1": img1, "mask0": mask, "mask1": mask,
            "depth0": np.stack(d0s), "depth1": np.stack(d1s),
            "T_0to1": T, "T_1to0": np.linalg.inv(T).astype(np.float32),
            "K0": Kb, "K1": Kb.copy(), "scale0": sc, "scale1": sc.copy()}
