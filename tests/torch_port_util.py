"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*).

Inputs are made with seeded numpy and handed to both packages as arrays;
JAX variables cross over as the flat '/'-keyed dict of the npz layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
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
                          mask1=None, train: bool = False,
                          intermediates: bool = False):
    """The JAX GeoFormer.apply output of a batch and the GAM's RANSAC
    samples [B, iters, 4] that this forward drew (the key it takes with
    make_rng("ransac"), split per row as _build_geo_state splits it, then
    ransac.py:110-112 on the first-pass matches), for injection into the
    port. ``train`` runs the train-mode forward (batch statistics, the
    force-one-match rule), as a train step does. ``intermediates`` also
    returns the forward's captured intermediates, third."""
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
    if intermediates:
        return out, sample_idx, st["intermediates"]
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


LOC_HW = (480, 640)
LOC_K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]])


def localization_scene(root, n_db: int = 5, n_query: int = 2,
                       seed: int = 3) -> dict:
    """A seeded localization scene without images: 600 points on the
    localization protocol's three planes, ``n_db`` posed db cameras in an
    NVM (model.nvm) and a COLMAP database (db.db), ``n_query`` query
    cameras in queries.txt, each query paired with its 3 nearest db
    cameras. ``match(a, b)`` is an exact matcher: the points seen by both
    cameras, [N, 4] (x_a, y_a, x_b, y_b), with 0.2 px noise. Returns the
    paths, the ground-truth poses, ``match`` and the query pairs."""
    import os
    import zlib

    from geoformer_tpu_torch.data.planes import look_at
    from geoformer_tpu_torch.eval.colmap_io import ColmapDatabase
    from geoformer_tpu_torch.eval.sfm_localize import rotmat2qvec

    rng = np.random.default_rng(seed)
    h, w = LOC_HW
    K = LOC_K
    planes = [((-5.0, -3.0, 8.0), (10.0, 0, 0), (0, 6.0, 0)),
              ((-5.0, 2.2, 2.0), (10.0, 0, 0), (0, 1.2, 6.0)),
              ((-4.5, -3.0, 2.0), (0, 0, 6.0), (0, 6.0, 0))]
    pts = np.concatenate([
        np.asarray(o) + rng.random((200, 1)) * np.asarray(e1)
        + rng.random((200, 1)) * np.asarray(e2) for o, e1, e2 in planes])
    target = np.array([0.0, 0.0, 8.0])
    cams = {}
    for i in range(n_db):
        c = np.array([-2.0 + 4.0 * i / (n_db - 1), rng.uniform(-.3, .3),
                      rng.uniform(-.3, .4)])
        cams[f"db{i:02d}.jpg"] = look_at(c, target + rng.uniform(-.4, .4, 3)
                                         * [1, 1, 0])
    queries = {}
    for i in range(n_query):
        c = np.array([-1.2 + 2.4 * i / max(n_query - 1, 1) + 0.25,
                      rng.uniform(-.2, .2), 0.4])
        queries[f"q{i:02d}.jpg"] = look_at(c, target)
    allcams = {**cams, **queries}

    def project(T, X):
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        seen = (pc[:, 2] > 0.2) & (uv[:, 0] > 0) & (uv[:, 0] < w) \
            & (uv[:, 1] > 0) & (uv[:, 1] < h)
        return uv, seen

    def match(a, b):
        ua, sa = project(allcams[a], pts)
        ub, sb = project(allcams[b], pts)
        both = sa & sb
        r = np.random.default_rng(zlib.crc32(f"{a} {b}".encode()))
        m = np.concatenate([ua[both], ub[both]], 1)
        return m + r.normal(0, 0.2, m.shape)

    nvm = os.path.join(root, "model.nvm")
    with open(nvm, "w") as f:
        f.write(f"NVM_V3\n\n{n_db}\n")
        for name, T in cams.items():
            R = T[:3, :3]
            c = -R.T @ T[:3, 3]
            q = rotmat2qvec(R)
            f.write(f"./{name} {K[0, 0]} {' '.join(map(str, q))} "
                    f"{' '.join(map(str, c))} 0 0\n")
        tracks = []
        for pi, X in enumerate(pts[::4]):
            tr = []
            for ii, T in enumerate(cams.values()):
                uv, seen = project(T, X[None])
                if seen[0]:
                    tr.append(f"{ii} {pi} {uv[0, 0]} {uv[0, 1]}")
            if len(tr) >= 2:
                tracks.append(f"{' '.join(map(str, X))} 128 128 128 "
                              f"{len(tr)} {' '.join(tr)}")
        f.write(f"\n{len(tracks)}\n" + "\n".join(tracks) + "\n")
    db_path = os.path.join(root, "db.db")
    db = ColmapDatabase(db_path)
    for name in cams:
        db.add_image(name, db.add_camera(1, w, h, [K[0, 0], K[1, 1],
                                                   K[0, 2], K[1, 2]]))
    db.close()
    queries_txt = os.path.join(root, "queries.txt")
    with open(queries_txt, "w") as f:
        for name in queries:
            f.write(f"{name} PINHOLE {w} {h} {K[0, 0]} {K[1, 1]} "
                    f"{K[0, 2]} {K[1, 2]}\n")
    centre = {n: -T[:3, :3].T @ T[:3, 3] for n, T in allcams.items()}
    pairs = [(q, d) for q in queries
             for d in sorted(cams, key=lambda d: np.linalg.norm(
                 centre[d] - centre[q]))[:3]]
    return {"nvm": nvm, "db": db_path, "queries_txt": queries_txt,
            "db_cams": cams, "queries": queries, "match": match,
            "query_pairs": pairs, "points": pts}


class JaxPnpDraws:
    """Record the samples JAX's pnp_ransac draws from each key it is given
    (``patch_jax``: Gumbel top-6 over the valid entries, in call order)
    and hand them, in the same order, to the port's PnP calls through
    eval/sfm_localize.pnp_pose (``patch_port``)."""

    def __init__(self):
        self.draws = []

    def patch_jax(self, monkeypatch):
        import jax
        import jax.numpy as jnp

        from geoformer_tpu.engine import pnp

        real = pnp.pnp_ransac

        def record(key, pts3d, uv, K, valid, **kw):
            g = jax.random.gumbel(key, (kw.get("iters", 256), len(valid)))
            self.draws.append(np.asarray(jax.lax.top_k(
                jnp.where(valid[None], g, -jnp.inf), 6)[1]))
            return real(key, pts3d, uv, K, valid, **kw)

        monkeypatch.setattr(pnp, "pnp_ransac", record)

    def patch_port(self, monkeypatch, module):
        """``module`` is where the port's driver looks pnp_pose up."""
        real = module.pnp_pose

        def injected(*args, **kw):
            args = list(args)
            if len(args) > 7:
                args[7] = self.draws.pop(0)
            else:
                kw["sample_idx"] = self.draws.pop(0)
            return real(*args, **kw)

        monkeypatch.setattr(module, "pnp_pose", injected)


def pose_gap(a, b):
    """(rotation angle in degrees, camera-centre distance) between two
    world->cam poses given as qvec/tvec."""
    from geoformer_tpu_torch.eval.sfm_localize import qvec2rotmat

    Ra, Rb = qvec2rotmat(a["qvec"]), qvec2rotmat(b["qvec"])
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): exact at small angles, where
    # the trace form loses ~0.03 deg to f32 rounding
    ang = np.rad2deg(2 * np.arcsin(min(1.0, np.linalg.norm(Ra - Rb)
                                       / (2 * np.sqrt(2)))))
    return ang, np.linalg.norm(Ra.T @ a["tvec"] - Rb.T @ b["tvec"])


def close_poses(got, ref, rot_deg=0.1, centre=0.02):
    """Localization results equal but for the f32 PnP bar: ``ok`` equal,
    inlier counts within 2, rotations within ``rot_deg`` and camera
    centres within ``centre``."""
    assert got.keys() == ref.keys()
    for q in ref:
        assert got[q]["ok"] == ref[q]["ok"], q
        assert abs(got[q]["num_inliers"] - ref[q]["num_inliers"]) <= 2, q
        ang, dc = pose_gap(got[q], ref[q])
        assert ang < rot_deg and dc < centre, (q, ang, dc)


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """Each test's torch work on one thread, and one thread in the
    processes it starts: under the suite's parallel workers, torch on every
    core in every worker thrashes. Imported by a test module, it applies
    to every test there (autouse); restored after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)
