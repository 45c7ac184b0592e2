"""What each rank runs in the port's multi-process tests, and the host
data some of them take.

core/mesh.launch spawns the ranks, and a spawned process imports what it
runs by name, so the rank functions live here, in a module that imports
only torch, numpy and the port (no JAX, no test module; the card's tests
in tests/test_torch_port_cuda.py use it too). Each takes the rank and host
data, and returns host data (numpy) for the test to compare.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy().copy()


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def gather_and_bn(rank, per_rank, bn_inputs, device="cpu"):
    """core/dist's gathers of this rank's arrays, and one train-mode
    BatchNorm forward and backward on this rank's half of a batch, on
    ``device``."""
    from geoformer_tpu_torch.core import dist as pdist
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.models.layers import BatchNorm

    gathered = pdist.all_gather_metrics(per_rank[rank])
    mean = pdist.host_mean(float(per_rank[rank]["scalar"]))
    x, g, w, b = (torch.from_numpy(a).to(device) for a in bn_inputs)
    sl = mesh.local_shard_slice(x.shape[0])
    bn = BatchNorm(x.shape[1]).to(device)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    xs = x[sl].clone().requires_grad_(True)
    y = bn(xs, train=True)
    (y * g[sl]).sum().backward()
    return dict(gathered=gathered, host_mean=mean, y=_np(y),
                dx=_np(xs.grad), dw=_np(bn.weight.grad),
                db=_np(bn.bias.grad), running_mean=_np(bn.running_mean),
                running_var=_np(bn.running_var),
                slice=(sl.start, sl.stop))


def dense_losses(rank, inputs):
    """The dense GeoLoss and the soft-argmax fine loss with global counts
    on this rank's half of ``inputs`` (conf, dect_conf, conf_gt, fine_conf,
    fine_gt, fine_valid, mask0, mask1, expec_f, expec_f_gt): each term's
    value and the gradient of the total by conf."""
    from geoformer_tpu_torch.config import LossConfig
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.train.loss import fine_loss_l2_std, geo_loss

    sl = mesh.local_shard_slice(inputs[0].shape[0])
    (conf, dect, gt, fconf, fgt, fvalid, m0, m1, ef, ef_gt) = (
        torch.from_numpy(a[sl]) for a in inputs)
    conf.requires_grad_(True)
    cfg = LossConfig(sparse_spvs=False)
    total, terms = geo_loss(conf, dect, gt, fconf, fgt, fvalid, cfg, m0, m1,
                            global_counts=True)
    total.backward()
    out = {k: float(v) for k, v in terms.items()}
    out["l2_std"] = float(fine_loss_l2_std(ef, ef_gt, fvalid,
                                           global_counts=True))
    out["dconf"] = _np(conf.grad)
    return out


def _state(cfg, flat, image_hw, batch_size):
    from geoformer_tpu_torch.config import TrainConfig
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.train.optim import make_optimizer
    from geoformer_tpu_torch.train.trainer import TrainState
    from geoformer_tpu_torch.weights import load_jax_params, random_init

    model = random_init(GeoFormer(cfg), 0) if flat is None \
        else load_jax_params(GeoFormer(cfg), flat)
    tc = TrainConfig(batch_size=batch_size, image_hw=image_hw)
    return tc, TrainState(model, make_optimizer(tc.optim,
                                                model.parameters()))


def _after(state, scalars) -> dict:
    return dict(scalars={k: float(v) for k, v in scalars.items()},
                state={k: _np(v) for k, v in
                       state.model.state_dict().items()},
                grads={k: _np(p.grad) for k, p in
                       state.model.named_parameters()})


def train_step(rank, cfg, flat, batch, sample_idx, lr):
    """shard_train_step(make_train_step) on the global batch with the
    global RANSAC samples: the scalars, the state and each parameter's
    gradient (summed over the ranks and clipped) after the step."""
    from geoformer_tpu_torch.train.trainer import (
        make_train_step,
        shard_train_step,
    )

    b, h, w, _ = batch["image0"].shape
    tc, state = _state(cfg, flat, (h, w), b)
    scalars = shard_train_step(make_train_step(tc))(
        state, _tensors(batch), lr,
        sample_idx=torch.from_numpy(np.array(sample_idx)))
    return _after(state, scalars)


def depth_step(rank, cfg, flat, batch, lr, seed):
    """make_depth_train_step on this rank's slice of the global batch, the
    RANSAC drawn from a generator seeded ``seed``."""
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.train.trainer import make_depth_train_step

    b, h, w, _ = batch["image0"].shape
    tc, state = _state(cfg, flat, (h, w), b)
    scalars = make_depth_train_step(tc)(
        state, mesh.shard_batch(_tensors(batch)), lr,
        generator=torch.Generator().manual_seed(seed))
    return _after(state, scalars)


def run_training(rank, kwargs):
    """train/loop.run_training; what this rank printed and its final
    state."""
    from geoformer_tpu_torch.train.loop import run_training as run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = run(**kwargs, device="cpu")
    return dict(printed=out.getvalue(), step=state.step,
                state={k: _np(v) for k, v in
                       state.model.state_dict().items()})


def depth_loop(rank, kwargs):
    """train/depth_loop.run_depth_training, recording the arguments of each
    scene stream it opens and its first two batches' images, and the
    validation records it returns."""
    from geoformer_tpu_torch.train import depth_loop as dl

    streams = []
    real = dl.scene_balanced_stream

    def recording(npz_dir, root_dir, batch, seed, **kw):
        it = real(npz_dir, root_dir, batch, seed, **kw)
        rec = dict(npz_dir=npz_dir, batch=batch, seed=seed,
                   shard=kw["shard"], images=[])
        streams.append(rec)

        def gen():
            for i, x in enumerate(it):
                if i < 2:
                    rec["images"].append(x["image0"].copy())
                yield x
        return gen()

    dl.scene_balanced_stream = recording
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _, best = dl.run_depth_training(**kwargs, device="cpu")
    finally:
        dl.scene_balanced_stream = real
    return dict(streams=streams, best=best, printed=out.getvalue())


def depth_validation(rank, cfg, flat, batches):
    """run_depth_validation of the depth val step over this rank's
    batches (``batches[rank]``)."""
    from geoformer_tpu_torch.train.depth_loop import run_depth_validation
    from geoformer_tpu_torch.train.trainer import make_depth_val_step

    mine = [_tensors(b) for b in batches[rank]]
    b, h, w, _ = mine[0]["image0"].shape
    tc, state = _state(cfg, flat, (h, w), b)
    return run_depth_validation(make_depth_val_step(tc), state, mine)


def engine_solve(rank, problems, iters, device="cpu"):
    """ba_solve_sharded on problems[0] and ba_solve_points_sharded on
    problems[1] (the latter's observations grouped by point), on
    ``device``."""
    from geoformer_tpu_torch.engine import ba

    out = []
    for fn, host in ((ba.ba_solve_sharded, problems[0]),
                     (ba.ba_solve_points_sharded, problems[1])):
        prob = ba.BAProblem(**{k: torch.from_numpy(v).to(device)
                               for k, v in host.items()})
        out.append(tuple(_np(x) for x in fn(prob, iters=iters)))
    return out


def ba_scene(seed: int, C: int = 4, P: int = 64, pose_noise: float = 0.02,
             point_noise: float = 0.05, by_point_shards: int = 0) -> dict:
    """tests/test_engine.py's BA scene as host arrays of a BAProblem: C
    cameras along x, P points 6-10 in front, every point seen by every
    camera, the poses (but camera 0's) and points perturbed. With
    ``by_point_shards``, the observations are grouped by point into that
    many equal slices with obs_pt local to its slice (the layout of
    ba_solve_points_sharded)."""
    from geoformer_tpu_torch.engine.lie import se3_exp

    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    pts = rng.uniform([-2, -2, 6], [2, 2, 10], (P, 3)).astype(np.float32)
    xi = np.zeros((C, 6), np.float32)
    xi[:, 3] = 0.3 * np.arange(C)
    xi[:, 1] = 0.02 * np.arange(C)
    cams = se3_exp(torch.from_numpy(xi)).numpy()
    pc = np.einsum("cij,pj->cpi", cams[:, :3, :3], pts) + cams[:, None, :3, 3]
    uv = ((pc / pc[..., 2:]) @ K.T)[..., :2].reshape(-1, 2)
    obs_cam = np.repeat(np.arange(C), P)
    obs_pt = np.tile(np.arange(P), C)
    dxi = rng.normal(0, pose_noise, (C, 6)).astype(np.float32)
    dxi[0] = 0
    cams0 = se3_exp(torch.from_numpy(dxi)).numpy() @ cams
    pts0 = pts + rng.normal(0, point_noise, pts.shape).astype(np.float32)
    if by_point_shards:
        order = np.argsort(obs_pt, kind="stable")
        obs_cam, obs_pt, uv = obs_cam[order], obs_pt[order], uv[order]
        obs_pt = obs_pt % (P // by_point_shards)
    return dict(cams=cams0.astype(np.float32), points=pts0, K=K,
                obs_cam=obs_cam.astype(np.int64),
                obs_pt=obs_pt.astype(np.int64),
                obs_uv=uv.astype(np.float32),
                obs_valid=np.ones(C * P, bool))


# ------------------------------------------------ sequence parallelism ----
# Each function below runs under a seq split of ``seq`` ranks
# (core/mesh.seq_groups; seq=1 in the test's own process gives the
# one-process reference of the same code) and returns its results
# gathered over the seq group, so that every rank's are the whole
# tensors, comparable with the reference's.


def narrow_config():
    """The port's copy of tests/torch_port_util.small_config (which needs
    the JAX package's config): the narrow model of the CPU tests."""
    from geoformer_tpu_torch import config as c

    return c.GeoFormerConfig(
        backbone=c.BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
        coarse=c.CoarseTransformerConfig(
            d_model=32, nhead=4, layer_names=("self", "cross") * 2),
        fine=c.FineTransformerConfig(d_model=16, nhead=2),
        match=c.MatchConfig(thr=1e-4, max_matches=64),
        geo=c.GeoModuleConfig(nhead=2, ransac_iters=32, max_inliers=64),
        fine_match=c.FineMatchConfig(thr=1e-3))


def extract_inputs():
    """Integer-valued (x 1/4) features [2, 32, 16] and masks: every dot
    product is exact, so two equal rows tie exactly. Row 3 (the first
    band of two) and row 20 (the second) are equal and closest to column
    9."""
    rng = np.random.default_rng(7)
    b, l, c = 2, 32, 16
    f0 = (rng.integers(-2, 3, (b, l, c)) * 0.25).astype(np.float32)
    f1 = (rng.integers(-2, 3, (b, l, c)) * 0.25).astype(np.float32)
    f0[:, 20] = f0[:, 3]
    f1[:, 9] = 2 * f0[:, 3]
    m0 = np.ones((b, l), np.float32)
    m1 = np.ones((b, l), np.float32)
    m0[1, 30], m1[1, 5] = 0.0, 0.0
    return f0, f1, m0, m1


def _model(cfg, flat, seed=0, seq_axis="seq"):
    from geoformer_tpu_torch.models import GeoFormer
    from geoformer_tpu_torch.weights import load_jax_params, random_init

    model = GeoFormer(cfg.replace(seq_axis=seq_axis))
    return random_init(model, seed) if flat is None \
        else load_jax_params(model, flat)


def _rows(x, n_coarse, scale, dim=1):
    """This rank's band of rows of ``x`` (a map of n_coarse * scale rows
    on ``dim``)."""
    from geoformer_tpu_torch.core import spmd

    band = spmd.row_band(n_coarse)
    return x.narrow(dim, band.start * scale, (band.stop - band.start)
                    * scale)


def sp_backbone(rank, seq, cfg, images, train, grads, device="cpu"):
    """The backbone on this rank's band of ``images`` [2B, H, W, 1]
    (train: on batch statistics) and a backward of sum(out * grads), the
    parameters' gradients summed over the ranks, on ``device``: the
    gathered coarse and fine maps, the running statistics, the
    gradients."""
    from geoformer_tpu_torch.core import mesh, spmd

    torch.backends.cudnn.allow_tf32 = False
    with mesh.seq_groups(seq):
        bb = _model(cfg, None).backbone.to(device)
        x = _rows(torch.from_numpy(images).to(device),
                  images.shape[1] // 8, 8)
        c, f = bb(x, train, seq=seq > 1)
        gc, gf = (_rows(torch.from_numpy(g).to(device),
                        images.shape[1] // 8, k)
                  for g, k in zip(grads, (1, 4)))
        ((c * gc).sum() + (f * gf).sum()).backward()
        named = [(k, p.grad) for k, p in bb.named_parameters()]
        g = dict(zip([k for k, _ in named], mesh.all_sum_flat(
            [v for _, v in named])))
        out = dict(coarse=_np(spmd.gather(c.detach(), 1)),
                   fine=_np(spmd.gather(f.detach(), 1)),
                   grads={k: _np(v) for k, v in g.items()},
                   stats={k: _np(v) for k, v in bb.state_dict().items()
                          if "running" in k})
    return out


def sp_transformer(rank, seq, cfg, coarse, masks):
    """The position encoding and the coarse transformer on this rank's
    band of coarse maps ``coarse`` [2B, hc, wc, C] with token masks
    ``masks`` [2, B, L]: the gathered (f0, f1)."""
    from geoformer_tpu_torch.core import mesh, spmd
    from geoformer_tpu_torch.models.position import add_position_encoding

    with mesh.seq_groups(seq):
        tf = _model(cfg, None).loftr_coarse
        b = coarse.shape[0] // 2
        band = spmd.row_band(coarse.shape[1])
        x = torch.from_numpy(coarse)[:, band]
        w = coarse.shape[2]
        toks = slice(band.start * w, band.stop * w)
        f = add_position_encoding(x, row0=band.start).reshape(2 * b, -1,
                                                              x.shape[-1])
        m0, m1 = (torch.from_numpy(m)[:, toks] for m in masks)
        with torch.no_grad():
            f0, f1 = tf(f[:b], f[b:], m0, m1, seq=seq > 1)
            return [_np(spmd.gather(x)) for x in (f0, f1)]


def sp_extract(rank, seq, f0, f1, m0, m1, chunk, thr, capacity,
               device="cpu"):
    """streaming_match_extract on this rank's rows and columns (the row
    statistics gathered) and coarse_match's ids, on ``device``, with the
    count of the streamed-extraction kernel's calls (0 on the CPU)."""
    from geoformer_tpu_torch.core import mesh, spmd
    from geoformer_tpu_torch.models.coarse_matching import coarse_match
    from geoformer_tpu_torch.ops import gam_kernels
    from geoformer_tpu_torch.ops.streaming_match import (
        streaming_match_extract,
    )

    gam_kernels.reset_launch_counts()
    with mesh.seq_groups(seq):
        band = spmd.row_band(f0.shape[1])
        whole = [torch.from_numpy(x).to(device) for x in (f0, f1, m0, m1)]
        a, b, ma, mb = (x[:, band] for x in whole)
        with torch.no_grad():
            rb, j, ca, c00 = streaming_match_extract(a, b, 0.1, ma, mb,
                                                     chunk, seq=seq > 1)
            m = coarse_match(a, b, thr, 0.1, capacity, whole[2], whole[3],
                             seq=seq > 1)
            return dict(row_best=_np(spmd.gather(rb)),
                        j_ids=_np(spmd.gather(j)), col_arg=_np(ca),
                        conf00=_np(c00),
                        ids={k: _np(v) for k, v in m._asdict().items()
                             if k != "conf"},
                        launches=gam_kernels.LAUNCHES[
                            "streaming_match_extract"])


def _forward_out(out, feats):
    from geoformer_tpu_torch.models.geoformer import gather_feats

    res = dict(geo={k: _np(v) for k, v in out.geo._asdict().items()},
               matches={k: _np(v) for k, v in out.matches._asdict().items()
                        if k != "conf"},
               matches1={k: _np(v) for k, v in
                         out.matches1._asdict().items() if k != "conf"},
               fine={k: _np(v) for k, v in out.fine._asdict().items()})
    if feats:
        res["feats"] = [_np(f) for f in gather_feats(out.feats)]
    return res


def _forward_in_split(cfg, flat, batch, noise, seed):
    model = _model(cfg, flat, seed)
    t = _tensors(batch)
    with torch.no_grad():
        out = model(t["image0"], t["image1"], t.get("mask0"),
                    t.get("mask1"), return_feats=True,
                    ransac_noise=torch.from_numpy(noise))
    return _forward_out(out, True)


def sp_forward(rank, seq, cfg, flat, batch, noise, seed=0):
    """The GeoFormer forward with seq_axis set (weights ``flat``, else
    random from ``seed``) on ``batch`` (images, masks) with the RANSAC
    uniforms ``noise``: the gathered feats, the GeoState, both passes'
    matches and the fine matches."""
    from geoformer_tpu_torch.core import mesh

    with mesh.seq_groups(seq):
        return _forward_in_split(cfg, flat, batch, noise, seed)


def sp_forward_2d(rank, seq, cfg, batch, noise, seed=0):
    """sp_forward on a (data x seq) split: this rank's data slice of the
    batch (and of the uniforms), each pair's rows over its seq group."""
    from geoformer_tpu_torch.core import mesh

    with mesh.seq_groups(seq):
        sl = mesh.local_shard_slice(batch["image0"].shape[0])
        return _forward_in_split(cfg, None, {k: v[sl] for k, v in
                                             batch.items()}, noise[sl], seed)


def sp_refusals(rank, seq, cfg, batch):
    """The forwards that a seq split refuses, by the ValueError each
    raises: an int8 model, the dense matcher (return_conf) and the
    sinkhorn matcher."""
    import dataclasses

    from geoformer_tpu_torch.config import with_int8
    from geoformer_tpu_torch.core import mesh

    t = _tensors(batch)
    cases = [("int8", with_int8(cfg, False, True), {}),
             ("dense", cfg, {"return_conf": True}),
             ("sinkhorn", cfg.replace(match=dataclasses.replace(
                 cfg.match, match_type="sinkhorn")), {})]
    refused = []
    with mesh.seq_groups(seq):
        for name, c, kw in cases:
            try:
                with torch.no_grad():
                    _model(c, None)(t["image0"], t["image1"], **kw)
            except ValueError as e:
                if "int8" in str(e) or "streaming extraction" in str(e):
                    refused.append(name)
    return refused


def sp_matcher(rank, seq, mode, cfg, imgs0, imgs1, batch_size):
    """BatchedMatcher on the CPU: ``mode`` "data" (data_parallel over the
    ranks), "seq" (seq_group), or "one" (neither)."""
    import contextlib

    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher

    model = _model(cfg, None, seq_axis=None)
    split = mesh.seq_groups(seq) if mode == "seq" \
        else contextlib.nullcontext()
    with split as layout:
        m = BatchedMatcher(cfg, model, batch_size, "cpu",
                           seq_group=layout if mode == "seq" else None,
                           data_parallel=mode == "data")
        return m.match_batch(imgs0, imgs1, return_geo=True)


def sp_collectives(rank, seq, x, weights):
    """spmd's differentiable collectives on this rank's band of ``x``
    [L, C]: loss_r = sum(gather(xb) * W[0][r]) + sum(halo_rows(xb, 1, 2)
    * W[1][r]) + sum(seq_sum(xb) * W[2][r]), each rank its own weights;
    the gradient of the sum of the ranks' losses by x, gathered."""
    from geoformer_tpu_torch.core import mesh, spmd

    with mesh.seq_groups(seq):
        r = mesh.seq_rank()
        band = spmd.row_band(x.shape[0])
        xb = torch.from_numpy(x)[band].clone().requires_grad_(True)
        w = [torch.from_numpy(ws[r]) for ws in weights]
        loss = ((spmd.gather(xb, 0) * w[0]).sum()
                + (spmd.halo_rows(xb, 1, 2, dim=0) * w[1]).sum()
                + (spmd.seq_sum(xb) * w[2]).sum())
        loss.backward()
        return _np(spmd.gather(xb.grad, 0))


def sp_step(rank, seq, kind, cfg, flat, batch, lr=0.0, sample_idx=None,
            seed=None):
    """One step with seq_axis set on a seq split of ``seq`` ranks (the
    data ranks, if any, take their slices of the global batch): ``kind``
    "train" or "depth_train" (the scalars, state and summed gradients
    after it, _after), "val" or "depth_val" (the scalars; depth_val also
    its pair data). RANSAC: ``sample_idx`` of the global batch, else a
    generator seeded ``seed``."""
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.train import trainer

    gen = None if seed is None else torch.Generator().manual_seed(seed)
    idx = None if sample_idx is None else torch.from_numpy(
        np.array(sample_idx))
    with mesh.seq_groups(seq):
        b, h, w, _ = batch["image0"].shape
        tc, state = _state(cfg.replace(seq_axis="seq"), flat, (h, w), b)
        t = _tensors(batch)
        if kind in ("train", "depth_train"):
            make = trainer.make_train_step if kind == "train" \
                else trainer.make_depth_train_step
            scalars = trainer.shard_train_step(make(tc))(
                state, t, lr, sample_idx=idx, generator=gen)
            return _after(state, scalars)
        if kind == "val":
            out = trainer.make_val_step(tc)(state, t, sample_idx=idx,
                                            generator=gen)
            return {k: float(v) for k, v in out.items()}
        scalars, pairs = trainer.make_depth_val_step(tc)(
            state, t, sample_idx=idx, generator=gen)
        return dict(scalars={k: float(v) for k, v in scalars.items()},
                    pairs={k: _np(v) for k, v in pairs.items()})


def jobs(rank, todo):
    """Several of the functions above in one spawned group: ``todo`` is
    [(name, args)], the result the list of their results."""
    return [globals()[name](rank, *args) for name, args in todo]
