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
    from geoformer_tpu_torch.weights import load_jax_params

    model = load_jax_params(GeoFormer(cfg), flat)
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


def jobs(rank, todo):
    """Several of the functions above in one spawned group: ``todo`` is
    [(name, args)], the result the list of their results."""
    return [globals()[name](rank, *args) for name, args in todo]
