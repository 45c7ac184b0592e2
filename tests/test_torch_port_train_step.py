"""One whole training step of the port against the JAX make_train_step.

Both packages start from the same JAX-initialized weights of the narrow
model (tests/torch_port_util.small_config, GAM kernels on, as in the
headline recipe's --pallas) and take one step on the same batch: a smooth
texture and its copy shifted by one coarse cell (so that the untrained
features match and RANSAC fits a usable homography), with padding masks,
at 64x80 in f32. The JAX step (compiled once for the module) runs on the
CPU, where the GAM takes the gather path and plain attention with the JAX
backward of masked_kv_attention. The port runs it twice: on the gather path
and on the box path (K1/K2 and their backwards K3-K5, which on the CPU are
their plain versions). The RANSAC hypotheses are drawn with JAX as the JAX
step draws them and injected. The GT of a pure translation is exact in f32.

The GAM floors warped points to cells and RANSAC thresholds residuals, so
a last-bit difference of the fitted H moves a window by a cell where a
warped point lies on a cell border, or changes the inlier set where a
residual lies on the threshold (ROADMAP queue 3; the JAX package's own
jitted and eager window cells differ there). The input is one where
neither happens, which the fixture asserts: every warped cell centre is
at least 1e-4 cells from a border (~100x the f32 rounding at these
coordinates) and both packages find the same inliers. Of the image seeds
0-5 at this shift, 2, 3 and 5 break one of the two.

The JAX gradients come out of the step itself: its optimizer is the
recipe's clip + AdamW chained after a transform that records the incoming
gradients in the optimizer state.

Tolerances: the losses and the gradient norm at 1e-4 rel (f32 through ~40
layers, streamed LSEs); num_inliers and num_matches exactly; each
parameter's gradient by relative L2 (|g_port - g_jax| / |g_jax|) below
1e-2, for tensors whose gradient is not ~0: the backbone's gradients pass
back through ~20 train-mode BatchNorms, whose backward subtracts means, and
a 1e-6 perturbation of the input images moves them by up to 9 % (measured
with the port on this input), while the two packages agree within 4e-3 (a
wrong formula gives errors of order 1); the BatchNorm statistics after
the step at 1e-4 rel / 1e-5 abs; the update of each parameter tensor
(after - before, at the step's LR of 1e-3) by relative L2 below 0.1, with
under 1 % of its elements off by more than LR / 10: Adam's first update is
g / (|g| + 1e-8), about +-LR per element by the sign of g, so an element
whose gradient sits at the f32 noise floor may flip (measured: 0.13 % of
one backbone conv, relative L2 7e-2). The optimizer's arithmetic is held
exactly against optax in tests/test_torch_port_train_loss.py.
"""

import dataclasses
import json

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.models.coarse_matching import (  # noqa: E402
    coarse_match as j_coarse_match,
)
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from geoformer_tpu.train.trainer import TrainState as JTrainState  # noqa: E402
from geoformer_tpu.train.trainer import (  # noqa: E402
    make_train_step as j_make_train_step,
)
from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.ops import gam_kernels  # noqa: E402
from geoformer_tpu_torch.train.checkpoint import (  # noqa: E402
    save_params,
    state_dict_to_jax,
)
from geoformer_tpu_torch.train.loop import run_training  # noqa: E402
from geoformer_tpu_torch.train.optim import make_optimizer  # noqa: E402
from geoformer_tpu_torch.train.trainer import (  # noqa: E402
    TrainState,
    init_state,
    make_train_step,
)
from geoformer_tpu_torch.weights import (  # noqa: E402
    jax_to_state_dict,
    load_jax_params,
    load_npz,
)
from torch_port_util import (  # noqa: E402
    assert_close,
    flatten,
    n,
    port_config,
    small_config,
    smooth_images,
    t,
)
from torch_port_util import one_torch_thread  # noqa: E402,F401

B, H, W = 2, 64, 80
SHIFT = 8                  # pixels: one coarse cell
SEED = 1                   # the images (see the module docstring)
BORDER_MARGIN = 1e-4       # cells
LR = 1e-3
SCALARS = ("loss", "loss_c", "loss_d", "loss_f", "grad_norm")


def _record_grads():
    """An optax transform that keeps the incoming updates in its state."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return updates, updates

    return optax.GradientTransformation(init, update)


def _batch():
    img0, img1 = smooth_images(np.random.default_rng(SEED), B, H, W, SHIFT)
    H01 = np.array([[1, 0, SHIFT], [0, 1, 0], [0, 0, 1]], np.float32)
    m0 = np.ones((B, H // 8, W // 8), np.float32)
    m1 = m0.copy()
    m1[1, :, -1] = 0.0                    # a padded column in pair 1
    return {"image0": img0, "image1": img1,
            "H_0to1": np.broadcast_to(H01, (B, 3, 3)).copy(),
            "H_1to0": np.broadcast_to(np.linalg.inv(H01), (B, 3, 3))
            .astype(np.float32), "mask0": m0, "mask1": m1}


def _sample_idx(cfg, variables, batch, key):
    """The RANSAC samples the JAX train step draws (its first-pass matches
    in train mode, and the Gumbel top-4 of ransac.py:110-112 with the key
    GeoFormer.__call__ takes, split per batch row), and the fitted H."""
    model = JGeoFormer(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out, st = jax.jit(lambda v, b, k: model.apply(
        v, b["image0"], b["image1"], b["mask0"], b["mask1"], train=True,
        rngs={"ransac": k}, capture_intermediates=True,
        mutable=["intermediates", "batch_stats"]))(variables, jb, key)
    f0, f1 = st["intermediates"]["loftr_coarse"]["__call__"][0]
    matches1 = j_coarse_match(f0, f1, cfg.match.thr,
                              cfg.match.dsmax_temperature,
                              cfg.match.max_matches,
                              jb["mask0"].reshape(B, -1),
                              jb["mask1"].reshape(B, -1), force_one=True,
                              streaming=True)
    rkey = model.apply(variables, method=lambda mod: mod.make_rng("ransac"),
                       rngs={"ransac": key})
    iters = cfg.geo.ransac_iters

    def draw(k, v):
        g = jax.random.gumbel(k, (iters, v.shape[0]))
        return jax.lax.top_k(jnp.where(v[None, :], g, -jnp.inf), 4)[1]

    return (np.asarray(jax.vmap(draw)(jax.random.split(rkey, B),
                                      matches1.valid)),
            np.asarray(out.geo.H), np.asarray(out.geo.has_H))


@pytest.fixture(scope="module")
def run():
    cfg = small_config(geo=dataclasses.replace(
        small_config().geo, use_pallas=True))
    tc = jcfg.TrainConfig(batch_size=B, image_hw=(H, W))
    model = JGeoFormer(cfg)
    key = jax.random.key(0)
    batch = _batch()
    variables = jax.jit(model.init, static_argnames="train")(
        {"params": key, "ransac": key}, jnp.asarray(batch["image0"][:1]),
        jnp.asarray(batch["image0"][:1]), train=True)
    opt = optax.chain(_record_grads(),
                      j_make_optimizer(tc.optim, B, tc.steps_per_epoch))
    state = JTrainState(variables["params"], variables["batch_stats"],
                        opt.init(variables["params"]),
                        jnp.zeros((), jnp.int32))
    rkey = jax.random.key(11)
    step = jax.jit(j_make_train_step(model, opt, tc))
    new_state, scalars = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rkey,
                              jnp.float32(LR))
    sample_idx, fitted_H, has_H = _sample_idx(cfg, variables, batch, rkey)
    return dict(cfg=cfg, flat=flatten(variables), batch=batch,
                sample_idx=sample_idx, fitted_H=fitted_H, has_H=has_H,
                scalars={k: float(v) for k, v in scalars.items()},
                grads=flatten({"params": new_state.opt_state[0]}),
                params=flatten({"params": new_state.params}),
                batch_stats=flatten({"batch_stats": new_state.batch_stats}))


@pytest.fixture(scope="module", params=["box", "gather"])
def port_step(request, run):
    pcfg = port_config(run["cfg"])
    pcfg = pcfg.replace(geo=dataclasses.replace(
        pcfg.geo, use_pallas=request.param == "box"))
    model = load_jax_params(GeoFormer(pcfg), run["flat"])
    tc = tcfg.TrainConfig(batch_size=B, image_hw=(H, W))
    state = TrainState(model, make_optimizer(tc.optim, model.parameters()))
    grads = {}

    def keeper(name):
        def keep(p):   # after backward, before the clip
            grads[name] = p.grad.detach().clone()
        return keep

    hooks = [p.register_post_accumulate_grad_hook(keeper(name))
             for name, p in model.named_parameters()]
    gam_kernels.reset_launch_counts()
    scalars = make_train_step(tc)(
        state, {k: t(v) for k, v in run["batch"].items()}, LR,
        sample_idx=t(run["sample_idx"]))
    for h in hooks:
        h.remove()
    return dict(path=request.param, state=state, grads=grads,
                scalars={k: float(v) for k, v in scalars.items()})


def test_the_fixture_exercises_the_gam_and_both_losses(run):
    """Both pairs have a homography, so the GAM's cross layers count, and
    no warped cell centre lies within BORDER_MARGIN of a cell border."""
    assert run["has_H"].all()
    grid = np.stack(np.meshgrid(np.arange(W // 8), np.arange(H // 8)),
                    -1).reshape(-1, 2) * 8.0
    pts = np.concatenate([grid, np.ones((len(grid), 1))], 1)
    for Hm in (run["fitted_H"], np.linalg.inv(run["fitted_H"])):
        w = pts @ Hm.transpose(0, 2, 1)
        cells = w[..., :2] / w[..., 2:] / 8
        assert np.abs(cells - np.round(cells)).min() > BORDER_MARGIN
    s = run["scalars"]
    assert s["num_inliers"] > 4 and s["num_matches"] > 8
    assert s["loss_c"] > 0 and s["loss_d"] > 0 and s["loss_f"] > 0
    assert np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0


def test_scalars_match_jax(run, port_step):
    ref, got = run["scalars"], port_step["scalars"]
    assert set(got) == set(ref)
    for k in SCALARS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    for k in ("num_inliers", "num_matches", "lr"):
        assert got[k] == ref[k], k
    assert port_step["state"].step == 1
    assert not any(gam_kernels.LAUNCHES.values())   # CPU: plain versions


def _port_name(jax_key):
    """params/a/b/kernel -> the port's parameter name (see weights.py)."""
    sd = jax_to_state_dict({jax_key: np.zeros((1, 1, 1, 1))
                            if jax_key.endswith("kernel") else np.zeros(1)})
    return next(iter(sd))


def test_every_gradient_matches_jax(run, port_step):
    ref = run["grads"]
    assert len(ref) == len(port_step["grads"])
    scale = max(np.abs(v).max() for v in ref.values())
    checked = 0
    for key, g in ref.items():
        name = _port_name(key)
        got = n(port_step["grads"][name])
        if g.ndim == 4:
            got = got.transpose(2, 3, 1, 0)
        elif g.ndim == 2:
            got = got.T
        norm = np.linalg.norm(g)
        if norm < 1e-6 * scale:
            np.testing.assert_allclose(got, g, atol=1e-6 * scale,
                                       err_msg=key)
            continue
        rel = np.linalg.norm(got - g) / norm
        assert rel < 1e-2, (key, rel)
        checked += 1
    # the GAM's and both transformers' weights carry gradient
    assert checked > 0.9 * len(ref)


def test_params_and_batch_stats_after_the_step_match_jax(run, port_step):
    model = port_step["state"].model
    sd = model.state_dict()
    before = jax_to_state_dict(run["flat"])
    ref_sd = jax_to_state_dict({**run["params"], **run["batch_stats"]})
    for name, ref in ref_sd.items():
        got = sd[name]
        if "running" in name:
            assert_close(got, ref, 1e-4, 1e-5, name)
            continue
        d_ref = n(ref - before[name])
        d_got = n(got - before[name])
        rel = np.linalg.norm(d_got - d_ref) / np.linalg.norm(d_ref)
        assert rel < 0.1, (name, rel)
        assert (np.abs(d_got - d_ref) > LR / 10).mean() < 0.01, name
    # the running statistics moved: BatchNorm ran on batch statistics
    assert not torch.allclose(sd["backbone.bn1.running_mean"],
                              torch.zeros_like(sd["backbone.bn1.running_mean"]))


def test_checkpoint_crosses_packages(run, port_step, tmp_path):
    """save_params writes the JAX npz layout: JAX's load_variables reads
    it with the JAX model's own keys, and it loads back into the port."""
    model = port_step["state"].model
    path = str(tmp_path / "params_final.npz")
    save_params(path, model, step=1)
    jv = load_variables(path)
    got = flatten(jv)
    assert set(got) == set(run["flat"])
    for k, v in got.items():
        assert v.shape == run["flat"][k].shape, k
    assert int(load_npz(path)["step"]) == 1
    back = load_jax_params(GeoFormer(model.config), load_npz(path))
    for name, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[name], v), name
    assert set(state_dict_to_jax(model)) == set(run["flat"])


def test_run_training_two_steps_on_the_cpu(run, tmp_path):
    cfg = port_config(run["cfg"])
    out = tmp_path / "ckpt"
    state = run_training(steps=2, batch_size=2, image_hw=(H, W),
                         ckpt_dir=str(out), log_every=1, model_cfg=cfg,
                         bank_size=3, device="cpu")
    assert state.step == 2
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
             .splitlines()]
    assert [m["step"] for m in lines] == [1, 2]
    for m in lines:
        assert {"loss", "loss_c", "loss_d", "loss_f", "num_inliers",
                "num_matches", "grad_norm", "lr", "imgs_per_s"} <= set(m)
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    flat = load_npz(str(out / "params_final.npz"))
    assert int(flat["step"]) == 2
    assert set(flat) - {"step"} == set(run["flat"])


def test_init_state_makes_a_model_on_the_device():
    cfg = port_config(small_config())
    state = init_state(cfg, tcfg.TrainConfig(), seed=3, device="cpu")
    assert state.step == 0 and isinstance(state.model, GeoFormer)
    assert next(state.model.parameters()).device.type == "cpu"
