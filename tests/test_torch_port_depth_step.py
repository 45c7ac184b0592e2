"""One depth-supervised training step of the port against the JAX
make_depth_train_step.

Both packages start from the same JAX-initialized weights of the narrow
model (tests/torch_port_util.small_config, GAM kernels on as in the
recipe's --pallas, force_one_match and the recipe's capacities cut to the
small model) and take one step on the same padded posed-RGBD batch
(tests/torch_port_util.depth_batch): 64x64 images with 48 rows of content
(the masks zero the last two coarse rows), scale0/scale1 1.25, depths of
a rendered room padded to 96x96. The images are a smooth texture and its
copy shifted by 7 pixels, so that the untrained model's matches give
RANSAC a homography and the GAM's cross layers count; the GT comes from
the depths and poses. The JAX step (compiled once) runs on the CPU,
where the GAM takes the gather path; the port takes the box path (K1/K2
and the backwards K3-K5 as their plain versions on the CPU). The GAM's
RANSAC draws are JAX's, injected.

The fixture asserts what the homography step's test asserts of its input
(tests/test_torch_port_train_step.py: both packages fit the same
homography, the GAM's windows lie clear of cell borders), and that the
depth GT is the same in both (no warped point on a rounding tie). RANSAC
fits exact translations from 4-point samples of a shifted image, so
warped cell centres often land on cell borders to the last bit: of the
batch seeds 0-5 at shifts of 8 and 7 pixels, only seed 4 at 7 keeps every
one 1e-4 cells clear (3.2e-4).

Bars as the homography step's: the losses and the gradient norm at 1e-4
relative, num_matches exactly, each parameter's gradient by relative L2
below 1e-2 (tensors whose gradient is not ~0), the BatchNorm statistics
after the step at 1e-4 rel / 1e-5 abs.
"""

import dataclasses

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.train import supervision as JS  # noqa: E402
from geoformer_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402,E501
from geoformer_tpu.train.trainer import TrainState as JTrainState  # noqa: E402
from geoformer_tpu.train.trainer import (  # noqa: E402
    make_depth_train_step as j_make_depth_train_step,
)
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.ops import gam_kernels  # noqa: E402
from geoformer_tpu_torch.train import supervision as PS  # noqa: E402
from geoformer_tpu_torch.train.optim import make_optimizer  # noqa: E402
from geoformer_tpu_torch.train.trainer import (  # noqa: E402
    TrainState,
    make_depth_train_step,
)
from geoformer_tpu_torch.weights import jax_to_state_dict, load_jax_params  # noqa: E402,E501
from torch_port_util import (  # noqa: E402
    assert_close,
    depth_batch,
    flatten,
    jax_forward_and_draws,
    n,
    port_config,
    small_config,
    t,
)

B, HW = 2, (64, 64)
SEED = 4                  # the batch (see the module docstring)
SHIFT = 7                 # pixels between the two images
LR = 1e-3
BORDER_MARGIN = 1e-4      # cells
SCALARS = ("loss", "loss_c", "loss_d", "loss_f", "grad_norm")


def _record_grads():
    """An optax transform that keeps the incoming updates in its state."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return updates, updates

    return optax.GradientTransformation(init, update)


def _config():
    small = small_config()
    return small_config(
        match=dataclasses.replace(small.match, force_one_match=True),
        geo=dataclasses.replace(small.geo, use_pallas=True))


@pytest.fixture(scope="module")
def run():
    cfg = _config()
    tc = jcfg.TrainConfig(batch_size=B, image_hw=HW)
    model = JGeoFormer(cfg)
    key = jax.random.key(0)
    batch = depth_batch(SEED, B, HW, shift=SHIFT)
    variables = jax.jit(model.init, static_argnames="train")(
        {"params": key, "ransac": key}, jnp.asarray(batch["image0"][:1]),
        jnp.asarray(batch["image0"][:1]), train=True)
    opt = optax.chain(_record_grads(),
                      j_make_optimizer(tc.optim, B, tc.steps_per_epoch))
    state = JTrainState(variables["params"], variables["batch_stats"],
                        opt.init(variables["params"]),
                        jnp.zeros((), jnp.int32))
    rkey = jax.random.key(11)
    step = jax.jit(j_make_depth_train_step(model, opt, tc))
    new_state, scalars = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rkey,
                              jnp.float32(LR))
    out, sample_idx = jax_forward_and_draws(
        cfg, variables, batch["image0"], batch["image1"], rkey,
        batch["mask0"], batch["mask1"], train=True)
    return dict(cfg=cfg, flat=flatten(variables), batch=batch,
                sample_idx=sample_idx, fitted_H=np.asarray(out.geo.H),
                has_H=np.asarray(out.geo.has_H),
                scalars={k: float(v) for k, v in scalars.items()},
                grads=flatten({"params": new_state.opt_state[0]}),
                batch_stats=flatten({"batch_stats": new_state.batch_stats}))


@pytest.fixture(scope="module")
def port_step(run):
    model = load_jax_params(GeoFormer(port_config(run["cfg"])), run["flat"])
    tc = tcfg.TrainConfig(batch_size=B, image_hw=HW)
    state = TrainState(model, make_optimizer(tc.optim, model.parameters()))
    grads = {}

    def keeper(name):
        def keep(p):   # after backward, before the clip
            grads[name] = p.grad.detach().clone()
        return keep

    hooks = [p.register_post_accumulate_grad_hook(keeper(name))
             for name, p in model.named_parameters()]
    gam_kernels.reset_launch_counts()
    scalars = make_depth_train_step(tc)(
        state, {k: t(v) for k, v in run["batch"].items()}, LR,
        sample_idx=t(run["sample_idx"]))
    for h in hooks:
        h.remove()
    return dict(state=state, grads=grads,
                scalars={k: float(v) for k, v in scalars.items()})


def test_the_fixture_exercises_the_gam_and_the_depth_gt(run):
    assert run["has_H"].all()
    grid = np.stack(np.meshgrid(np.arange(HW[1] // 8), np.arange(HW[0] // 8)),
                    -1).reshape(-1, 2) * 8.0
    pts = np.concatenate([grid, np.ones((len(grid), 1))], 1)
    for Hm in (run["fitted_H"], np.linalg.inv(run["fitted_H"])):
        w = pts @ Hm.transpose(0, 2, 1)
        cells = w[..., :2] / w[..., 2:] / 8
        assert np.abs(cells - np.round(cells)).min() > BORDER_MARGIN
    b = run["batch"]
    keys = ("depth0", "depth1", "T_0to1", "T_1to0", "K0", "K1")
    jgt = JS.spvs_coarse_depth_sparse(
        *(jnp.asarray(b[k]) for k in keys), HW, 8, jnp.asarray(b["mask0"]),
        jnp.asarray(b["mask1"]), jnp.asarray(b["scale0"]),
        jnp.asarray(b["scale1"]))
    pgt = PS.spvs_coarse_depth_sparse(
        *(t(b[k]) for k in keys), HW, 8, t(b["mask0"]), t(b["mask1"]),
        t(b["scale0"]), t(b["scale1"]))
    assert int(jgt[1].sum()) > 10
    for j, p in zip(jgt, pgt):
        np.testing.assert_array_equal(n(p), np.asarray(j))
    s = run["scalars"]
    assert s["num_matches"] > 8
    assert s["loss_c"] > 0 and s["loss_d"] > 0 and s["loss_f"] > 0


def test_scalars_match_jax(run, port_step):
    ref, got = run["scalars"], port_step["scalars"]
    assert set(got) == set(ref)
    for k in SCALARS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    for k in ("num_matches", "lr"):
        assert got[k] == ref[k], k
    assert port_step["state"].step == 1
    assert not any(gam_kernels.LAUNCHES.values())   # CPU: plain versions


def _port_name(jax_key):
    sd = jax_to_state_dict({jax_key: np.zeros((1, 1, 1, 1))
                            if jax_key.endswith("kernel") else np.zeros(1)})
    return next(iter(sd))


def test_every_gradient_matches_jax(run, port_step):
    ref = run["grads"]
    assert len(ref) == len(port_step["grads"])
    scale = max(np.abs(v).max() for v in ref.values())
    checked = 0
    for key, g in ref.items():
        got = n(port_step["grads"][_port_name(key)])
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
    assert checked > 0.9 * len(ref)


def test_batch_stats_after_the_step_match_jax(run, port_step):
    sd = port_step["state"].model.state_dict()
    ref = jax_to_state_dict(run["batch_stats"])
    assert ref
    for name, v in ref.items():
        assert_close(sd[name], v, 1e-4, 1e-5, name)
