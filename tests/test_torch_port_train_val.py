"""The port's validation step against the JAX make_val_step.

The input is the train-step test's (tests/test_torch_port_train_step.py):
the narrow model with the GAM kernels on, a smooth texture and its copy
shifted by one coarse cell, padding masks, 64x80 in f32, every warped cell
centre at least 1e-4 cells from a border in train mode. The BatchNorm running
statistics are set to seeded values, so that the inference-mode forward
normalizes with statistics that are not the identity. Both RNG draws of
the JAX step are made with JAX and injected: the GAM's RANSAC samples
(the model's "ransac" stream from the step's key) and the fit's (Gumbel
top-4 over each pair's valid fine matches, from the step's key split per
pair, geometry/ransac.py:110-112).

Tolerances: the losses at 1e-4 rel (f32 through ~40 layers); val_fit_rate
and val_num_matches exactly (a count); val_corner_err_median within 1e-3
px (the same fit in f32 from the same samples, IRLS through an eigh).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.geometry.homography import (  # noqa: E402
    corner_error as j_corner_error,
)
from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from geoformer_tpu.train.trainer import TrainState as JTrainState  # noqa: E402
from geoformer_tpu.train.trainer import (  # noqa: E402
    make_val_step as j_make_val_step,
)
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch.geometry.homography import corner_error  # noqa: E402
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.train.optim import make_optimizer  # noqa: E402
from geoformer_tpu_torch.train.trainer import (  # noqa: E402
    TrainState,
    jnp_median,
    make_val_step,
)
from geoformer_tpu_torch.weights import load_jax_params  # noqa: E402
from test_torch_port_train_step import B, H, W, _batch  # noqa: E402
from torch_port_util import (  # noqa: E402
    assert_close,
    flatten,
    jax_forward_and_draws,
    port_config,
    small_config,
    t,
)

LOSSES = ("val_loss", "val_loss_c", "val_loss_d", "val_loss_f")
FIT_ITERS = 256


def _with_running_stats(variables, seed=0):
    """The variables with seeded BatchNorm running statistics."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(
                fill, variables["batch_stats"])}


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
    variables = _with_running_stats(variables)
    opt = j_make_optimizer(tc.optim, B, tc.steps_per_epoch)
    state = JTrainState(variables["params"], variables["batch_stats"],
                        opt.init(variables["params"]),
                        jnp.zeros((), jnp.int32))
    rkey = jax.random.key(21)
    scalars = jax.jit(j_make_val_step(model, tc))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rkey)
    out, sample_idx = jax_forward_and_draws(
        cfg, variables, batch["image0"], batch["image1"], rkey,
        batch["mask0"], batch["mask1"])
    valid = out.fine.valid

    def draw(k, v):
        g = jax.random.gumbel(k, (FIT_ITERS, v.shape[0]))
        return jax.lax.top_k(jnp.where(v[None, :], g, -jnp.inf), 4)[1]

    fit_idx = np.asarray(jax.vmap(draw)(jax.random.split(rkey, B), valid))
    return dict(cfg=cfg, flat=flatten(variables), batch=batch,
                sample_idx=sample_idx, fit_idx=fit_idx,
                geo_has_H=np.asarray(out.geo.has_H),
                scalars={k: float(v) for k, v in scalars.items()})


@pytest.fixture(scope="module")
def port_scalars(run):
    model = load_jax_params(GeoFormer(port_config(run["cfg"])), run["flat"])
    tc = tcfg.TrainConfig(batch_size=B, image_hw=(H, W))
    state = TrainState(model, make_optimizer(tc.optim, model.parameters()))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    scalars = make_val_step(tc)(
        state, {k: t(v) for k, v in run["batch"].items()},
        sample_idx=t(run["sample_idx"]), fit_idx=t(run["fit_idx"]))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)  # no update
    return {k: float(v) for k, v in scalars.items()}


def test_the_fixture_fits_homographies(run):
    """The GAM fits a homography in both pairs and the validation fit
    succeeds somewhere, so the corner error is finite."""
    s = run["scalars"]
    assert run["geo_has_H"].all()
    assert s["val_num_matches"] > 4 and s["val_fit_rate"] > 0
    assert np.isfinite(s["val_corner_err_median"])
    assert all(s[k] > 0 for k in LOSSES)


def test_val_scalars_match_jax(run, port_scalars):
    ref, got = run["scalars"], port_scalars
    assert set(got) == set(ref)
    for k in LOSSES:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    for k in ("val_fit_rate", "val_num_matches"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["val_corner_err_median"],
                               ref["val_corner_err_median"], rtol=0,
                               atol=1e-3)


def test_corner_error_matches_jax():
    """H_pred, H_gt order; [B] from [B, 3, 3]; 1e-5 rel (f32 warps)."""
    rng = np.random.default_rng(0)
    Hp = (np.eye(3) + 0.05 * rng.standard_normal((6, 3, 3))).astype(
        np.float32)
    Hg = (np.eye(3) + 0.05 * rng.standard_normal((6, 3, 3))).astype(
        np.float32)
    Hp[..., 2, :2] *= 1e-3
    Hg[..., 2, :2] *= 1e-3
    ref = jax.vmap(lambda a, b: j_corner_error(a, b, (H, W)))(Hp, Hg)
    assert_close(corner_error(t(Hp), t(Hg), (H, W)), ref, 1e-5, 1e-5)
    assert float(corner_error(t(Hg[:1]), t(Hg[:1]), (H, W))[0]) == 0.0


@pytest.mark.parametrize("errs", [[1.0, 2.0, np.inf, np.inf], [1.0, np.inf],
                                  [3.0, 1.0, 2.0, 5.0], [3.0, 1.0, 2.0],
                                  [np.inf], [2.0, np.nan, 1.0]])
def test_median_is_jnp_median(errs):
    """jnp.median, not torch.median (the lower middle) nor torch.quantile
    (nan for inf): an even count averages the two middle values."""
    ref = float(jnp.median(jnp.asarray(errs, jnp.float32)))
    got = float(jnp_median(torch.tensor(errs, dtype=torch.float32)))
    np.testing.assert_equal(got, ref)


def test_val_step_draws_from_a_generator(run):
    model = load_jax_params(GeoFormer(port_config(run["cfg"])), run["flat"])
    tc = tcfg.TrainConfig(batch_size=B, image_hw=(H, W))
    state = TrainState(model, make_optimizer(tc.optim, model.parameters()))
    batch = {k: t(v) for k, v in run["batch"].items()}
    step = make_val_step(tc)
    a = step(state, batch, generator=torch.Generator().manual_seed(0))
    b = step(state, batch, generator=torch.Generator().manual_seed(0))
    assert {k: float(v) for k, v in a.items()} == \
        {k: float(v) for k, v in b.items()}
