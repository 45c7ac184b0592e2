"""The port's sequence-parallel train, validation and depth steps on the
CPU: two gloo ranks split each pair's rows, against the JAX package's
train step with seq_axis under a 2-device mesh and against the port's
steps in one process.

One spawned group runs every rank job of this file (core/mesh.launch, one
torch thread a rank; tests/torch_port_ranks.sp_step):

- the homography train step of tests/test_torch_port_train_step.py (the
  narrow model from JAX-initialized weights, K1/K2 and their backwards
  K3-K5 in their plain versions, 64x80, two pairs whose padding masks
  differ, JAX's RANSAC draws injected), against the JAX step under
  ``set_mesh`` at the JAX SP test's bars (tests/test_sequence_parallel.py:
  losses rtol 2e-3, the worst parameter gap after the step below 5e-3)
  and against the port's one-process step at the data-parallel tests'
  bars: the scalars within 1e-5 relative (num_inliers and num_matches
  exactly), each parameter's update (LR 1e-3) by relative L2 below 0.1
  with under 1 % of its elements off by more than LR / 10, the BatchNorm
  statistics 1e-4 / 1e-5; both ranks' states equal bit for bit. This is
  the test that catches a gradient counted twice: the fine loss and the
  replicated GAM state enter each rank's share once over the seq group
  (train/trainer.py), and a doubled term moves the update by far more
  than 0.1;
- the depth train step of tests/test_torch_port_depth_step.py's batch,
  RANSAC from one seeded generator, at world size 2 against 1 at the same
  bars;
- the homography and depth validation steps at world size 2 against 1
  (the validation fit's draws from one seeded generator): scalars within
  1e-5 relative, the depth step's pair data within 1e-4.
"""

import dataclasses

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402,E501
from geoformer_tpu.train.trainer import TrainState as JTrainState  # noqa: E402
from geoformer_tpu.train.trainer import (  # noqa: E402
    make_train_step as j_make_train_step,
)
from geoformer_tpu_torch.core import mesh  # noqa: E402
from geoformer_tpu_torch.weights import jax_to_state_dict  # noqa: E402
from test_torch_port_train_step import (  # noqa: E402
    B,
    H,
    LR,
    SCALARS,
    W,
    _batch,
    _record_grads,
    _sample_idx,
)
from torch_port_ranks import jobs, sp_step  # noqa: E402
from torch_port_util import (  # noqa: E402
    depth_batch,
    flatten,
    one_torch_thread,  # noqa: F401
    port_config,
    small_config,
)

DEPTH_HW, DEPTH_SEED, DEPTH_SHIFT, DEPTH_GEN = (64, 64), 4, 7, 11


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _train_cfg():
    return small_config(geo=dataclasses.replace(small_config().geo,
                                                use_pallas=True))


def _depth_cfg():
    small = _train_cfg()
    return small_config(geo=small.geo, match=dataclasses.replace(
        small.match, force_one_match=True))


@pytest.fixture(scope="module")
def jax_sp():
    """The JAX train step with seq_axis under a 2-device mesh, from the
    weights and draws of tests/test_torch_port_train_step.py."""
    cfg = _train_cfg()
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
    sample_idx, _, has_H = _sample_idx(cfg, variables, batch, rkey)
    step = j_make_train_step(JGeoFormer(cfg.replace(seq_axis="seq")), opt,
                             tc)
    with jax.sharding.set_mesh(Mesh(np.array(jax.devices()[:2]), ("seq",))):
        new_state, scalars = jax.jit(step)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, rkey,
            jnp.float32(LR))
    return dict(flat=flatten(variables), batch=batch, sample_idx=sample_idx,
                has_H=has_H,
                scalars={k: float(v) for k, v in scalars.items()},
                after=_numpy(jax_to_state_dict({
                    **flatten({"params": new_state.params}),
                    **flatten({"batch_stats": new_state.batch_stats})})))


def _todo(jax_sp):
    flat, batch = jax_sp["flat"], jax_sp["batch"]
    dcfg = port_config(_depth_cfg())
    dbatch = depth_batch(DEPTH_SEED, 2, DEPTH_HW, shift=DEPTH_SHIFT)
    return {
        "train": ("train", port_config(_train_cfg()), flat, batch, LR,
                  jax_sp["sample_idx"]),
        "val": ("val", port_config(_train_cfg()), flat, batch, 0.0,
                jax_sp["sample_idx"], DEPTH_GEN),
        "depth_train": ("depth_train", dcfg, flat, dbatch, LR, None,
                        DEPTH_GEN),
        "depth_val": ("depth_val", dcfg, flat, dbatch, 0.0, None,
                      DEPTH_GEN),
    }


@pytest.fixture(scope="module")
def todo(jax_sp):
    return _todo(jax_sp)


@pytest.fixture(scope="module")
def ranks(todo, tmp_path_factory):
    """Every rank job of this file in one 2-rank group; by job, the list
    of the two ranks' results."""
    names = list(todo)
    res = mesh.launch(jobs, 2, ([("sp_step", (2,) + todo[k])
                                 for k in names],),
                      init_dir=str(tmp_path_factory.mktemp("sp")),
                      timeout=600)
    return {k: [r[i] for r in res] for i, k in enumerate(names)}


def _one(todo, name):
    return sp_step(0, 1, *todo[name])


def _same_ranks(res):
    a, b = res
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], k)
    assert a["scalars"] == b["scalars"]


def _updates_close(got, ref, before, lr=LR):
    moved = 0
    for name, r in ref.items():
        g, b = got[name], before[name]
        if "running" in name:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            continue
        d_ref, d_got = r - b, g - b
        if not np.linalg.norm(d_ref):
            np.testing.assert_array_equal(d_got, d_ref, name)
            continue
        rel = np.linalg.norm(d_got - d_ref) / np.linalg.norm(d_ref)
        assert rel < 0.1, (name, rel)
        assert (np.abs(d_got - d_ref) > lr / 10).mean() < 0.01, name
        moved += 1
    assert moved > 0.9 * sum("running" not in k for k in ref)


def test_the_batch_exercises_the_gam_and_the_masks(jax_sp):
    assert jax_sp["has_H"].all()
    m = jax_sp["batch"]["mask1"]
    assert m[0].sum() != m[1].sum()


def test_sp_train_step_meets_the_jax_sp_step(jax_sp, ranks):
    res = ranks["train"]
    _same_ranks(res)
    got, ref = res[0], jax_sp["scalars"]
    for k in ("loss", "loss_c", "loss_d", "loss_f"):
        np.testing.assert_allclose(got["scalars"][k], ref[k], rtol=2e-3,
                                   err_msg=k)
    worst = max(float(np.abs(got["state"][k] - v).max())
                for k, v in jax_sp["after"].items())
    assert worst < 5e-3, worst


@pytest.mark.parametrize("kind", ["train", "depth_train"])
def test_sp_train_steps_equal_one_process(jax_sp, todo, ranks, kind):
    res = ranks[kind]
    _same_ranks(res)
    one = _one(todo, kind)
    got = res[0]
    assert set(got["scalars"]) == set(one["scalars"])
    for k in SCALARS:
        np.testing.assert_allclose(got["scalars"][k], one["scalars"][k],
                                   rtol=1e-5, err_msg=k)
    for k in ("num_inliers", "num_matches", "lr"):
        if k in one["scalars"]:
            assert got["scalars"][k] == one["scalars"][k], k
    assert one["scalars"]["loss_f"] > 0
    _updates_close(got["state"], one["state"],
                   _numpy(jax_to_state_dict(jax_sp["flat"])))


def test_sp_val_steps_equal_one_process(todo, ranks):
    one = _one(todo, "val")
    assert np.isfinite(one["val_loss"]) and one["val_num_matches"] > 0
    for got in ranks["val"]:
        assert set(got) == set(one)
        for k, v in one.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    one = _one(todo, "depth_val")
    assert one["scalars"]["val_loss_f"] > 0
    for got in ranks["depth_val"]:
        for k, v in one["scalars"].items():
            np.testing.assert_allclose(got["scalars"][k], v, rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_array_equal(got["pairs"]["valid"],
                                      one["pairs"]["valid"])
        for k in ("mkpts0", "mkpts1", "epi_errs"):
            v = one["pairs"]["valid"]
            np.testing.assert_allclose(got["pairs"][k][v],
                                       one["pairs"][k][v], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
