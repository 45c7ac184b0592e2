"""Data parallelism of the port at world size 2 on the CPU, against the
JAX package's sharded step and against the port at world size 1.

Two ranks run in spawned processes over gloo (core/mesh.launch, one torch
thread each, file rendezvous under the test's temporary directory), all
of this file's rank work in one group (tests/torch_port_ranks.py):

- the homography train step of tests/test_torch_port_train_step.py (the
  narrow model from JAX-initialized weights, both GAM kernels' plain
  versions, 64x80, the same batch of two pairs whose padding masks differ,
  so the ranks' loss counts differ; JAX's RANSAC draws injected), one
  pair a rank through shard_train_step, against the JAX shard_train_step
  on a 2-device CPU mesh and the port's one-process step, at that file's
  bars: losses and gradient norm 1e-4 relative, num_inliers and
  num_matches exactly, each parameter's gradient (after the sum over the
  ranks and the clip; JAX's recorded gradient times the same clip factor)
  by relative L2 below 1e-2, the BatchNorm statistics 1e-4 / 1e-5, each
  parameter's update by relative L2 below 0.1 with under 1 % of its
  elements off by more than LR / 10; both ranks' states equal bit for bit;
- the depth train step of tests/test_torch_port_depth_step.py's batch,
  the RANSAC drawn from one seeded generator for the global batch, at
  world size 2 against 1 at the same bars;
- run_training for 2 steps (batch 2, a validation after step 2) at world
  size 2 against 1: the same metrics lines (1e-4 relative), rank 0 alone
  printing and writing, the same BatchNorm statistics after the run;
- run_depth_training at world size 2 (batch 2, one pair a rank) on a
  rendered corpus of three train and two val scenes: each rank's scene
  streams are the JAX scene_balanced_stream's with shard=(rank, 2) (the
  first batches' images equal), rank 0 alone writes, both ranks return
  the same validation record;
- run_depth_validation at world size 2 on one batch a rank: the pairs
  gathered and deduplicated by id give the record of world size 1 on the
  two batches (pose AUCs and precision equal, the val scalars' means
  within 1e-6).
"""

import dataclasses
import json

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.data.megadepth import (  # noqa: E402
    scene_balanced_stream as j_scene_stream,
)
from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402,E501
from geoformer_tpu.train.trainer import TrainState as JTrainState  # noqa: E402
from geoformer_tpu.train.trainer import (  # noqa: E402
    make_train_step as j_make_train_step,
    shard_train_step as j_shard_train_step,
)
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch.core import mesh  # noqa: E402
from geoformer_tpu_torch.data.depth_corpus import build_scene  # noqa: E402
from geoformer_tpu_torch.train.depth_loop import (  # noqa: E402
    run_depth_validation,
)
from geoformer_tpu_torch.train.loop import run_training  # noqa: E402
from geoformer_tpu_torch.train.trainer import (  # noqa: E402
    make_depth_train_step,
    make_depth_val_step,
    make_train_step,
)
from geoformer_tpu_torch.weights import jax_to_state_dict  # noqa: E402
from test_torch_port_train_step import (  # noqa: E402
    B,
    H,
    LR,
    SCALARS,
    W,
    _batch,
    _port_name,
    _record_grads,
    _sample_idx,
)
from torch_port_ranks import _state, jobs  # noqa: E402
from torch_port_util import (  # noqa: E402
    depth_batch,
    flatten,
    one_torch_thread,  # noqa: F401
    port_config,
    small_config,
    t,
)

CLIP = tcfg.OptimConfig().gradient_clipping
DEPTH_HW, DEPTH_SEED, DEPTH_SHIFT, DEPTH_GEN = (64, 64), 4, 7, 11
LOOP_HW = (64, 80)
SCENE_KW = dict(min_overlap_score=0.4, img_resize=64, depth_pad=128)


def _train_cfg():
    return small_config(geo=dataclasses.replace(small_config().geo,
                                                use_pallas=True))


def _depth_cfg():
    small = _train_cfg()
    return small_config(geo=small.geo, match=dataclasses.replace(
        small.match, force_one_match=True))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX shard_train_step on a 2-device mesh, and its draws."""
    cfg = _train_cfg()
    tc = jcfg.TrainConfig(batch_size=B, image_hw=(H, W))
    model = JGeoFormer(cfg)
    key = jax.random.key(0)
    batch = _batch()
    variables = jax.jit(model.init, static_argnames="train")(
        {"params": key, "ransac": key}, jnp.asarray(batch["image0"][:1]),
        jnp.asarray(batch["image0"][:1]), train=True)
    flat = flatten(variables)
    opt = optax.chain(_record_grads(),
                      j_make_optimizer(tc.optim, B, tc.steps_per_epoch))
    rkey = jax.random.key(11)
    sample_idx, _, has_H = _sample_idx(cfg, variables, batch, rkey)
    state = JTrainState(variables["params"], variables["batch_stats"],
                        opt.init(variables["params"]),
                        jnp.zeros((), jnp.int32))
    jm = Mesh(np.array(jax.devices()[:2]), ("data",))
    step = j_shard_train_step(j_make_train_step(model, opt, tc), jm)
    new_state, scalars = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rkey,
                              jnp.float32(LR))
    return dict(flat=flat, batch=batch, sample_idx=sample_idx, has_H=has_H,
                scalars={k: float(v) for k, v in scalars.items()},
                grads=flatten({"params": new_state.opt_state[0]}),
                after=jax_to_state_dict({
                    **flatten({"params": new_state.params}),
                    **flatten({"batch_stats": new_state.batch_stats})}))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_corpus")
    for name, index, seed in (("scene0000", "index", 1),
                              ("scene0001", "index", 2),
                              ("scene0002", "index", 3),
                              ("val0000", "index_val", 4),
                              ("val0001", "index_val", 5)):
        build_scene(str(root), str(root / index), name, seed, n_cams=3,
                    hw=(96, 128), cluttered=True)
    return root


def _loop_kw(out):
    return dict(steps=2, batch_size=2, image_hw=LOOP_HW, ckpt_dir=str(out),
                log_every=1, val_every=2, bank_size=3,
                model_cfg=port_config(small_config()))


def _depth_loop_kw(corpus, out):
    return dict(npz_dir=str(corpus / "index"), root_dir=str(corpus),
                val_npz_dir=str(corpus / "index_val"), steps=2,
                batch_size=2, image_hw=(64, 64), ckpt_dir=str(out),
                log_every=1, val_every=2, n_val_batches=1,
                model_cfg=port_config(small_config()), depth_pad=128)


def _val_batches():
    """One posed-RGBD batch of one pair a rank."""
    return [[depth_batch(20 + r, 1, DEPTH_HW, shift=DEPTH_SHIFT)]
            for r in range(2)]


@pytest.fixture(scope="module")
def ranks(jax_run, corpus, tmp_path_factory):
    """Every rank job of this file in one 2-rank group; by job, the list
    of the two ranks' results."""
    out = tmp_path_factory.mktemp("dp")
    flat = jax_run["flat"]
    todo = [
        ("train_step", (port_config(_train_cfg()), flat, jax_run["batch"],
                        jax_run["sample_idx"], LR)),
        ("depth_step", (port_config(_depth_cfg()), flat,
                        depth_batch(DEPTH_SEED, 2, DEPTH_HW,
                                    shift=DEPTH_SHIFT), LR, DEPTH_GEN)),
        ("run_training", (_loop_kw(out / "loop"),)),
        ("depth_loop", (_depth_loop_kw(corpus, out / "depth"),)),
        ("depth_validation", (port_config(_depth_cfg()), flat,
                              _val_batches())),
    ]
    res = mesh.launch(jobs, 2, (todo,), init_dir=str(out), timeout=600)
    return dict(out=out, **{name: [r[i] for r in res]
                            for i, (name, _) in enumerate(todo)})


def _one_process_step(cfg, flat, batch, make_step, **kw):
    b, h, w, _ = batch["image0"].shape
    tc, state = _state(port_config(cfg), flat, (h, w), b)
    scalars = make_step(tc)(state, {k: t(v) for k, v in batch.items()},
                            LR, **kw)
    return dict(scalars={k: float(v) for k, v in scalars.items()},
                state={k: v.numpy().copy() for k, v in
                       state.model.state_dict().items()},
                grads={k: p.grad.numpy().copy() for k, p in
                       state.model.named_parameters()})


@pytest.fixture(scope="module")
def one_process(jax_run):
    return _one_process_step(_train_cfg(), jax_run["flat"],
                             jax_run["batch"], make_train_step,
                             sample_idx=t(jax_run["sample_idx"]))


def _same_ranks(res):
    a, b = res
    assert set(a["state"]) == set(b["state"])
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], k)
    assert a["scalars"] == b["scalars"]


def _updates_close(got: dict, ref: dict, before: dict):
    for name, r in ref.items():
        g, r, b = (np.asarray(x) for x in (got[name], r, before[name]))
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
        assert (np.abs(d_got - d_ref) > LR / 10).mean() < 0.01, name


def _grads_close(got: dict, ref: dict):
    scale = max(np.abs(v).max() for v in ref.values())
    checked = 0
    for name, r in ref.items():
        g = got[name]
        norm = np.linalg.norm(r)
        if norm < 1e-6 * scale:
            np.testing.assert_allclose(g, r, atol=1e-6 * scale,
                                       err_msg=name)
            continue
        rel = np.linalg.norm(g - r) / norm
        assert rel < 1e-2, (name, rel)
        checked += 1
    assert checked > 0.9 * len(ref)


def test_the_pairs_differ_in_padding_and_both_have_a_homography(jax_run):
    m = jax_run["batch"]["mask1"]
    assert m[0].sum() != m[1].sum()
    assert jax_run["has_H"].all()


def test_train_step_scalars_match_jax_shard_step(jax_run, one_process,
                                                 ranks):
    res = ranks["train_step"]
    _same_ranks(res)
    got = res[0]["scalars"]
    for ref in (jax_run["scalars"], one_process["scalars"]):
        assert set(got) == set(ref)
        for k in SCALARS:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                       err_msg=k)
        for k in ("num_inliers", "num_matches", "lr"):
            assert got[k] == ref[k], k


def test_train_step_gradients_match_jax_shard_step(jax_run, one_process,
                                                   ranks):
    got = ranks["train_step"][0]["grads"]
    factor = min(1.0, CLIP / jax_run["scalars"]["grad_norm"])
    ref = {}
    for key, g in jax_run["grads"].items():
        if g.ndim == 4:
            g = g.transpose(3, 2, 0, 1)
        elif g.ndim == 2:
            g = g.T
        ref[_port_name(key)] = g * factor
    assert set(ref) == set(got)
    _grads_close(got, ref)
    _grads_close(got, one_process["grads"])


def test_train_step_update_and_batch_stats_match_jax(jax_run, one_process,
                                                     ranks):
    got = ranks["train_step"][0]["state"]
    before = jax_to_state_dict(jax_run["flat"])
    _updates_close(got, jax_run["after"], before)
    _updates_close(got, one_process["state"], before)


def test_depth_step_at_world_size_2_equals_world_size_1(jax_run, ranks):
    res = ranks["depth_step"]
    _same_ranks(res)
    batch = depth_batch(DEPTH_SEED, 2, DEPTH_HW, shift=DEPTH_SHIFT)
    one = _one_process_step(_depth_cfg(), jax_run["flat"], batch,
                            make_depth_train_step,
                            generator=torch.Generator().manual_seed(
                                DEPTH_GEN))
    got = res[0]["scalars"]
    assert set(got) == set(one["scalars"])
    for k in SCALARS:
        np.testing.assert_allclose(got[k], one["scalars"][k], rtol=1e-4,
                                   err_msg=k)
    assert got["num_matches"] == one["scalars"]["num_matches"]
    assert got["loss_f"] > 0
    _grads_close(res[0]["grads"], one["grads"])
    _updates_close(res[0]["state"], one["state"],
                   jax_to_state_dict(jax_run["flat"]))


def _metrics(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_run_training_at_world_size_2_equals_world_size_1(ranks, tmp_path):
    res = ranks["run_training"]
    out = ranks["out"] / "loop"
    one = run_training(**_loop_kw(tmp_path), device="cpu")
    got, ref = _metrics(out / "metrics.jsonl"), _metrics(
        tmp_path / "metrics.jsonl")
    assert [m["step"] for m in got] == [m["step"] for m in ref] == [1, 2, 2]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k not in ("imgs_per_s", "step"):
                np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6,
                                           err_msg=k)
    # rank 0 alone prints and writes
    assert res[1]["printed"] == ""
    assert res[0]["printed"].count("\n") == 4     # schedule + 3 records
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in tmp_path.iterdir())
    assert res[0]["step"] == res[1]["step"] == one.step == 2
    for k, v in one.model.state_dict().items():
        np.testing.assert_array_equal(res[0]["state"][k],
                                      res[1]["state"][k], k)
        if "running" in k:
            np.testing.assert_allclose(res[0]["state"][k], v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_depth_loop_splits_scenes_as_the_jax_shards(ranks, corpus):
    res = ranks["depth_loop"]
    for r, rec in enumerate(res):
        train, val = rec["streams"]
        assert (train["batch"], train["seed"], train["shard"]) == (1, 66,
                                                                  (r, 2))
        assert (val["batch"], val["seed"], val["shard"]) == (1, 67, (r, 2))
        for s in (train, val):
            ref = j_scene_stream(s["npz_dir"], str(corpus), 1, s["seed"],
                                 shard=(r, 2), **SCENE_KW)
            for img in s["images"]:
                np.testing.assert_array_equal(img, next(ref)["image0"])
    # the shards read different scenes
    assert not np.array_equal(res[0]["streams"][0]["images"][0],
                              res[1]["streams"][0]["images"][0])
    assert res[0]["best"] == res[1]["best"] and "auc@10" in res[0]["best"]
    assert res[1]["printed"] == ""
    lines = _metrics(ranks["out"] / "depth" / "metrics.jsonl")
    assert [m["step"] for m in lines] == [1, 2, 2]
    assert lines[-1]["auc@10"] == res[0]["best"]["auc@10"]


def test_depth_validation_gathers_every_ranks_pairs(jax_run, ranks):
    got = ranks["depth_validation"]
    assert got[0] == got[1]
    batches = _val_batches()
    tc, state = _state(port_config(_depth_cfg()), jax_run["flat"], DEPTH_HW,
                       1)
    ref = run_depth_validation(
        make_depth_val_step(tc), state,
        [{k: t(v) for k, v in b.items()} for b in batches[0] + batches[1]])
    assert set(got[0]) == set(ref)
    for k, v in ref.items():
        if k.startswith("val_"):
            np.testing.assert_allclose(got[0][k], v, rtol=1e-6, err_msg=k)
        else:
            assert got[0][k] == v, k
