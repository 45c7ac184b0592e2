"""The port's losses, BatchNorm training mode and optimizer against JAX.

Losses: coarse_loss, fine_loss and the streaming coarse loss, values and
feature gradients (jax.grad against torch autograd), with and without
padding masks, sparse and dense supervision, focal and cross-entropy.
BatchNorm: the train-mode output, its gradients and the updated running
statistics against flax's mutated ``batch_stats``, alone and in the
backbone. Optimizer: the schedule, and optax's clip + AdamW at a varying LR
against the port's over several steps.

Tolerances: f32 losses and gradients at 1e-4 rel / 1e-6 abs (the same
sums in another order; the streamed LSEs are logs of sums of hundreds of
exponentials); BatchNorm at 1e-4 rel / 1e-5 abs; parameters after AdamW at
1e-5 rel / 1e-6 abs; the schedule exactly (the same Python float math).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as fnn  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.models.backbone import ResNetFPN as JResNetFPN  # noqa: E402
from geoformer_tpu.ops.fused_loss import (  # noqa: E402
    streaming_coarse_loss as j_streaming_coarse_loss,
)
from geoformer_tpu.train.loss import (  # noqa: E402
    coarse_loss as j_coarse_loss,
    fine_loss as j_fine_loss,
)
from geoformer_tpu.train.optim import (  # noqa: E402
    make_optimizer as j_make_optimizer,
    make_schedule as j_make_schedule,
)
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch.models.backbone import ResNetFPN  # noqa: E402
from geoformer_tpu_torch.models.layers import BatchNorm  # noqa: E402
from geoformer_tpu_torch.ops.fused_loss import streaming_coarse_loss  # noqa: E402
from geoformer_tpu_torch.train.loss import coarse_loss, fine_loss  # noqa: E402
from geoformer_tpu_torch.train.optim import (  # noqa: E402
    clip_by_global_norm_,
    global_norm,
    make_optimizer,
    make_schedule,
)
from geoformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import assert_close, flatten, n, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

LOSS_CONFIGS = {
    "sparse_focal": {},
    "dense_focal": dict(sparse_spvs=False),
    "dense_ce": dict(coarse_type="cross_entropy", sparse_spvs=False),
}


def _loss_cfgs(name):
    kw = LOSS_CONFIGS[name]
    return jcfg.LossConfig(**kw), tcfg.LossConfig(**kw)


def _stream_inputs(seed, masked, b=2, hc=6, wc=8, c=16):
    rng = np.random.default_rng(seed)
    l = hc * wc
    f0, f1 = (rng.normal(size=(b, l, c)).astype(np.float32)
              for _ in range(2))
    gt_j = rng.integers(0, l, (b, l)).astype(np.int32)
    gt_valid = rng.random((b, l)) > 0.5
    m0 = m1 = None
    if masked:
        m0 = (rng.random((b, hc, wc)) > 0.2).astype(np.float32)
        m1 = (rng.random((b, hc, wc)) > 0.2).astype(np.float32)
    return f0, f1, gt_j, gt_valid, m0, m1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(LOSS_CONFIGS))
def test_streaming_coarse_loss_value_and_grads_match_jax(name, masked):
    jc, pc = _loss_cfgs(name)
    f0, f1, gt_j, gt_valid, m0, m1 = _stream_inputs(0, masked)
    jm = [None if m is None else jnp.asarray(m) for m in (m0, m1)]

    def jloss(a, b_):
        # chunk 20 does not divide L = 48: three chunks, the last ragged
        return j_streaming_coarse_loss(a, b_, jnp.asarray(gt_j),
                                       jnp.asarray(gt_valid), jc, 0.1, *jm,
                                       chunk=20)

    ref, (g0, g1) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(f0), jnp.asarray(f1))
    a, b_ = t(f0).requires_grad_(), t(f1).requires_grad_()
    got = streaming_coarse_loss(
        a, b_, t(gt_j), t(gt_valid), pc, 0.1,
        *(None if m is None else t(m) for m in (m0, m1)), chunk=20)
    got.backward()
    assert_close(got, ref, 1e-4, 1e-6, "loss")
    assert_close(a.grad, g0, 1e-4, 1e-6, "dfeat0")
    assert_close(b_.grad, g1, 1e-4, 1e-6, "dfeat1")


def test_streaming_coarse_loss_raises_on_axis_name():
    """axis_name is ported: without a seq split (core/mesh.seq_groups) it
    is the replicated loss, bit for bit (the split itself:
    tests/test_torch_port_seq_train.py)."""
    f0, f1, gt_j, gt_valid, _, _ = _stream_inputs(1, False)
    args = (t(f0), t(f1), t(gt_j), t(gt_valid), tcfg.LossConfig())
    assert torch.equal(streaming_coarse_loss(*args, axis_name="seq"),
                       streaming_coarse_loss(*args))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(LOSS_CONFIGS))
def test_coarse_loss_matches_jax(name, weighted):
    jc, pc = _loss_cfgs(name)
    rng = np.random.default_rng(2)
    conf = rng.random((2, 12, 10)).astype(np.float32)
    conf_gt = (rng.random((2, 12, 10)) > 0.9).astype(np.float32)
    w = (rng.random((2, 12, 10)) > 0.3).astype(np.float32) if weighted \
        else None
    ref, gref = jax.value_and_grad(lambda c: j_coarse_loss(
        c, jnp.asarray(conf_gt), jc,
        None if w is None else jnp.asarray(w)))(jnp.asarray(conf))
    x = t(conf).requires_grad_()
    got = coarse_loss(x, t(conf_gt), pc, None if w is None else t(w))
    got.backward()
    assert_close(got, ref, 1e-5, 1e-6)
    assert_close(x.grad, gref, 1e-5, 1e-6)


@pytest.mark.parametrize("case", ["mixed", "no_positive", "no_valid"])
def test_fine_loss_matches_jax(case):
    jc, pc = _loss_cfgs("sparse_focal")
    rng = np.random.default_rng(3)
    conf = rng.random((2, 5, 9, 9)).astype(np.float32)
    label = (rng.random((2, 5, 9, 9)) > 0.95).astype(np.float32)
    valid = rng.random((2, 5)) > 0.3
    if case == "no_positive":
        label[:] = 0
    if case == "no_valid":
        valid[:] = False
    ref, gref = jax.value_and_grad(lambda c: j_fine_loss(
        c, jnp.asarray(label), jnp.asarray(valid), jc))(jnp.asarray(conf))
    x = t(conf).requires_grad_()
    got = fine_loss(x, t(label), t(valid), pc)
    got.backward()
    assert_close(got, ref, 1e-5, 1e-6)
    assert_close(x.grad, gref, 1e-5, 1e-6)


def test_batchnorm_train_mode_matches_flax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 5, 6, 3)) * 2 + 1).astype(np.float32)  # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.key(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(rng.normal(size=3).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=3).astype(np.float32))}
    stats = {"mean": jnp.asarray([0.5, -1.0, 2.0], jnp.float32),
             "var": jnp.asarray([2.0, 1.0, 0.5], jnp.float32)}
    dy = rng.normal(size=x.shape).astype(np.float32)

    def apply(p, xx):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return (y * dy).sum(), (y, mut["batch_stats"])

    (_, (ref, new_stats)), grads = jax.value_and_grad(
        apply, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    del variables
    port = BatchNorm(3)
    with torch.no_grad():
        port.weight.copy_(t(params["scale"]))
        port.bias.copy_(t(params["bias"]))
        port.running_mean.copy_(t(stats["mean"]))
        port.running_var.copy_(t(stats["var"]))
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    y = port(xt, train=True)
    (y * t(dy).permute(0, 3, 1, 2)).sum().backward()
    assert_close(y.permute(0, 2, 3, 1), ref, 1e-4, 1e-5, "out")
    assert_close(port.running_mean, new_stats["mean"], 1e-5, 1e-6, "mean")
    assert_close(port.running_var, new_stats["var"], 1e-5, 1e-6, "var")
    assert_close(xt.grad.permute(0, 2, 3, 1), grads[1], 1e-4, 1e-5, "dx")
    assert_close(port.weight.grad, grads[0]["scale"], 1e-4, 1e-5, "dscale")
    assert_close(port.bias.grad, grads[0]["bias"], 1e-4, 1e-5, "dbias")
    # bf16 activations: statistics in f32, output in bf16
    yb = port(xt.detach().bfloat16(), train=True)
    assert yb.dtype == torch.bfloat16


def test_backbone_train_mode_matches_flax():
    """The backbone's BatchNorms on batch statistics over all the images
    given, and its updated batch_stats, against the flax ResNetFPN."""
    rng = np.random.default_rng(5)
    x = rng.random((4, 32, 40, 1)).astype(np.float32)
    jm = JResNetFPN(16, (16, 24, 32))
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    (rc, rf), mut = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    port = ResNetFPN(16, (16, 24, 32))
    flat = {k.replace("params/", "params/backbone/", 1)
            .replace("batch_stats/", "batch_stats/backbone/", 1): v
            for k, v in flatten(variables).items()}
    holder = torch.nn.Module()
    holder.backbone = port
    load_jax_params(holder, flat)
    coarse, fine = port(t(x), train=True)
    assert_close(coarse, rc, 1e-4, 1e-4, "coarse")
    assert_close(fine, rf, 1e-4, 1e-4, "fine")
    new = flatten({"batch_stats": mut["batch_stats"]})
    sd = port.state_dict()
    for key, ref in new.items():
        _, *path, leaf = key.split("/")
        stat = {"mean": "running_mean", "var": "running_var"}[leaf]
        assert_close(sd[".".join(path) + "." + stat], ref, 1e-4, 1e-5, key)


SCHEDULES = [
    dict(),
    dict(scheduler="cosine", cosa_tmax=3),
    dict(scheduler="exponential", elr_gamma=0.99),
    dict(warmup_actual=7, warmup_ratio=0.1),
    dict(true_lr=2e-3, mslr_milestones=(1, 2)),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: str(sorted(kw)))
@pytest.mark.parametrize("total", [0, 600])
def test_schedule_matches_jax(kw, total):
    j_sched, j_lr, j_warm = j_make_schedule(jcfg.OptimConfig(**kw), 8, 40,
                                            total)
    p_sched, p_lr, p_warm = make_schedule(tcfg.OptimConfig(**kw), 8, 40,
                                          total)
    assert (p_lr, p_warm) == (j_lr, j_warm)
    for step in list(range(0, 30)) + [99, 100, 101, 250, 599, 1234]:
        assert p_sched(step) == j_sched(step), step


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_optimizer_with_clip_matches_optax(optimizer):
    """Unit-LR optax chain with updates scaled by the step's LR (the JAX
    train step) against the port's AdamW / Adam with optax's clip, over
    steps whose gradient norms fall on both sides of the clip."""
    ocfg = dict(optimizer=optimizer, gradient_clipping=0.5)
    opt = j_make_optimizer(jcfg.OptimConfig(**ocfg), 8, 40)
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    tp = [torch.nn.Parameter(t(params["a"])), torch.nn.Parameter(
        t(params["b"]))]
    topt = make_optimizer(tcfg.OptimConfig(**ocfg), tp)
    for step, (scale, lr) in enumerate([(0.01, 1e-3), (5.0, 2e-3),
                                        (0.1, 0.0), (3.0, 5e-4)]):
        grads = {"a": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
                 "b": (rng.normal(size=(5,)) * scale).astype(np.float32)}
        upd, state = opt.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr, upd))
        tp[0].grad, tp[1].grad = t(grads["a"]), t(grads["b"])
        norm = global_norm([p.grad for p in tp])
        assert_close(norm, optax.global_norm(grads), 1e-6, 1e-7)
        clip_by_global_norm_([p.grad for p in tp], 0.5, norm)
        for group in topt.param_groups:
            group["lr"] = lr
        topt.step()
        assert_close(tp[0], jp["a"], 1e-5, 1e-6, f"a step {step}")
        assert_close(tp[1], jp["b"], 1e-5, 1e-6, f"b step {step}")


def test_config_copies_match_jax():
    for name in ("LossConfig", "OptimConfig", "TrainConfig"):
        j = dataclasses.asdict(getattr(jcfg, name)())
        p = dataclasses.asdict(getattr(tcfg, name)())
        assert j == p, name
