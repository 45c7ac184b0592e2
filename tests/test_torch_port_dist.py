"""The port's process-group helpers (core/mesh.py, core/dist.py) and its
global BatchNorm, at world size 2 on the CPU.

Two ranks run in spawned processes over gloo (core/mesh.launch, file
rendezvous under the test's temporary directory, one torch thread each):

- all_gather_metrics concatenates each rank's fixed-shape arrays on the
  leading axis as the JAX package's process_allgather + reshape does
  (f32, int64, bool, and a scalar becoming [world]), on every rank alike;
  host_mean is the mean of the ranks' scalars;
- local_shard_slice is the JAX package's per-process arithmetic;
- one train-mode BatchNorm on each rank's half of a batch of 4 (NCHW,
  3 channels), forward and backward with a fixed upstream gradient: its
  output and input gradient equal the one-process layer's on the whole
  batch, its parameter gradients summed over the ranks equal that
  layer's, the running statistics are equal on both ranks and to the
  one-process layer's, and all of them equal flax's BatchNorm on the whole
  batch. Bars: against the one-process layer 1e-5 relative / 1e-6
  absolute (the ranks sum the moments in another order than one mean over
  the batch); against flax 1e-4 / 1e-4, as for the one-process layer
  (E[x^2] - E[x]^2 of channels with mean 2 and std up to 3, 60 terms a
  channel summed in XLA's order, measured 2.4e-5 off on outputs up to 6);
- the dense GeoLoss (both coarse terms, the fine BCE) and the soft-argmax
  fine loss with global counts, on each rank's pair of a batch of 2 whose
  padding masks and match counts differ: the ranks' terms add up to the
  one-process loss on the whole batch and their gradients by the
  confidence are its gradient (1e-5 relative), while the mean of the
  ranks' own means is another number.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu.core import dist as jdist  # noqa: E402
from geoformer_tpu.core import mesh as jmesh  # noqa: E402
from geoformer_tpu_torch.core import dist as pdist  # noqa: E402
from geoformer_tpu_torch.core import mesh  # noqa: E402
from geoformer_tpu_torch.models.layers import BatchNorm  # noqa: E402
from geoformer_tpu_torch.config import LossConfig  # noqa: E402
from geoformer_tpu_torch.train.loss import (  # noqa: E402
    fine_loss_l2_std,
    geo_loss,
)
from torch_port_ranks import jobs  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
FLAX_TOL = 1e-4


def _per_rank():
    rng = np.random.default_rng(0)
    return [dict(f=rng.normal(size=(3, 2)).astype(np.float32),
                 ids=np.arange(3, dtype=np.int64) + r * 10 ** 9,
                 ok=rng.random(3) < 0.5,
                 scalar=np.float32(1.5 + r)) for r in range(2)]


def _bn_inputs():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 3, 5, 6)) * [[[[1.0]], [[3.0]], [[0.2]]]]
         + 2.0).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    w = rng.normal(size=3).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    return x, g, w, b


def _loss_inputs():
    """A batch of 2 for the dense losses: 12 x 10 cells, pair 1 with a
    padded row and column and fewer GT matches, fine windows of 3x3."""
    rng = np.random.default_rng(2)
    b, l0, l1, m = 2, 12, 10, 6
    m0 = np.ones((b, 3, 4), np.float32)
    m1 = np.ones((b, 2, 5), np.float32)
    m0[1, -1] = 0
    m1[1, :, -1] = 0
    conf = rng.uniform(0.01, 0.99, (b, l0, l1)).astype(np.float32)
    dect = rng.uniform(0.01, 0.99, (b, l0, l1)).astype(np.float32)
    gt = np.zeros((b, l0, l1), np.float32)
    for i, n in ((0, 7), (1, 3)):
        gt[i, rng.choice(l0, n, replace=False), rng.integers(0, l1, n)] = 1
    fconf = rng.uniform(0.01, 0.99, (b, m, 3, 3)).astype(np.float32)
    fgt = (rng.random((b, m, 3, 3)) < 0.2).astype(np.float32)
    fvalid = np.array([[1] * 6, [1, 1, 0, 0, 0, 0]], bool)
    ef = np.concatenate([rng.normal(0, 0.5, (b, m, 2)),
                         rng.uniform(0.1, 2, (b, m, 1))], -1).astype(
        np.float32)
    ef_gt = rng.normal(0, 0.5, (b, m, 2)).astype(np.float32)
    return conf, dect, gt, fconf, fgt, fvalid, m0, m1, ef, ef_gt


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    res = mesh.launch(jobs, 2, ([
        ("gather_and_bn", (_per_rank(), _bn_inputs())),
        ("dense_losses", (_loss_inputs(),))],),
        init_dir=str(tmp_path_factory.mktemp("pg")), timeout=180)
    return [r[0] for r in res], [r[1] for r in res]


def test_all_gather_metrics_concatenates_as_jax(ranks):
    per = _per_rank()
    for r in ranks[0]:
        got = r["gathered"]
        assert set(got) == set(per[0])
        for k in per[0]:
            ref = np.stack([p[k] for p in per]).reshape(
                -1, *np.shape(per[0][k])[1:])
            assert got[k].dtype == ref.dtype, k
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
        assert got["scalar"].shape == (2,)
        assert r["host_mean"] == 2.0


def test_one_process_gathers_are_the_identity():
    per = _per_rank()[0]
    assert pdist.all_gather_metrics(per) is per
    assert jdist.all_gather_metrics(per) is per
    assert pdist.host_mean(np.float32(2.5)) == jdist.host_mean(2.5) == 2.5


@pytest.mark.parametrize("total", [2, 4, 7, 8])
def test_local_shard_slice_is_the_jax_arithmetic(monkeypatch, total):
    for world in (1, 2, 3, 4):
        for rank in range(world):
            monkeypatch.setattr(mesh, "world", lambda: world)
            monkeypatch.setattr(mesh, "rank", lambda: rank)
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            assert mesh.local_shard_slice(total) == \
                jmesh.local_shard_slice(total)
    monkeypatch.undo()
    assert mesh.local_shard_slice(total) == slice(0, total)


def _one_process_bn():
    x, g, w, b = (torch.from_numpy(a) for a in _bn_inputs())
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    x = x.clone().requires_grad_(True)
    y = bn(x, train=True)
    (y * g).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(),
                running_var=bn.running_var.numpy())


def _flax_bn():
    x, g, w, b = _bn_inputs()
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    gh = jnp.asarray(g.transpose(0, 2, 3, 1))
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    variables = mod.init(jax.random.key(0), xh)
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}

    def f(p, xx):
        y, upd = mod.apply({"params": p,
                            "batch_stats": variables["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return (y * gh).sum(), (y, upd)

    (_, (y, upd)), (dp, dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, xh)
    return dict(y=np.asarray(y).transpose(0, 3, 1, 2),
                dx=np.asarray(dx).transpose(0, 3, 1, 2),
                dw=np.asarray(dp["scale"]), db=np.asarray(dp["bias"]),
                running_mean=np.asarray(upd["batch_stats"]["mean"]),
                running_var=np.asarray(upd["batch_stats"]["var"]))


def test_batchnorm_over_two_ranks_is_the_global_batchs(ranks):
    ranks = ranks[0]
    one, ref = _one_process_bn(), _flax_bn()
    for name in ("y", "dx"):
        got = np.concatenate([ranks[0][name], ranks[1][name]])
        np.testing.assert_allclose(got, one[name], RTOL, ATOL, err_msg=name)
        np.testing.assert_allclose(got, ref[name], FLAX_TOL, FLAX_TOL,
                                   err_msg=name)
    assert [r["slice"] for r in ranks] == [(0, 2), (2, 4)]
    for name in ("dw", "db"):
        got = ranks[0][name] + ranks[1][name]
        np.testing.assert_allclose(got, one[name], RTOL, ATOL, err_msg=name)
        np.testing.assert_allclose(got, ref[name], FLAX_TOL, FLAX_TOL,
                                   err_msg=name)
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
        np.testing.assert_allclose(ranks[0][name], one[name], RTOL, ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(ranks[0][name], ref[name], FLAX_TOL,
                                   FLAX_TOL, err_msg=name)
    # one rank's half alone gives other statistics: the sum is what matters
    half = BatchNorm(3)
    half(torch.from_numpy(_bn_inputs()[0][:2]), train=True)
    assert not np.allclose(half.running_mean.numpy(), one["running_mean"],
                           RTOL, ATOL)


def test_dense_losses_with_global_counts_sum_to_the_global_batchs(ranks):
    got = ranks[1]
    (conf, dect, gt, fconf, fgt, fvalid, m0, m1, ef,
     ef_gt) = (torch.from_numpy(a) for a in _loss_inputs())
    conf.requires_grad_(True)
    cfg = LossConfig(sparse_spvs=False)
    total, terms = geo_loss(conf, dect, gt, fconf, fgt, fvalid, cfg, m0, m1)
    total.backward()
    one = {k: float(v) for k, v in terms.items()}
    one["l2_std"] = float(fine_loss_l2_std(ef, ef_gt, fvalid))
    for k, v in one.items():
        np.testing.assert_allclose(got[0][k] + got[1][k], v, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        np.concatenate([got[0]["dconf"], got[1]["dconf"]]),
        conf.grad.numpy(), rtol=1e-5, atol=1e-9)
    # the ranks' own means, averaged, are not the global batch's
    own = [float(geo_loss(conf[i:i + 1].detach(), dect[i:i + 1],
                          gt[i:i + 1], fconf[i:i + 1], fgt[i:i + 1],
                          fvalid[i:i + 1], cfg, m0[i:i + 1], m1[i:i + 1]
                          )[0]) for i in range(2)]
    assert abs(np.mean(own) - one["loss"]) > 1e-3 * one["loss"]
