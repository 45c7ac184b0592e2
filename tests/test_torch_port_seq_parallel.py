"""Sequence parallelism of the port on the CPU: one pair's rows split over
two (and four) gloo ranks, against the port in one process and against
the JAX package's sequence-parallel path on a 2-device CPU mesh.

The ranks run in spawned processes (core/mesh.launch, one torch thread
each, file rendezvous under the test's temporary directory): every
world-size-2 case of this file in one group, the world-size-4 cases in a
second (tests/torch_port_ranks.py holds what each rank runs; each result
is gathered over the seq group, so it is the whole tensor). The one-process
references run the same functions in this process with a split of one
rank, which is the replicated path. Sizes: 64x80 (four coarse rows a band
at world size 2) and 128x160 (eight), random weights of the narrow model
(tests/torch_port_util.small_config) unless JAX's are loaded.

Bars:
- the backbone (eval and train mode), the position encoding and the
  coarse transformer: each band within 1e-5 of the same rows in one
  process (5e-5 absolute in train mode, where each BatchNorm's sums add
  up band by band: see the test); in train mode the running statistics
  and the parameters' gradients (summed over the ranks) within 1e-5
  relative, every rank's statistics alike;
- the streamed extraction: ids bit-equal to one process and to JAX's
  streaming_match_extract under shard_map on a 2-device mesh, including
  a planted exact tie across the band edge (integer-valued features, so
  every product is exact) that the first-wins rule resolves to the lower
  global row; row_best within 2e-5 relative (JAX's own SP bar);
- the whole forward on the gather path (``use_pallas`` off), at world
  size 2 against the JAX forward with seq_axis under a 2-device mesh,
  same weights and RANSAC uniforms, at the JAX test's bars (features rtol
  2e-3 / atol 2e-4, has_H equal, match overlap at least 0.9, common
  mkpts1 within 1e-2) but H's, which is the port's cross-package bar
  (1e-3 / 1e-3: the port's replicated forward is 4.8e-4 from JAX's H
  here, and its SP forward's H equals its replicated one);
- the whole forward on the K1/K2 path (their plain versions here) at
  world size 2 (and 2 x 2 data x seq at world size 4) against one
  process: features within 1e-5, H equal, match sets equal; the train
  step on the 2 x 2 split at the data-parallel tests' bars
  (tests/test_torch_port_seq_train.py); the int8 paths and the dense
  matchers refuse a seq split;
- BatchedMatcher data-parallel and sequence-parallel against one process
  (the JAX eval test's 1e-4), ``cli infer --seq-shard 2 --device cpu``
  against ``--seq-shard 0`` (same count, keypoints within 1e-4, the same
  figure), and the refusal of ``--seq-shard 2`` on a one-card machine;
- the collectives' gradients against autograd of the same losses in one
  process (1e-6).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.ops.fused_loss import (  # noqa: E402
    streaming_match_extract as j_extract,
)
from geoformer_tpu_torch import cli  # noqa: E402
from geoformer_tpu_torch.core import mesh  # noqa: E402
from torch_port_ranks import (  # noqa: E402
    extract_inputs,
    jobs,
    sp_backbone,
    sp_collectives,
    sp_extract,
    sp_forward,
    sp_matcher,
    sp_refusals,
    sp_transformer,
)
from torch_port_util import (  # noqa: E402
    flatten,
    one_torch_thread,  # noqa: F401
    port_config,
    small_config,
    smooth_images,
)

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "tpu_r3_main" \
    / "params_final.npz"
SMALL, LARGE = (64, 80), (128, 160)
ITERS, CAP = 32, 64        # small_config's RANSAC hypotheses and matches
RANSAC_KEY = jax.random.key(5)


def _cfg(pallas=False, **over):
    cfg = small_config(**over)
    return port_config(cfg).replace(geo=dataclasses.replace(
        port_config(cfg).geo, use_pallas=pallas))


def _pair_batch(hw, b=1, seed=3, masked=False):
    img0, img1 = smooth_images(np.random.default_rng(seed), b, *hw)
    batch = {"image0": img0, "image1": img1}
    if masked:
        m = np.ones((b, hw[0] // 8, hw[1] // 8), np.float32)
        m1 = m.copy()
        m1[:, :, -1] = 0.0           # a padded column
        batch.update(mask0=m, mask1=m1)
    return batch


def _noise(b, seed=5):
    return np.random.default_rng(seed).random((b, ITERS, CAP)).astype(
        np.float32)


def _backbone_inputs(hw, seed=0):
    rng = np.random.default_rng(seed)
    imgs = np.concatenate(list(_pair_batch(hw, 1, seed).values()))
    h, w = hw
    grads = (rng.normal(size=(2, h // 8, w // 8, 32)).astype(np.float32),
             rng.normal(size=(2, h // 2, w // 2, 16)).astype(np.float32))
    return imgs, grads


def _jax_inputs(hw):
    """JAX-initialized weights of the narrow model, a pair and the RANSAC
    uniforms of the JAX forward's key (its gumbel draw's)."""
    cfg = small_config()
    key = jax.random.key(0)
    batch = _pair_batch(hw, 2, 0)       # tests/test_torch_port_geoformer's
    model = JGeoFormer(cfg)
    variables = jax.jit(model.init)(
        {"params": key, "ransac": key}, jnp.asarray(batch["image0"][:1]),
        jnp.asarray(batch["image0"][:1]))
    rkey = model.apply(variables, method=lambda m: m.make_rng("ransac"),
                       rngs={"ransac": RANSAC_KEY})
    noise = np.stack([np.asarray(jax.random.uniform(
        k, (ITERS, CAP), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))
        for k in jax.random.split(rkey, 2)])
    return cfg, variables, batch, noise


@pytest.fixture(scope="module")
def jax_sp():
    """The JAX forward with seq_axis on a 2-device mesh, and its inputs."""
    cfg, variables, batch, noise = _jax_inputs(SMALL)
    model = JGeoFormer(cfg.replace(seq_axis="seq"))
    with jax.sharding.set_mesh(Mesh(np.array(jax.devices()[:2]), ("seq",))):
        out = jax.jit(lambda v, a, b: model.apply(
            v, a, b, return_feats=True, rngs={"ransac": RANSAC_KEY}))(
                variables, jnp.asarray(batch["image0"]),
                jnp.asarray(batch["image1"]))
    return dict(cfg=cfg, flat=flatten(variables), batch=batch, noise=noise,
                out=jax.tree.map(np.asarray, out))


def _todo(jax_sp):
    big = _pair_batch(LARGE, 1, 4, masked=True)
    imgs = [np.random.default_rng(10 + i).random((96, 128)).astype(
        np.float32) for i in range(4)]
    same = np.random.default_rng(4).random((96, 128)).astype(np.float32)
    fine0 = _cfg(fine_match=dataclasses.replace(small_config().fine_match,
                                                thr=0.0))
    x = np.random.default_rng(2).normal(size=(8, 3)).astype(np.float32)
    wts = [np.random.default_rng(20 + i).normal(size=s).astype(np.float32)
           for i, s in enumerate(((2, 8, 3), (2, 7, 3), (2, 4, 3)))]
    return {
        "backbone_eval": (sp_backbone, (_cfg(), _backbone_inputs(LARGE)[0],
                                        False, _backbone_inputs(LARGE)[1])),
        "backbone_train": (sp_backbone, (_cfg(), *_backbone_inputs(SMALL)[:1],
                                         True, _backbone_inputs(SMALL)[1])),
        "transformer": (sp_transformer, _transformer_args()),
        "extract": (sp_extract, (*extract_inputs(), 8, 1e-4, 16)),
        "forward_jax": (sp_forward, (port_config(jax_sp["cfg"]),
                                     jax_sp["flat"], jax_sp["batch"],
                                     jax_sp["noise"])),
        "forward_box": (sp_forward, (_cfg(True), None, big, _noise(1))),
        "matcher_data": (sp_matcher, ("data", _cfg(), imgs, imgs[::-1], 4)),
        "matcher_seq": (sp_matcher, ("seq", fine0, [same], [same], 1)),
        "collectives": (sp_collectives, (x, wts)),
        "refusals": (sp_refusals, (_cfg(True), _pair_batch(SMALL))),
    }


def _transformer_args():
    rng = np.random.default_rng(6)
    coarse = rng.normal(size=(2, 16, 20, 32)).astype(np.float32)
    masks = np.ones((2, 1, 320), np.float32)
    masks[1, 0, -20:] = 0.0              # image1's last coarse row padded
    return (_cfg(), coarse, masks)


@pytest.fixture(scope="module")
def todo(jax_sp):
    return _todo(jax_sp)


@pytest.fixture(scope="module")
def ranks(todo, tmp_path_factory):
    """Every world-size-2 job of this file in one group: by job, the list
    of the two ranks' results."""
    names = list(todo)
    res = mesh.launch(jobs, 2, ([(todo[k][0].__name__, (2,) + todo[k][1])
                                 for k in names],),
                      init_dir=str(tmp_path_factory.mktemp("sp2")),
                      timeout=600)
    return {k: [r[i] for r in res] for i, k in enumerate(names)}


@pytest.fixture(scope="module")
def ranks4(todo, tmp_path_factory):
    """The world-size-4 jobs: the backbone in four bands, and the forward
    and the train step on a 2 x 2 (data x seq) split of two pairs."""
    big = _pair_batch(LARGE, 2, 8, masked=True)
    names = ["backbone_eval", "backbone_train", "forward_2d", "train_2d"]
    res = mesh.launch(jobs, 4, ([
        ("sp_backbone", (4,) + todo["backbone_eval"][1]),
        ("sp_backbone", (4,) + todo["backbone_train"][1]),
        ("sp_forward_2d", (2, _cfg(True), big, _noise(2))),
        ("sp_step", (2,) + _train_2d_args())],),
        init_dir=str(tmp_path_factory.mktemp("sp4")), timeout=600)
    return dict({k: [r[i] for r in res] for i, k in enumerate(names)},
                batch=big)


def _train_2d_args():
    """The train step on two pairs of the narrow model's random weights
    (K1/K2 path, force-one rule), RANSAC from a seeded generator."""
    b = _pair_batch(SMALL, 2, 1, masked=True)
    shift = np.array([[1, 0, 8], [0, 1, 0], [0, 0, 1]], np.float32)
    b["H_0to1"] = np.broadcast_to(shift, (2, 3, 3)).copy()
    b["H_1to0"] = np.broadcast_to(np.linalg.inv(shift), (2, 3, 3)).astype(
        np.float32)
    return ("train", _cfg(True), None, b, 1e-3, None, 11)


def _one(todo, name):
    fn, args = todo[name]
    return fn(0, 1, *args)


def _close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _same_ranks(results):
    first = results[0]
    for other in results[1:]:
        np.testing.assert_equal(other, first)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_backbone_bands_equal_the_whole_backbone(todo, ranks, ranks4, world,
                                                 mode):
    res = (ranks if world == 2 else ranks4)[f"backbone_{mode}"]
    ref = _one(todo, f"backbone_{mode}")
    _same_ranks([r["stats"] for r in res])
    got = res[0]
    # train mode: each BatchNorm sums its statistics band by band; in one
    # process, summing the two halves' rows apart moves the coarse map by
    # 1.1e-5 (|x| up to 6), the f32 noise floor of 20 train-mode layers
    atol = 5e-5 if mode == "train" else 1e-5
    for k in ("coarse", "fine"):
        _close(got[k], ref[k], 1e-5, atol, k)
    for k, v in ref["stats"].items():
        _close(got["stats"][k], v, 1e-5, 1e-6, k)
    # the gradients by relative L2: 1e-5 in eval mode; in train mode the
    # bar of tests/test_torch_port_train_step.py (1e-2): the backward of
    # 20 train-mode BatchNorms amplifies the summation-order noise above
    for k, v in ref["grads"].items():
        rel = np.linalg.norm(got["grads"][k] - v) / np.linalg.norm(v)
        assert rel < (1e-2 if mode == "train" else 1e-5), (k, rel)
    if mode == "train":
        assert len(ref["grads"]) > 20
        assert not np.allclose(ref["stats"]["bn1.running_mean"], 0.0)


def test_position_encoding_and_coarse_transformer_bands(todo, ranks):
    ref = _one(todo, "transformer")
    for got in ranks["transformer"]:
        for a, b in zip(got, ref):
            _close(a, b, 1e-5, 1e-5)


def _jax_extract(f0, f1, m0, m1, chunk):
    with jax.sharding.set_mesh(Mesh(np.array(jax.devices()[:2]), ("seq",))):
        fn = jax.jit(jax.shard_map(
            lambda a, b, x, y: j_extract(a, b, 0.1, x > 0, y > 0, chunk,
                                         axis_name="seq"),
            in_specs=(P(None, "seq", None), P(None, "seq", None),
                      P(None, "seq"), P(None, "seq")),
            out_specs=(P(None, "seq"), P(None, "seq"), P(), P())))
        return [np.asarray(x) for x in fn(f0, f1, m0, m1)]


def test_extraction_merges_are_exact_with_a_tie_across_the_band_edge(
        todo, ranks):
    f0, f1, m0, m1 = extract_inputs()
    ref = _one(todo, "extract")
    jrb, jj, jca, jc00 = _jax_extract(f0, f1, m0, m1, 8)
    rows, cols = m0 > 0, m1 > 0
    for got in ranks["extract"]:
        for k in ("j_ids", "col_arg"):
            np.testing.assert_array_equal(got[k], ref[k], k)
        assert (got["j_ids"] == jj)[rows].all()
        assert (got["col_arg"] == jca)[cols].all()
        _close(got["row_best"], ref["row_best"], 2e-5, 1e-8)
        _close(got["row_best"], jrb, 2e-5, 1e-8)
        _close(got["conf00"], ref["conf00"], 2e-5, 1e-10)
        _close(got["conf00"], jc00, 2e-5, 1e-10)
        for k in ("i_ids", "j_ids", "valid"):
            np.testing.assert_array_equal(got["ids"][k], ref["ids"][k], k)
        _close(got["ids"]["mconf"], ref["ids"]["mconf"], 2e-5, 1e-8)
        # the planted tie: rows 3 and 20 reach column 9's max alike; the
        # lower global row wins, so row 3 is mutual and row 20 is not
        assert (got["j_ids"][:, [3, 20]] == 9).all()
        assert (got["col_arg"][:, 9] == 3).all()
        i, v = got["ids"]["i_ids"], got["ids"]["valid"]
        assert all(3 in i[b][v[b]] and 20 not in i[b][v[b]]
                   for b in range(2))


def _pairs(m, b=0):
    v = m["valid"][b]
    return set(zip(m["i_ids"][b][v].tolist(), m["j_ids"][b][v].tolist()))


def test_forward_gather_path_meets_the_jax_sp_forward(jax_sp, ranks):
    ref = jax_sp["out"]
    for got in ranks["forward_jax"]:
        for a, b, name in zip(got["feats"], ref.feats,
                              ("f0", "f1", "g0", "g1")):
            _close(a, b, 2e-3, 2e-4, name)
        # H: the cross-package bar of tests/test_torch_port_geoformer.py;
        # the port's replicated forward is as far from JAX's here (its H
        # is the SP forward's bit for bit, test below)
        _close(got["geo"]["H"], ref.geo.H, 1e-3, 1e-3)
        np.testing.assert_array_equal(got["geo"]["has_H"], ref.geo.has_H)
        assert ref.geo.has_H.all()
        for b in range(2):
            pr = _pairs({k: getattr(ref.matches, k) for k in
                         ("valid", "i_ids", "j_ids")}, b)
            ps = _pairs(got["matches"], b)
            assert len(pr) > 8
            assert len(pr & ps) / len(pr | ps) >= 0.9, (len(pr), len(ps))
            sel = (ref.fine.valid[b] & got["fine"]["valid"][b]
                   & (ref.matches.i_ids[b] == got["matches"]["i_ids"][b]))
            assert sel.any()
            _close(got["fine"]["mkpts1"][b][sel], ref.fine.mkpts1[b][sel],
                   0, 1e-2)


def test_forward_gather_path_at_world_size_2_equals_one_process(todo,
                                                                ranks):
    ref = _one(todo, "forward_jax")
    for got in ranks["forward_jax"]:
        _forward_equal(got, ref)


def _forward_equal(got, ref, b=slice(None)):
    for a, r in zip(got["feats"], ref["feats"]):
        _close(a, r[b], 1e-5, 1e-5)
    np.testing.assert_array_equal(got["geo"]["H"], ref["geo"]["H"][b])
    for part in ("matches1", "matches", "fine"):
        for k in ("i_ids", "j_ids", "valid"):
            if k in got[part]:
                np.testing.assert_array_equal(got[part][k], ref[part][k][b],
                                              f"{part}.{k}")
    _close(got["fine"]["mkpts1"], ref["fine"]["mkpts1"][b], 0, 1e-4)


def test_forward_k1_k2_path_at_world_size_2_equals_one_process(todo,
                                                               ranks):
    ref = _one(todo, "forward_box")
    assert ref["geo"]["has_H"].all() and ref["matches"]["valid"].sum() > 8
    for got in ranks["forward_box"]:
        _forward_equal(got, ref)


def test_int8_and_dense_paths_refuse_a_seq_split(ranks):
    """The int8 paths' per-tensor scales would read every band, and the
    dense matchers have no [L, L] matrix to split: both raise."""
    for got in ranks["refusals"]:
        assert got == ["int8", "dense", "sinkhorn"]


def test_forward_on_a_2x2_data_by_seq_split(ranks4):
    batch = ranks4["batch"]
    ref = sp_forward(0, 1, _cfg(True), None, batch, _noise(2))
    for r, got in enumerate(ranks4["forward_2d"]):
        _forward_equal(got, ref, slice(r // 2, r // 2 + 1))


def test_train_step_on_a_2x2_data_by_seq_split(ranks4):
    """Item 13's layout: each data rank's pair split over its seq group;
    the update at the data-parallel tests' bars against one process."""
    from test_torch_port_seq_train import _updates_close

    from torch_port_ranks import _state, sp_step

    args = _train_2d_args()
    one = sp_step(0, 1, *args)
    before = {k: v.numpy() for k, v in
              _state(args[1], None, SMALL, 2)[1].model.state_dict().items()}
    res = ranks4["train_2d"]
    for other in res[1:]:
        for k, v in res[0]["state"].items():
            np.testing.assert_array_equal(other["state"][k], v, k)
    got = res[0]
    for k in ("loss", "loss_c", "loss_d", "loss_f", "grad_norm"):
        np.testing.assert_allclose(got["scalars"][k], one["scalars"][k],
                                   rtol=1e-5, err_msg=k)
    assert got["scalars"]["num_matches"] == one["scalars"]["num_matches"]
    _updates_close(got["state"], one["state"], before, 1e-3)


def _matches_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for a, b in zip(g[:3], r[:3]):
            _close(a, b, 0, 1e-4)
        assert g[3]["has_H"] == r[3]["has_H"]


def test_batched_matcher_data_parallel_and_seq(todo, ranks):
    for mode in ("data", "seq"):
        fn, args = todo[f"matcher_{mode}"]
        ref = fn(0, 1, "one", *args[1:])
        assert sum(len(r[0]) for r in ref) > 0
        for got in ranks[f"matcher_{mode}"]:
            _matches_close(got, ref)


def test_matcher_options_are_exclusive():
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher
    from torch_port_ranks import _model

    model = _model(_cfg(), None, seq_axis=None)
    with mesh.seq_groups(1) as layout:
        with pytest.raises(ValueError, match="mutually exclusive"):
            BatchedMatcher(_cfg(), model, 1, "cpu", seq_group=layout,
                           data_parallel=True)
    with pytest.raises(ValueError, match="not the seq split"):
        BatchedMatcher(_cfg(), model, 1, "cpu", seq_group=layout)


def test_collective_gradients_equal_one_process_autograd(todo, ranks):
    x, wts = todo["collectives"][1]
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = 0.0
    for r in range(2):          # each rank's loss, from the whole tensor
        band = xt[4 * r:4 * r + 4]
        pad = torch.cat([xt[4 * r - 1:4 * r] if r else torch.zeros(1, 3),
                         band, xt[4:6] if r == 0 else torch.zeros(2, 3)])
        loss = loss + (xt * torch.from_numpy(wts[0][r])).sum() \
            + (pad * torch.from_numpy(wts[1][r])).sum() \
            + ((xt[:4] + xt[4:]) * torch.from_numpy(wts[2][r])).sum()
    loss.backward()
    for got in ranks["collectives"]:
        _close(got, xt.grad.numpy(), 1e-6, 1e-6)


def _write_png(path, img):
    from geoformer_tpu_torch.utils.plotting import write_png

    write_png(str(path), img)


def test_cli_infer_seq_shard_2_equals_seq_shard_0(tmp_path, capfd):
    img = (smooth_images(np.random.default_rng(9), 1, 128, 160)[0][0, ..., 0]
           * 255).astype(np.uint8)
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    _write_png(a, img)
    _write_png(b, np.roll(img, 8, axis=1))
    outs = {}
    for n in (0, 2):
        cli.main(["infer", str(a), str(b), "--imsize", "128",
                  "--ckpt", str(CKPT),
                  "--device", "cpu", "--seq-shard", str(n),
                  "--out", str(tmp_path / f"m{n}.npy"),
                  "--draw", str(tmp_path / f"d{n}.png")])
        outs[n] = capfd.readouterr().out
    m0, m2 = np.load(tmp_path / "m0.npy"), np.load(tmp_path / "m2.npy")
    assert len(m0) > 50 and m0.shape == m2.shape
    _close(m2, m0, 0, 1e-4)
    assert outs[0].split(" in ")[0] == outs[2].split(" in ")[0]
    assert outs[2].count("matches in") == 1        # the first rank alone
    assert (tmp_path / "d0.png").read_bytes() == \
        (tmp_path / "d2.png").read_bytes()


def test_cli_seq_shard_refuses_more_ranks_than_cards(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    img = np.zeros((64, 64), np.uint8)
    _write_png(tmp_path / "a.png", img)
    with pytest.raises(ValueError, match="--seq-shard 2 > 1 devices"):
        cli.main(["infer", str(tmp_path / "a.png"), str(tmp_path / "a.png"),
                  "--seq-shard", "2"])


def test_seq_split_rejects_bands_that_do_not_divide():
    from geoformer_tpu_torch.core import spmd

    with pytest.raises(ValueError, match="does not divide"):
        with mesh.seq_groups(3):
            pass
    with mesh.seq_groups(1):
        assert spmd.row_band(7) == slice(0, 7) and not spmd.active()
