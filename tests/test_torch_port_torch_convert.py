"""Released torch checkpoints in and out of the port
(geoformer_tpu_torch/utils/torch_convert.py) against the JAX converter.

The trained checkpoint checkpoints/tpu_r3_main/params_final.npz is the
weights throughout. Tolerances: every conversion exact (the same keys, the
same float32 values); a forward from a Lightning-style ``.ckpt`` written
here equal bit for bit to the forward from the npz; against the JAX
forward on the same pair, with the GAM's RANSAC draws injected, the
parity bar of __graft_entry__.py:191-205 (match sets overlapping >= 0.9,
keypoints of the common matches within 0.05 px).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from geoformer_tpu.config import GeoFormerConfig as JConfig  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu.utils import torch_convert as jtc  # noqa: E402
from geoformer_tpu_torch import cli, weights  # noqa: E402
from geoformer_tpu_torch.config import GeoFormerConfig  # noqa: E402
from geoformer_tpu_torch.eval.parity_drill import (  # noqa: E402
    fabricate_checkpoint,
)
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.utils import torch_convert as tc  # noqa: E402
from torch_port_util import (  # noqa: E402
    jax_forward_and_draws,
    match_bar,
    smooth_images,
)

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
HW = (120, 160)


@pytest.fixture(scope="module")
def trained():
    """(JAX variables, the port model with the npz's weights)."""
    if not CKPT.is_file():
        pytest.skip("trained checkpoint not in this checkout")
    model = weights.load_jax_params(GeoFormer(GeoFormerConfig()),
                                    weights.load_npz(str(CKPT)))
    return load_variables(str(CKPT)), model.eval()


def _save_ckpt(path, sd, lightning=True):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save({"state_dict": sd, "epoch": 0} if lightning else sd, path)


def test_to_torch_state_dict_equals_the_jax_one(trained):
    variables, model = trained
    ref = jtc.to_torch_state_dict(variables)
    got = tc.to_torch_state_dict(model)
    assert set(got) == set(ref) and len(got) == 234
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("prefix", ["matcher.", ""])
def test_convert_state_dict_is_the_identity_after_its_inverse(trained,
                                                              prefix):
    _, model = trained
    sd = model.state_dict()
    back = tc.convert_state_dict(tc.to_torch_state_dict(model, prefix))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_the_jax_export_loads_into_the_port_model(trained):
    """Reference names written by the JAX converter land on the port's
    modules with the values the npz gives them (the JAX route's transposes
    and the port loader's cancel)."""
    variables, model = trained
    sd = tc.convert_state_dict(jtc.to_torch_state_dict(variables))
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)


def test_unused_keys_are_left_out_and_missing_ones_raise(trained):
    _, model = trained
    ref = tc.to_torch_state_dict(model)
    extra = dict(ref)
    extra["matcher.backbone.bn1.num_batches_tracked"] = np.array(7)
    extra["loss.weight"] = np.zeros(3, np.float32)
    assert set(tc.convert_state_dict(extra)) == set(model.state_dict())
    missing = dict(ref)
    missing.pop("matcher.loftr_fine.layers.1.merge.weight")
    with pytest.raises(KeyError, match="loftr_fine.layers.1.merge.weight"):
        tc.convert_state_dict(missing)


def test_the_16_4_ladder_raises_with_its_item(trained):
    """A layer4 key selects the (16, 4) ladder; an (8, 2) state dict with
    one stray layer4 weight then raises, naming the first missing item of
    that ladder."""
    _, model = trained
    sd = tc.to_torch_state_dict(model)
    sd["matcher.backbone.layer4.0.conv1.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError, match="backbone.layer4.0.conv2.weight"):
        tc.convert_state_dict(sd)


@pytest.mark.parametrize("suffix,lightning", [(".ckpt", True),
                                              (".pth", False),
                                              (".pt", True)])
def test_load_torch_checkpoint_reads_what_the_jax_loader_reads(
        trained, tmp_path, suffix, lightning):
    variables, _ = trained
    path = tmp_path / f"geoformer{suffix}"
    sd = jtc.to_torch_state_dict(variables)
    _save_ckpt(path, sd, lightning)
    got = tc.load_torch_checkpoint(str(path))
    ref = jtc.load_torch_checkpoint(str(path))
    assert set(got) == set(ref) == set(sd)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def pair():
    img0, img1 = smooth_images(np.random.default_rng(7), 1, *HW, shift=8)
    return img0, img1


@pytest.fixture(scope="module")
def jax_run(trained, pair):
    variables, _ = trained
    return jax_forward_and_draws(JConfig(), variables, *pair,
                                 jax.random.key(3))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_ckpt_forward_is_bit_equal_to_the_npz_forward_and_meets_jax(
        trained, pair, jax_run, tmp_path, writer):
    variables, from_npz = trained
    path = tmp_path / "geoformer.ckpt"
    if writer == "jax":
        _save_ckpt(path, jtc.to_torch_state_dict(variables))
    else:
        assert fabricate_checkpoint(str(CKPT), str(path)) == 234
    from_ckpt = tc.load_torch_weights(GeoFormer(GeoFormerConfig()),
                                      str(path)).eval()
    ref, sample_idx = jax_run
    idx = torch.from_numpy(np.array(sample_idx)).long()
    x = [torch.from_numpy(a) for a in pair]
    with torch.no_grad():
        a = from_npz(*x, sample_idx=idx)
        b = from_ckpt(*x, sample_idx=idx)
    for name in ("mkpts0", "mkpts1", "mconf", "valid"):
        assert torch.equal(getattr(a.fine, name), getattr(b.fine, name))
    assert torch.equal(a.geo.H, b.geo.H)
    v = b.fine.valid[0].numpy()
    rv = np.asarray(ref.fine.valid[0])
    assert v.sum() > 50 and rv.sum() > 50

    def ids_kp(o, m):
        ids = np.stack([np.asarray(o.matches.i_ids[0])[m],
                        np.asarray(o.matches.j_ids[0])[m]], 1)
        return ids, np.concatenate([np.asarray(o.fine.mkpts0[0])[m],
                                    np.asarray(o.fine.mkpts1[0])[m]], 1)

    overlap, kp_px = match_bar(*ids_kp(ref, rv), *ids_kp(b, v))
    assert overlap >= 0.9 and kp_px <= 0.05, (overlap, kp_px)


def test_cli_model_loads_a_torch_checkpoint(trained, tmp_path):
    variables, from_npz = trained
    path = tmp_path / "geoformer.ckpt"
    _save_ckpt(path, jtc.to_torch_state_dict(variables))
    args = cli.build_parser().parse_args(
        ["infer", "a.png", "b.png", "--ckpt", str(path), "--device", "cpu"])
    cfg, model = cli._model(args)
    own = from_npz.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in model.state_dict().items())
    assert cfg.match.thr == 0.2 and cfg.match.max_matches == 1024
