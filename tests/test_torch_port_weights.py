"""JAX parameters into the port (geoformer_tpu_torch.weights).

The flat '/'-keyed dict is the npz layout of geoformer_tpu's save_params;
conv kernels go HWIO -> OIHW, dense kernels [in, out] -> [out, in]. The
released checkpoint checkpoints/tpu_r3_main/params_final.npz is loaded
into both packages and the backbone and coarse transformer are compared at
full width. Tolerances: conversions exact; full-width f32 outputs at
1e-3 rel / 1e-3 abs (eleven 3x3 convolutions of up to 256 channels and
eight attention layers, summed in another order).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu.models.backbone import ResNetFPN as JResNetFPN  # noqa: E402
from geoformer_tpu.models.position import (  # noqa: E402
    add_position_encoding as j_pe,
)
from geoformer_tpu.models.transformer import (  # noqa: E402
    LocalFeatureTransformer as JLFT,
)
from geoformer_tpu_torch import weights  # noqa: E402
from geoformer_tpu_torch.config import GeoFormerConfig  # noqa: E402
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.models.backbone import ResNetFPN  # noqa: E402
from geoformer_tpu_torch.models.position import add_position_encoding  # noqa: E402
from geoformer_tpu_torch.models.transformer import (  # noqa: E402
    LocalFeatureTransformer,
)
from torch_port_util import (  # noqa: E402
    assert_close,
    flatten,
    port_config,
    small_config,
    smooth_images,
    t,
)
from torch_port_util import one_torch_thread  # noqa: E402,F401

CKPT = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints",
                    "tpu_r3_main", "params_final.npz")


@pytest.fixture(scope="module")
def small_flat():
    cfg = small_config()
    img = jnp.zeros((1, 64, 80, 1))
    key = jax.random.key(0)
    variables = jax.jit(JGeoFormer(cfg).init)(
        {"params": key, "ransac": key}, img, img)
    return cfg, flatten(variables)


def test_every_jax_tensor_lands_in_its_layout(small_flat):
    cfg, flat = small_flat
    model = weights.load_jax_params(GeoFormer(port_config(cfg)), flat)
    sd = model.state_dict()
    w = sd["backbone.layer2_0.conv1.weight"].numpy()
    np.testing.assert_array_equal(
        w, flat["params/backbone/layer2_0/conv1/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["geo_module.layer_1.q_proj.weight"].numpy(),
        flat["params/geo_module/layer_1/q_proj/kernel"].T)
    np.testing.assert_array_equal(
        sd["backbone.l1_bn.running_var"].numpy(),
        flat["batch_stats/backbone/l1_bn/var"])
    np.testing.assert_array_equal(
        sd["loftr_fine.layer_0.norm2.weight"].numpy(),
        flat["params/loftr_fine/layer_0/norm2/scale"])
    np.testing.assert_array_equal(
        sd["fine_preprocess.merge_feat.bias"].numpy(),
        flat["params/fine_preprocess/merge_feat/bias"])
    n_jax = sum(v.size for k, v in flat.items() if k.startswith("params/"))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("change", ["drop", "extra", "shape"])
def test_load_is_strict(small_flat, change):
    cfg, flat = small_flat
    flat = dict(flat)
    if change == "drop":
        flat.pop("params/loftr_coarse/layer_0/k_proj/kernel")
    elif change == "extra":
        flat["params/loftr_coarse/layer_9/k_proj/kernel"] = np.zeros((32, 32))
    else:
        flat["params/backbone/conv1/kernel"] = np.zeros((5, 5, 1, 16))
    with pytest.raises((KeyError, ValueError)):
        weights.load_jax_params(GeoFormer(port_config(cfg)), flat)


def test_random_init_is_seeded_and_finite():
    cfg = port_config(small_config())
    a = weights.random_init(GeoFormer(cfg), seed=3).state_dict()
    b = weights.random_init(GeoFormer(cfg), seed=3).state_dict()
    c = weights.random_init(GeoFormer(cfg), seed=4).state_dict()
    k = "loftr_coarse.layer_0.q_proj.weight"
    assert all(torch.equal(a[x], b[x]) for x in a)
    assert not torch.equal(a[k], c[k])
    assert all(torch.isfinite(v.float()).all() for v in a.values())
    std = a[k].std().item()
    assert 0.5 / np.sqrt(32) < std < 1.5 / np.sqrt(32)   # lecun normal


@pytest.fixture(scope="module")
def released():
    if not os.path.exists(CKPT):
        pytest.skip("released checkpoint not in this checkout")
    from geoformer_tpu.train.checkpoint import load_params

    return load_params(CKPT), weights.load_npz(CKPT)


def test_released_checkpoint_loads_into_default_model(released):
    _, flat = released
    model = weights.load_jax_params(GeoFormer(GeoFormerConfig()), flat)
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for k, v in flat.items() if k.startswith("params/"))


def test_released_checkpoint_backbone_and_coarse_match_jax(released):
    tree, flat = released
    img0, img1 = smooth_images(np.random.default_rng(0), 1, 64, 80)
    x = np.concatenate([img0, img1])
    jv = {"params": tree["params"]["backbone"],
          "batch_stats": tree["batch_stats"]["backbone"]}
    jc, jf = JResNetFPN().apply(jax.tree.map(jnp.asarray, jv),
                                jnp.asarray(x))
    bb = ResNetFPN()
    weights.load_jax_params(bb, {k.replace("/backbone/", "/", 1): v
                                 for k, v in flat.items()
                                 if "/backbone/" in k})
    tc, tf = bb(t(x))
    assert_close(tc, jc, 1e-3, 1e-3, "coarse features")
    assert_close(tf, jf, 1e-3, 1e-3, "fine features")

    cfg = GeoFormerConfig().coarse
    feats = j_pe(jc).reshape(2, 80, -1)
    jl = JLFT(cfg.d_model, cfg.nhead, cfg.layer_names, cfg.attention)
    ref = jl.apply({"params": jax.tree.map(
        jnp.asarray, tree["params"]["loftr_coarse"])}, feats[:1], feats[1:])
    tl = LocalFeatureTransformer(cfg.d_model, cfg.nhead, cfg.layer_names,
                                 cfg.attention)
    weights.load_jax_params(tl, {k.replace("/loftr_coarse/", "/", 1): v
                                 for k, v in flat.items()
                                 if "/loftr_coarse/" in k})
    tfeats = add_position_encoding(tc).reshape(2, 80, -1)
    got = tl(tfeats[:1], tfeats[1:])
    for a, b in zip(got, ref):
        assert_close(a, b, 1e-3, 1e-3, "coarse transformer")
