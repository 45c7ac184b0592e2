"""Port backbone pieces against JAX: resize, position encoding, ResNet-FPN.

Tolerances: the resize at 1e-4 abs (both sides compute the interpolation
weights in f32, by different formulas); the position table at 1e-6 abs (a
float64 table cast to f32); the backbone at 1e-4 rel / 1e-4 abs (f32
convolutions summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.models.backbone import ResNetFPN as JResNetFPN  # noqa: E402
from geoformer_tpu.models.position import (  # noqa: E402
    add_position_encoding as j_pe,
)
from geoformer_tpu.ops.resize import resize_bilinear_align_corners as j_rs  # noqa: E402
from geoformer_tpu_torch.config import BackboneConfig  # noqa: E402
from geoformer_tpu_torch.models.backbone import (  # noqa: E402
    ResNetFPN,
    build_backbone,
)
from geoformer_tpu_torch.models.position import add_position_encoding  # noqa: E402
from geoformer_tpu_torch.ops.resize import (  # noqa: E402
    resize_bilinear_align_corners,
)
from geoformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import assert_close, flatten, n, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("in_hw,out_hw", [((8, 10), (16, 20)),
                                          ((15, 20), (30, 40)),
                                          ((1, 5), (3, 9)),
                                          ((60, 80), (120, 160))])
def test_resize_align_corners_matches_jax(in_hw, out_hw):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *in_hw, 3)).astype(np.float32)
    assert_close(resize_bilinear_align_corners(t(x), out_hw),
                 j_rs(jnp.asarray(x), out_hw), 0, 1e-4)


@pytest.mark.parametrize("temp_bug_fix", [False, True])
@pytest.mark.parametrize("c,h,w", [(256, 60, 80), (32, 8, 10)])
def test_position_encoding_matches_jax(temp_bug_fix, c, h, w):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, h, w, c)).astype(np.float32)
    assert_close(add_position_encoding(t(x), temp_bug_fix),
                 j_pe(jnp.asarray(x), temp_bug_fix), 0, 1e-6)


def test_released_frequency_schedule_is_kept():
    """temp_bug_fix=False: div_term = exp(-2i) at d=256 (floor division)."""
    z = torch.zeros((1, 1, 1, 256))
    pe = add_position_encoding(z)[0, 0, 0]
    i = np.arange(0, 128, 2)
    np.testing.assert_allclose(pe[0::4].numpy(), np.sin(np.exp(-i)),
                               atol=1e-6)


def _random_stats(variables, rng):
    """Non-trivial BatchNorm statistics and scales, so eval BN is tested."""
    flat = flatten(variables)
    for k, v in flat.items():
        if k.endswith("/mean") or k.endswith("/bias"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    return flat


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        cur = out
        *path, leaf = k.split("/")
        for p in path:
            cur = cur.setdefault(p, {})
        cur[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("hw", [(32, 48), (64, 80)])
def test_resnet_fpn_matches_jax(hw):
    rng = np.random.default_rng(2)
    x = rng.random((2, *hw, 1)).astype(np.float32)
    jm = JResNetFPN(16, (16, 24, 32))
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x[:1]))
    flat = _random_stats(variables, rng)
    coarse_ref, fine_ref = jm.apply(_unflatten(flat), jnp.asarray(x))
    tm = load_jax_params(ResNetFPN(16, (16, 24, 32)), flat)
    coarse, fine = tm(t(x))
    assert coarse.shape == (2, hw[0] // 8, hw[1] // 8, 32)
    assert fine.shape == (2, hw[0] // 2, hw[1] // 2, 16)
    assert_close(coarse, coarse_ref, 1e-4, 1e-4)
    assert_close(fine, fine_ref, 1e-4, 1e-4)


def test_resnet_fpn_bf16_matches_jax():
    """bf16 compute dtype, f32 parameters and statistics, as in JAX; the
    outputs stay bf16. bf16 keeps 8 significant bits (2^-8 relative per
    rounding) and the two frameworks round in different places through
    thirteen convolutions, so the bar is on the whole tensor: relative L2
    error below 1e-2, and no element off by more than 5e-2."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 64, 80, 1)).astype(np.float32)
    jm = JResNetFPN(16, (16, 24, 32), dtype=jnp.bfloat16)
    variables = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x[:1]))
    flat = _random_stats(variables, rng)
    refs = jm.apply(_unflatten(flat), jnp.asarray(x))
    tm = load_jax_params(ResNetFPN(16, (16, 24, 32), dtype=torch.bfloat16),
                         flat)
    for got, ref in zip(tm(t(x)), refs):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        g, r = n(got), np.asarray(ref, np.float32)
        assert np.linalg.norm(g - r) / np.linalg.norm(r) < 1e-2
        assert np.abs(g - r).max() < 5e-2


@pytest.mark.parametrize("cfg", [BackboneConfig(int8=True),
                                 BackboneConfig(resolution=(16, 4))])
def test_unported_backbone_options_raise(cfg):
    """What the backbone refuses: training the eval-only int8 ladder, and
    the (16, 4) ladder with three block_dims (it takes four)."""
    with pytest.raises(ValueError):
        build_backbone(cfg)(torch.zeros(1, 32, 32, 1), train=True)
