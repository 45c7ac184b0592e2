"""The port's dynamic int8 quantization against the JAX package's.

quantize_symmetric's q and scale, and the int32 accumulations of
int8_dense and int8_conv, equal JAX's bit for bit on seeded numpy inputs
(the products are exact integer sums in both packages). The f32 results
are held equal too (bar: 0 ulp), since both dequantize as
``y.astype(f32) * (sx * sw)`` with the same scales; the layer tests hold
Int8Dense and Int8Conv against the JAX modules with the same bar. The
convolution cases are the backbone's stem (7x7, stride 2, pad 3, Cin 1:
K = 49, not a multiple of 8), a 3x3 with odd channel counts (K = 45,
N = 7) and a 1x1 stride-2 downsample.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.models.backbone import Int8Conv as JInt8Conv  # noqa: E402
from geoformer_tpu.models.transformer import Int8Dense as JInt8Dense  # noqa: E402
from geoformer_tpu.ops import quantize as jq  # noqa: E402
from geoformer_tpu_torch.models.layers import Int8Conv, Int8Dense  # noqa: E402
from geoformer_tpu_torch.ops import quantize as tq  # noqa: E402
from torch_port_util import n, t  # noqa: E402


def _ties():
    """amax 127 gives scale 1.0, so x / scale is x: exact .5 ties."""
    return np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                     [-3.5, 4.5, 0.0, -126.5, 63.5, -63.5, 1e-3, 2.0]],
                    np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "bf16"])
@pytest.mark.parametrize("axis", [None, (0,)])
def test_quantize_symmetric_equals_jax(case, axis):
    rng = np.random.default_rng(0)
    x = {"normal": rng.normal(size=(6, 8)).astype(np.float32) * 3,
         "ties": _ties(), "zeros": np.zeros((6, 8), np.float32),
         "bf16": rng.normal(size=(6, 8)).astype(np.float32)}[case]
    if case == "bf16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), t(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), t(x)
    jqv, js = jq.quantize_symmetric(jx, axis)
    tqv, ts = tq.quantize_symmetric(tx, axis)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(n(tqv), np.asarray(jqv))
    np.testing.assert_array_equal(n(ts), np.asarray(js))
    if case == "ties" and axis is None:
        # round half to even, the clip at 127
        assert n(tqv)[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    if case == "zeros":
        assert not n(tqv).any()


@pytest.mark.parametrize("shape", [(5, 13, 7), (40, 16, 24), (3, 4, 49, 9)])
def test_int8_dense_equals_jax(shape):
    rng = np.random.default_rng(1)
    *lead, cin, cout = shape
    x = rng.normal(size=(*lead, cin)).astype(np.float32)
    w = rng.normal(size=(cin, cout)).astype(np.float32)   # JAX [Cin, Cout]
    jxq, _ = jq.quantize_symmetric(jnp.asarray(x))
    jwq, _ = jq.quantize_symmetric(jnp.asarray(w), axis=(0,))
    jacc = jax.lax.dot_general(jxq, jwq, (((jxq.ndim - 1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    txq, _ = tq.quantize_symmetric(t(x))
    twq, _ = tq.quantize_symmetric(t(w.T.copy()), dims=(1,))
    tacc = tq.int_mm(txq.reshape(-1, cin), twq.t())
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(n(tacc), np.asarray(jacc).reshape(-1, cout))
    np.testing.assert_array_equal(
        n(tq.int8_dense(t(x), t(w.T.copy()))),
        np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w))))


CONVS = {  # name: (N, H, W, Cin, Cout, k, stride)
    "stem_7x7_s2": (2, 22, 26, 1, 16, 7, 2),
    "3x3_odd": (2, 11, 9, 5, 7, 3, 1),
    "1x1_s2_down": (3, 10, 14, 12, 20, 1, 2),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_int8_conv_equals_jax(name):
    nb, h, w, cin, cout, k, s = CONVS[name]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(nb, h, w, cin)).astype(np.float32)     # NHWC
    wt = rng.normal(size=(k, k, cin, cout)).astype(np.float32)  # HWIO
    pad = [(k // 2, k // 2)] * 2
    jxq, _ = jq.quantize_symmetric(jnp.asarray(x))
    jwq, _ = jq.quantize_symmetric(jnp.asarray(wt), axis=(0, 1, 2))
    jacc = jax.lax.conv_general_dilated(
        jxq, jwq, (s, s), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    tx, tw = t(x).permute(0, 3, 1, 2), t(wt).permute(3, 2, 0, 1)
    txq, _ = tq.quantize_symmetric(tx)
    twq, _ = tq.quantize_symmetric(tw, dims=(1, 2, 3))
    tacc = tq.conv_int32(txq, twq, s, k // 2)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(n(tacc), np.asarray(jacc))
    ref = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(wt), (s, s),
                                  pad))
    np.testing.assert_array_equal(n(tq.int8_conv(tx, tw, s, k // 2))
                                  .transpose(0, 2, 3, 1), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_layers_equal_jax_modules(dtype):
    """Int8Dense and Int8Conv with the JAX modules' parameters: the same
    outputs, in the module's dtype."""
    rng = np.random.default_rng(3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.normal(size=(2, 7, 6, 5)).astype(np.float32)
    jconv = JInt8Conv(9, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                      dtype=jdt)
    var = jconv.init(jax.random.key(0), jnp.asarray(x))
    conv = Int8Conv(5, 9, 3, 2, dtype=tdt)
    with torch.no_grad():
        conv.weight.copy_(t(var["params"]["kernel"]).permute(3, 2, 0, 1))
    got = conv(t(x).permute(0, 3, 1, 2))
    assert got.dtype == tdt
    np.testing.assert_array_equal(n(got).transpose(0, 2, 3, 1), np.asarray(
        jconv.apply(var, jnp.asarray(x)), np.float32))

    xd = rng.normal(size=(3, 4, 10)).astype(np.float32)
    jd = JInt8Dense(6, dtype=jdt)
    vd = jd.init(jax.random.key(1), jnp.asarray(xd))
    dense = Int8Dense(10, 6, dtype=tdt)
    with torch.no_grad():
        dense.weight.copy_(t(vd["params"]["kernel"]).T)
    got = dense(t(xd))
    assert got.dtype == tdt
    np.testing.assert_array_equal(n(got), np.asarray(
        jd.apply(vd, jnp.asarray(xd)), np.float32))


def test_int_mm_pads_to_the_card_rules():
    """Fewer than 17 rows, K and N off the multiple of 8: the padded
    product is the exact one, in the caller's shape."""
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(3, 13)).astype(np.int8)
    b = rng.integers(-127, 128, size=(13, 5)).astype(np.int8)
    got = tq.int_mm(t(a), t(b))
    assert got.shape == (3, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), a.astype(np.int64) @ b.astype(
        np.int64))
