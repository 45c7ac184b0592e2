"""Port attention primitives and encoder layers against JAX.

JAX-initialized parameters cross over as the flat npz dict
(geoformer_tpu_torch.weights), inputs come from seeded numpy. Tolerance:
f32 at 1e-4 rel / 1e-5 abs (the same math, summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.models import transformer as jtr  # noqa: E402
from geoformer_tpu.ops import attention as jatt  # noqa: E402
from geoformer_tpu_torch.models import transformer as ttr  # noqa: E402
from geoformer_tpu_torch.ops import attention as tatt  # noqa: E402
from geoformer_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_port_util import assert_close, flatten, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-4, 1e-5


def _qkv(seed, b=2, l=12, s=10, h=2, d=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, l, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(2))
    qm = rng.random((b, l)) > 0.2
    km = rng.random((b, s)) > 0.3
    km[-1] = False
    return q, k, v, qm, km


@pytest.mark.parametrize("masks", ["none", "kv", "both"])
def test_linear_attention_matches_jax(masks):
    q, k, v, qm, km = _qkv(0)
    qm_, km_ = {"none": (None, None), "kv": (None, km),
                "both": (qm, km)}[masks]
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    tt = lambda x: None if x is None else t(x)  # noqa: E731
    ref = jatt.linear_attention(*map(jnp.asarray, (q, k, v)), j(qm_), j(km_))
    assert_close(tatt.linear_attention(t(q), t(k), t(v), tt(qm_), tt(km_)),
                 ref, RTOL, ATOL)
    b, l, h, d = q.shape
    flat = [x.reshape(x.shape[0], x.shape[1], -1) for x in (q, k, v)]
    ref_f = jatt.linear_attention_flat(*map(jnp.asarray, flat), h, j(qm_),
                                       j(km_))
    got_f = tatt.linear_attention_flat(*map(t, flat), h, tt(qm_), tt(km_))
    assert_close(got_f, ref_f, RTOL, ATOL)
    assert_close(got_f.reshape(b, l, h, d), ref, RTOL, ATOL)


@pytest.mark.parametrize("fill", [-1e9, -1e8])
@pytest.mark.parametrize("zero_empty", [False, True])
@pytest.mark.parametrize("masks", ["none", "kv", "both"])
def test_full_attention_matches_jax(fill, zero_empty, masks):
    q, k, v, qm, km = _qkv(1)
    qm_, km_ = {"none": (None, None), "kv": (None, km),
                "both": (qm, km)}[masks]
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    tt = lambda x: None if x is None else t(x)  # noqa: E731
    ref = jatt.full_attention(*map(jnp.asarray, (q, k, v)), j(qm_), j(km_),
                              mask_fill=fill, zero_empty_rows=zero_empty)
    got = tatt.full_attention(t(q), t(k), t(v), tt(qm_), tt(km_),
                              mask_fill=fill, zero_empty_rows=zero_empty)
    assert_close(got, ref, RTOL, ATOL)


def test_window_cross_attention_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 9, 2, 4)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 25, 2, 4)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((2, 9, 25)) > 0.5
    mask[0, 3] = False                    # whole window off the grid
    ref = jatt.window_cross_attention(*map(jnp.asarray, (q, k, v, mask)))
    got = tatt.window_cross_attention(*map(t, (q, k, v, mask)))
    assert_close(got, ref, RTOL, ATOL)
    assert (got[0, 3] == 0).all()


def _layer_pair(attention, mlp_act="relu", d=16, h=2, seed=3, s=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    src = rng.normal(size=(2, s, d)).astype(np.float32)
    jl = jtr.EncoderLayer(d, h, attention=attention, mlp_act=mlp_act)
    variables = jax.jit(jl.init)(jax.random.key(seed), jnp.asarray(x),
                                 jnp.asarray(src))
    tl = ttr.EncoderLayer(d, h, attention=attention, mlp_act=mlp_act)
    load_jax_params(tl, flatten(variables))
    return jl, variables, tl, x, src, rng


@pytest.mark.parametrize("attention", ["linear", "linear_flat", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_encoder_layer_matches_jax(attention, masked):
    jl, var, tl, x, src, rng = _layer_pair(attention)
    xm = (rng.random((2, 12)) > 0.2) if masked else None
    sm = (rng.random((2, 10)) > 0.2) if masked else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    tt = lambda a: None if a is None else t(a)  # noqa: E731
    ref = jl.apply(var, jnp.asarray(x), jnp.asarray(src), j(xm), j(sm))
    got = tl(t(x), t(src), tt(xm), tt(sm))
    assert_close(got, ref, RTOL, ATOL)


@pytest.mark.parametrize("attention", ["linear", "linear_flat", "full"])
def test_encoder_layer_bf16_matches_jax(attention):
    """bf16 projections with f32 LayerNorms: the layer's output is f32 in
    both packages. Tolerance 5e-2 abs: full attention takes its logits and
    probabilities in bf16, a few bf16 ulps (2^-7 at 1) after LayerNorm."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    src = rng.normal(size=(2, 10, 16)).astype(np.float32)
    jl = jtr.EncoderLayer(16, 2, attention=attention, dtype=jnp.bfloat16)
    variables = jax.jit(jl.init)(jax.random.key(7), jnp.asarray(x),
                                 jnp.asarray(src))
    ref = jl.apply(variables, jnp.asarray(x, jnp.bfloat16),
                   jnp.asarray(src, jnp.bfloat16))
    tl = ttr.EncoderLayer(16, 2, attention=attention, dtype=torch.bfloat16)
    load_jax_params(tl, flatten(variables))
    got = tl(t(x, torch.bfloat16), t(src, torch.bfloat16))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_close(got, ref, 0, 5e-2)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_geo_self_layer_matches_jax(use_kernel):
    """The GAM self layer (tanh MLP, -1e8 fill, column mask) with and
    without the K2 dispatch; on the CPU K2 is its plain version."""
    jl, var, tl, x, src, rng = _layer_pair("full", "tanh", seed=4)
    tl.use_kernel = use_kernel
    sm = rng.random((2, 10)) > 0.5
    sm[1] = False                           # no inliers: uniform attention
    ref = jl.apply(var, jnp.asarray(x), jnp.asarray(src), None,
                   jnp.asarray(sm), mask_fill=-1e8)
    got = tl(t(x), t(src), None, t(sm), mask_fill=-1e8)
    assert_close(got, ref, RTOL, ATOL)


def test_box_window_call_matches_window_call_in_jax():
    """The box path (K1's plain version) equals the JAX gather path on
    gathered windows whose cells are the in-grid box."""
    hg, wg, d = 4, 5, 16
    jl, var, tl, x, src, rng = _layer_pair("full", "tanh", d=d, seed=5,
                                           s=hg * wg)
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    centers = np.stack([rng.integers(-3, wg + 3, size=(2, 12)),
                        rng.integers(-3, hg + 3, size=(2, 12))],
                       -1).astype(np.int32)
    offs = np.arange(-2, 3)
    cx = centers[..., 0, None, None] + offs[None, None, None, :]
    cy = centers[..., 1, None, None] + offs[None, None, :, None]
    cx, cy = np.broadcast_arrays(cx, cy)
    inb = (cx >= 0) & (cx < wg) & (cy >= 0) & (cy < hg)
    cells = (np.clip(cy, 0, hg - 1) * wg + np.clip(cx, 0, wg - 1))
    cells = cells.reshape(2, 12, 25)
    win = np.take_along_axis(src[:, None], cells[..., None], axis=2)
    ref = jl.apply(var, jnp.asarray(x), jnp.asarray(win),
                   jnp.asarray(inb.reshape(2, 12, 25)),
                   method=jtr.EncoderLayer.window_call)
    got = tl.box_window_call(t(x), t(src), t(centers), (hg, wg), 2)
    assert_close(got, ref, RTOL, ATOL)
    got_w = tl.window_call(t(x), t(win), t(inb.reshape(2, 12, 25)))
    assert_close(got_w, ref, RTOL, ATOL)


@pytest.mark.parametrize("attention", ["linear", "linear_flat"])
def test_local_feature_transformer_matches_jax(attention):
    rng = np.random.default_rng(6)
    f0, f1 = (rng.normal(size=(2, 20, 16)).astype(np.float32)
              for _ in range(2))
    m0 = rng.random((2, 20)) > 0.1
    m1 = rng.random((2, 20)) > 0.1
    names = ("self", "cross") * 2
    jm = jtr.LocalFeatureTransformer(16, 4, names, attention)
    args = tuple(map(jnp.asarray, (f0, f1, m0, m1)))
    variables = jax.jit(jm.init)(jax.random.key(6), *args)
    ref = jm.apply(variables, *args)
    tm = ttr.LocalFeatureTransformer(16, 4, names, attention)
    load_jax_params(tm, flatten(variables))
    got = tm(*map(t, (f0, f1, m0, m1)))
    for a, b in zip(got, ref):
        assert_close(a, b, RTOL, ATOL)


def test_unknown_layer_name_raises():
    with pytest.raises(KeyError):
        ttr.LocalFeatureTransformer(16, 4, ("self", "bogus"))
