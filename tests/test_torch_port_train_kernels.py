"""The backwards of the port's GAM kernels (K3, K4/K5) on the CPU.

On the CPU the wrappers compute their plain versions; those are held here
against the Pallas backward kernels themselves in interpret mode
(_mka_bwd_pallas, _box_bwd_pallas), against the JAX package's jnp backward
(_mka_bwd_jnp) and against the vjp of box_attention_reference, as
tests/test_pallas.py holds the Pallas kernels. The two autograd.Functions
pass torch.autograd.gradcheck in f64. The CUDA kernels are held against the
plain versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances: f32 gradients at 1e-4 rel / 1e-5 abs (the same sums in another
order); the zero gradients of masked and off-grid rows exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.ops.pallas_attention import (  # noqa: E402
    _box_bwd_pallas,
    _box_forward,
    _mka_bwd_jnp,
    _mka_bwd_pallas,
    box_attention_reference,
)
from geoformer_tpu_torch.ops import gam_kernels as gk  # noqa: E402
from torch_port_util import assert_close, n, t  # noqa: E402

FILL = -1e8


def _mka_inputs(seed, b=3, l=24, s=10, h=2, d=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, l, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(b, l, h, d)).astype(np.float32)
    mask = rng.random((b, s)) > 0.4
    mask[0, 0] = True
    mask[-1] = False          # RANSAC found no inliers in this batch row
    return q, k, v, mask, g


@pytest.mark.parametrize("seed", [0, 1])
def test_mka_bwd_plain_matches_pallas_interpret_and_jnp(seed):
    q, k, v, mask, g = _mka_inputs(seed)
    j = [jnp.asarray(x) for x in (q, k, v, mask, g)]
    # tile 16 does not divide L = 24: the kernel takes query tiles of 8
    ref_pallas = _mka_bwd_pallas(*j, FILL, 16, interpret=True)
    ref_jnp = _mka_bwd_jnp(*j, FILL)
    got = gk.masked_kv_attention_bwd(t(q), t(k), t(v), t(mask), t(g))
    for a, rp, rj, name in zip(got, ref_pallas, ref_jnp, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32
        assert_close(a, rp, 1e-4, 1e-5, name)
        assert_close(a, rj, 1e-4, 1e-5, name)


def test_mka_bwd_all_masked_row():
    """A row with no kept key attends uniformly: dv = colsum(g) / S and
    dq = dk = 0 exactly."""
    q, k, v, mask, g = _mka_inputs(2)
    dq, dk, dv = (n(x) for x in gk.masked_kv_attention_bwd(
        t(q), t(k), t(v), t(mask), t(g)))
    assert (dq[-1] == 0).all() and (dk[-1] == 0).all()
    s = k.shape[1]
    np.testing.assert_allclose(
        dv[-1], np.broadcast_to(g[-1].sum(axis=0) / s, dv[-1].shape),
        rtol=1e-5, atol=1e-6)
    # masked keys of the other rows get no dk
    assert (dk[0][~mask[0]] == 0).all()


def test_mka_bwd_bf16_inputs_give_bf16_grads():
    q, k, v, mask, g = _mka_inputs(3)
    qb, kb, vb = (t(x, torch.bfloat16) for x in (q, k, v))
    got = gk.masked_kv_attention_bwd(qb, kb, vb, t(mask), t(g))
    assert all(x.dtype == torch.bfloat16 for x in got)
    ref = _mka_bwd_jnp(*(jnp.asarray(n(x)) for x in (qb, kb, vb)),
                       jnp.asarray(mask), jnp.asarray(g), FILL)
    for a, r in zip(got, ref):
        # f32 sums rounded once to bf16: one bf16 ulp (2^-8 relative)
        assert_close(a, r, 8e-3, 8e-3)


def _box_inputs(seed, b=2, hg=6, wg=8, h=2, d=4):
    rng = np.random.default_rng(seed)
    s = hg * wg
    q, k, v, g = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    centers = np.stack([rng.integers(-4, wg + 4, size=(b, s)),
                        rng.integers(-4, hg + 4, size=(b, s))],
                       -1).astype(np.int32)
    centers[0, 8:16] = (-10, -10)     # a whole query tile off the grid
    centers[1, 3] = (-1, 2)           # a box partly off the grid
    centers[1, 20:30] = (3, 2)        # many queries on one cell
    return q, k, v, g, centers, (hg, wg)


def _offgrid(centers, grid_hw, r=2):
    hg, wg = grid_hw
    cx, cy = centers[..., 0], centers[..., 1]
    return (cx + r < 0) | (cx - r > wg - 1) | (cy + r < 0) | (cy - r > hg - 1)


@pytest.mark.parametrize("force_tiled", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_box_bwd_plain_matches_pallas_interpret(force_tiled, seed):
    """Each side reads its own forward's out and LSE: the tiled Pallas
    forward's LSE of off-grid rows differs from the port's (ROADMAP queue
    3), and the backward zeroes those rows, so the gradients agree."""
    q, k, v, g, centers, grid = _box_inputs(seed)
    jq, jk, jv, jg, jc = (jnp.asarray(x) for x in (q, k, v, g, centers))
    out_j, lse_j = _box_forward(jq, jk, jv, jc, grid, 2, FILL, 16, 16,
                                interpret=True, force_tiled=force_tiled)
    ref = _box_bwd_pallas(jq, jk, jv, jc, jg, out_j, lse_j, grid, 2, FILL,
                          16, 16, interpret=True)
    out, lse = gk.box_window_attention_fwd(t(q), t(k), t(v), t(centers),
                                           grid)
    got = gk.box_window_attention_bwd(t(q), t(k), t(v), t(centers), out, lse,
                                      t(g), grid)
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert_close(a, r, 1e-4, 1e-5, name)
    off = _offgrid(centers, grid)
    assert off.any() and (n(got[0])[off] == 0).all()


def test_box_bwd_plain_matches_vjp_of_reference():
    q, k, v, g, centers, grid = _box_inputs(2)
    jc = jnp.asarray(centers)
    _, vjp = jax.vjp(lambda a, b_, c: box_attention_reference(
        a, b_, c, jc, grid, 2, FILL), *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    out, lse = gk.box_window_attention_fwd(t(q), t(k), t(v), t(centers),
                                           grid)
    got = gk.box_window_attention_bwd(t(q), t(k), t(v), t(centers), out, lse,
                                      t(g), grid)
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert_close(a, r, 1e-4, 1e-5, name)


def test_autograd_functions_route_through_the_backwards():
    """backward() of the differentiable ops gives the explicit backwards'
    gradients; the centres and the mask get none, and no kernel runs on the
    CPU."""
    q, k, v, g, centers, grid = _box_inputs(3)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    gk.reset_launch_counts()
    out, lse = gk.box_window_attention(qt, kt, vt, t(centers), grid)
    assert not lse.requires_grad
    out.backward(t(g))
    ref = gk.box_window_attention_bwd(t(q), t(k), t(v), t(centers),
                                      out.detach(), lse, t(g), grid)
    for x, r in zip((qt, kt, vt), ref):
        assert torch.equal(x.grad, r)
    q, k, v, mask, g = _mka_inputs(4, s=48)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    gk.masked_kv_attention(qt, kt, vt, t(mask)).backward(t(g))
    ref = gk.masked_kv_attention_bwd(t(q), t(k), t(v), t(mask), t(g))
    for x, r in zip((qt, kt, vt), ref):
        assert torch.equal(x.grad, r)
    assert not any(gk.LAUNCHES.values())


def test_gradcheck_box_window_attention_f64():
    gen = torch.Generator().manual_seed(0)
    grid = (3, 4)
    q, k, v = (torch.randn((1, 12, 1, 4), generator=gen,
                           dtype=torch.float64).requires_grad_()
               for _ in range(3))
    centers = torch.randint(-1, 5, (1, 12, 2), generator=gen).to(torch.int32)
    centers[0, 0] = torch.tensor([-9, -9], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: gk.box_window_attention(a, b, c, centers, grid)[0],
        (q, k, v))


def test_gradcheck_masked_kv_attention_f64():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((2, 5, 1, 4), generator=gen, dtype=torch.float64)
    k, v = (torch.randn((2, 4, 1, 4), generator=gen, dtype=torch.float64)
            for _ in range(2))
    mask = torch.tensor([[True, False, True, True], [False] * 4])
    assert torch.autograd.gradcheck(
        lambda a, b, c: gk.masked_kv_attention(a, b, c, mask),
        tuple(x.requires_grad_() for x in (q, k, v)))
