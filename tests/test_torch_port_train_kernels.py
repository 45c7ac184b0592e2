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
from torch_port_util import one_torch_thread  # noqa: E402,F401

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


def _concentrated_centres(pattern, b, hg, wg, seed):
    """[b, hg * wg, 2] int32 centres where many queries share a cell, as
    K4 meets them in training: "collapsed", a warp that crowds the grid's
    image into a corner (an untrained model's near-degenerate RANSAC fit),
    plus a few rows off and partly off the grid; "zoom", a zoom by 2 about
    the centre, 4 queries on each destination cell."""
    rng = np.random.default_rng(seed)
    y, x = np.divmod(np.arange(hg * wg), wg)
    if pattern == "collapsed":
        w = 1.0 + 0.6 * x / wg + 0.5 * y / hg
        c = np.stack([np.floor(x / (4 * w)) + 1, np.floor(y / (4 * w))], -1)
    else:
        c = np.stack([x // 2 + wg // 4, y // 2 + hg // 4], -1)
    c = np.repeat(c[None], b, axis=0).astype(np.int32)
    c[:, rng.choice(hg * wg, 4, replace=False)] = (-10, -10)
    c[-1, rng.choice(hg * wg, 3, replace=False), 0] = -1
    return c


@pytest.mark.parametrize("pattern", ["collapsed", "zoom"])
@pytest.mark.parametrize("force_tiled", [True, False])
def test_box_bwd_plain_matches_pallas_at_concentrated_centres(
        pattern, force_tiled):
    """The contract K4's schedule keeps, at centres that crowd many queries
    onto few cells: the plain backward against the Pallas backward in
    interpret mode."""
    q, k, v, g, _, grid = _box_inputs(8)
    centers = _concentrated_centres(pattern, q.shape[0], *grid, 8)
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
    n_key = gk.box_dkv_schedule(t(centers), grid)[0]
    assert n_key.max() >= 16               # many queries on one key
    if pattern == "collapsed":
        assert (n_key == 0).any()          # and keys that none covers


@pytest.mark.parametrize("pattern", ["collapsed", "zoom"])
def test_box_bwd_plain_matches_vjp_of_reference_at_concentrated_centres(
        pattern):
    q, k, v, g, _, grid = _box_inputs(9)
    centers = _concentrated_centres(pattern, q.shape[0], *grid, 9)
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


@pytest.mark.parametrize("pattern", ["random", "collapsed", "zoom"])
def test_box_dkv_schedule_matches_brute_force(pattern):
    """K4's split of the work, as the port mirrors it in torch: per key the
    queries whose box covers it (counted here from the dense box mask),
    max(1, ceil(n / BOX_PIECE)) pieces a key, their exclusive scan, and no
    more pieces than box_dkv_max_pieces, which sizes the kernel's launch."""
    hg, wg, r = 20, 24, 2
    if pattern == "random":
        rng = np.random.default_rng(10)
        centers = np.stack([rng.integers(-4, wg + 4, size=(3, hg * wg)),
                            rng.integers(-4, hg + 4, size=(3, hg * wg))],
                           -1).astype(np.int32)
    else:
        centers = _concentrated_centres(pattern, 3, hg, wg, 10)
    y, x = np.divmod(np.arange(hg * wg), wg)
    box = ((np.abs(x[None, None] - centers[..., :1]) <= r)
           & (np.abs(y[None, None] - centers[..., 1:]) <= r))   # [B, L, S]
    n_ref = box.sum(axis=1)
    pieces_ref = np.maximum(1, -(-n_ref // gk.BOX_PIECE))
    n, pieces, base = (x_.numpy() for x_ in gk.box_dkv_schedule(
        t(centers), (hg, wg), r))
    np.testing.assert_array_equal(n, n_ref)
    np.testing.assert_array_equal(pieces, pieces_ref)
    np.testing.assert_array_equal(base[:, 1:], np.cumsum(pieces_ref, 1))
    assert (base[:, 0] == 0).all()
    assert base[:, -1].max() <= gk.box_dkv_max_pieces(hg * wg, hg * wg, r)
    if pattern == "collapsed":
        assert n.max() > 2 * gk.BOX_PIECE   # a key of three pieces or more


def _gather_test_centres(pattern, b, hg, wg, seed):
    """[b, hg * wg, 2] int32 centres for K1/K5's plan: the near-identity
    homography of chip_smoke.py (each cell's corner pixel warped, floored
    to a cell of 8 pixels), the two concentrated patterns, or uniform
    centres with rows fully and partly off the grid."""
    if pattern in ("collapsed", "zoom"):
        return _concentrated_centres(pattern, b, hg, wg, seed)
    rng = np.random.default_rng(seed)
    y, x = np.divmod(np.arange(hg * wg), wg)
    if pattern == "homography":
        H = np.array([[0.95, 0.05, 12.0], [-0.04, 0.98, -6.0],
                      [1e-5, 2e-5, 1.0]])
        w = np.stack([8.0 * x, 8.0 * y, np.ones_like(x, float)], -1) @ H.T
        c = np.floor(w[:, :2] / w[:, 2:] / 8).astype(np.int32)
        return np.repeat(c[None], b, axis=0)
    c = np.stack([rng.integers(-6, wg + 6, size=(b, hg * wg)),
                  rng.integers(-6, hg + 6, size=(b, hg * wg))],
                 -1).astype(np.int32)
    c[0, :40] = (-10, -10)                       # fully off
    c[1, :20] = (wg + 2, 3)                      # box misses by one cell
    c[1, 20:40] = (wg + 1, hg + 1)               # partly off, a corner
    c[-1, 40:60, 1] = -2                         # partly off, the top
    return c


@pytest.mark.parametrize("pattern", ["homography", "collapsed", "zoom",
                                     "offgrid"])
def test_box_gather_schedule_matches_brute_force(pattern):
    """K1's and K5's split of the work, as the port mirrors it in torch:
    per tile of BOX_TILE x BOX_TILE cells of the grid widened by r, the
    queries whose centre lies in it (counted here tile by tile; a query
    whose box misses the grid, by the dense box mask, lies in none),
    ceil(n / BOX_GATHER_PIECE) pieces a tile, their exclusive scan, and no
    more pieces than box_gather_max_pieces, which sizes the kernels'
    grids. Every in-grid cell of a query's box lies in its tile's window
    (the tile widened by r again, clamped to the grid, as
    csrc/box_plan.cuh's find_piece computes it), of at most
    (BOX_TILE + 2r)^2 cells: the window the kernels stage in shared memory
    holds every key a query of the piece reads."""
    hg, wg, r, T = 20, 27, 2, gk.BOX_TILE
    centers = _gather_test_centres(pattern, 3, hg, wg, 11)
    ty, tx = gk.box_gather_tiles((hg, wg), r)
    assert (ty, tx) == (-(-(hg + 2 * r) // T), -(-(wg + 2 * r) // T))
    cx, cy = centers[..., 0], centers[..., 1]
    y, x = np.divmod(np.arange(hg * wg), wg)
    box = ((np.abs(x[None, None] - cx[..., None]) <= r)
           & (np.abs(y[None, None] - cy[..., None]) <= r))   # [B, L, S]
    on = box.any(axis=2)
    n_ref = np.zeros((3, ty * tx), np.int64)
    for t_ in range(ty * tx):
        gx, gy = (t_ % tx) * T - r, (t_ // tx) * T - r  # its centres' corner
        n_ref[:, t_] = (on & (cx >= gx) & (cx < gx + T) & (cy >= gy)
                        & (cy < gy + T)).sum(axis=1)
    assert n_ref.sum() == on.sum()          # each such query in one tile
    n, pieces, base = (x_.numpy() for x_ in gk.box_gather_schedule(
        t(centers), (hg, wg), r))
    np.testing.assert_array_equal(n, n_ref)
    np.testing.assert_array_equal(
        pieces, -(-n_ref // gk.BOX_GATHER_PIECE))
    np.testing.assert_array_equal(base[:, 1:], np.cumsum(pieces, 1))
    assert (base[:, 0] == 0).all()
    assert base[:, -1].max() <= gk.box_gather_max_pieces(hg * wg, (hg, wg), r)
    # the window of each query's tile holds its box's in-grid cells
    bi, li = np.nonzero(on)
    tile = ((cy[bi, li] + r) // T) * tx + (cx[bi, li] + r) // T
    x0, y0 = (tile % tx) * T - 2 * r, (tile // tx) * T - 2 * r
    wx0, wy0 = np.maximum(x0, 0), np.maximum(y0, 0)
    wx1 = np.minimum(x0 + T + 2 * r - 1, wg - 1)
    wy1 = np.minimum(y0 + T + 2 * r - 1, hg - 1)
    assert ((wx1 - wx0 + 1) * (wy1 - wy0 + 1)).max() <= (T + 2 * r) ** 2
    cells = box[bi, li]                                     # [Q, S]
    inside = ((x[None] >= wx0[:, None]) & (x[None] <= wx1[:, None])
              & (y[None] >= wy0[:, None]) & (y[None] <= wy1[:, None]))
    assert not (cells & ~inside).any()
    if pattern == "collapsed":
        assert pieces.max() >= 2            # a tile of several pieces
    if pattern in ("collapsed", "zoom"):
        assert (n == 0).any()               # and tiles with none
    if pattern == "offgrid":                # boxes fully and partly off
        assert (~on).sum() >= 60
        assert (on & ((cx < 0) | (cx >= wg) | (cy < 0) | (cy >= hg))).any()


def test_autograd_functions_route_through_the_backwards():
    """backward() of the differentiable ops gives the explicit backwards'
    gradients; the centres and the mask get none, and no kernel runs on the
    CPU."""
    q, k, v, g, centers, grid = _box_inputs(3)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    gk.reset_launch_counts()
    out, lse = gk.box_window_attention_fwd(qt, kt, vt, t(centers), grid)
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


@pytest.mark.parametrize("seed", [5, 6])
def test_mka_function_backward_from_forward_stats_matches_pallas(seed):
    """The differentiable op keeps the forward's output and row statistics
    and hands them to the backward (as K2 hands them to K3 on the card);
    through the plain versions its gradients match the Pallas backward in
    interpret mode."""
    q, k, v, mask, g = _mka_inputs(seed)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    gk.masked_kv_attention(qt, kt, vt, t(mask)).backward(t(g))
    ref = _mka_bwd_pallas(*(jnp.asarray(x) for x in (q, k, v, mask, g)),
                          FILL, 16, interpret=True)
    for x, r, name in zip((qt, kt, vt), ref, ("dq", "dk", "dv")):
        assert_close(x.grad, r, 1e-4, 1e-5, name)


def test_mka_forward_stats():
    """Row statistics of the forward: the max m and log-denominator of the
    masked, scaled logits; a row with no kept key has m = scale * fill and
    logd = log S exactly, and its probabilities exp((z - m) - logd) = 1/S."""
    q, k, v, mask, _ = _mka_inputs(7, s=48)
    out, stats = gk.masked_kv_attention_fwd(t(q), t(k), t(v), t(mask),
                                            return_stats=True)
    assert torch.equal(out, gk.masked_kv_attention(t(q), t(k), t(v),
                                                   t(mask)))
    scale = 1.0 / np.sqrt(q.shape[-1])
    z = scale * np.where(mask[:, None, :, None],
                         np.einsum("blhd,bshd->blsh", q, k), FILL)
    m = z.max(axis=2)
    logd = np.log(np.exp(z - m[:, :, None]).sum(axis=2))
    np.testing.assert_allclose(n(stats[0]), m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(stats[1]), logd, rtol=1e-5, atol=1e-5)
    assert (n(stats[0])[-1] == np.float32(scale * FILL)).all()
    assert (n(stats[1])[-1] == np.float32(np.log(48))).all()


def test_gradcheck_box_window_attention_f64():
    gen = torch.Generator().manual_seed(0)
    grid = (3, 4)
    q, k, v = (torch.randn((1, 12, 1, 4), generator=gen,
                           dtype=torch.float64).requires_grad_()
               for _ in range(3))
    centers = torch.randint(-1, 5, (1, 12, 2), generator=gen).to(torch.int32)
    centers[0, 0] = torch.tensor([-9, -9], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: gk.box_window_attention_fwd(a, b, c, centers, grid)[0],
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
