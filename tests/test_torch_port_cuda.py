"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker
and skips without a card. The file imports only torch and the port,
because the card's machine has no JAX; tests/conftest.py imports JAX, so
run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances: K1 writes out in the input type, so bf16 at 2e-2 abs (one bf16
ulp at |x| < 4) and f32 at 1e-5; its LSE at 1e-4; K2 writes f32 from the
same inputs, 1e-4 (order of the sums). The backwards K3-K5 are held by
their largest error over the largest magnitude of the plain result: f32 at
1e-4 (sums of up to L terms in another order, no atomics), and bf16 at
8e-3, since both sides round an f32 gradient to bf16 (one ulp is 2^-8 of
the value). K2's row statistics (max and log-denominator) at 1e-4 abs,
as its output. The shapes here are small and not multiples of the kernels'
tiles (K2 and K3 skip 64-key tiles with no kept key, so their tests cover
prefix masks with 0, 1, 63, 64, 65 and all S keys live); chip_smoke.py
holds every kernel to its plain version at the main path's shapes and
inside the model.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu_torch.ops import gam_kernels as gk  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels are CUDA)")
    return torch.device("cuda", 0)


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_box_kernel_matches_plain(dev, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    hg, wg = 12, 16
    q, k, v = (_rand(gen, (2, hg * wg, 4, 64), dt, dev) for _ in range(3))
    c = torch.stack([torch.randint(-4, wg + 4, (2, hg * wg), generator=gen),
                     torch.randint(-4, hg + 4, (2, hg * wg), generator=gen)],
                    -1).to(torch.int32)
    c[0, :10] = torch.tensor([-10, -10], dtype=torch.int32)  # off the grid
    c = c.to(dev)
    gk.reset_launch_counts()
    out, lse = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    assert gk.LAUNCHES["box_window_attention"] == 1
    ref, ref_lse = gk.box_window_attention_plain(q, k, v, c, (hg, wg))
    assert out.dtype == dt and lse.dtype == torch.float32
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert (out[0, :10] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mka_kernel_matches_plain(dev, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    q = _rand(gen, (2, 100, 4, 64), dt, dev)      # L not a tile multiple
    k, v = (_rand(gen, (2, 70, 4, 64), dt, dev) for _ in range(2))
    mask = torch.rand((2, 70), generator=gen) > 0.5
    mask[1] = False                                # no inliers in row 1
    mask = mask.to(dev)
    gk.reset_launch_counts()
    out = gk.masked_kv_attention(q, k, v, mask)
    assert gk.LAUNCHES["masked_kv_attention"] == 1
    ref = gk.masked_kv_attention_plain(q, k, v, mask)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-4
    mean_v = v[1].float().mean(dim=0)
    assert (out[1] - mean_v[None]).abs().max().item() <= 1e-4


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 1, 32), device=dev)     # head dim 32, not 64
    with pytest.raises(ValueError):
        gk.masked_kv_attention(q, q, q, torch.ones((1, 8), device=dev))
    q = torch.zeros((1, 8, 1, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        gk.masked_kv_attention(q, q, q, torch.ones((1, 8), device=dev))


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mka_bwd_kernel_matches_plain(dev, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(2)
    q = _rand(gen, (2, 100, 4, 64), dt, dev)      # L not a tile multiple
    k, v = (_rand(gen, (2, 70, 4, 64), dt, dev) for _ in range(2))
    g = _rand(gen, (2, 100, 4, 64), torch.float32, dev)
    mask = torch.rand((2, 70), generator=gen) > 0.5
    mask[1] = False                                # no inliers in row 1
    mask = mask.to(dev)
    gk.reset_launch_counts()
    got = gk.masked_kv_attention_bwd(q, k, v, mask, g)
    assert gk.LAUNCHES["masked_kv_attention_bwd"] == 1
    ref = gk.masked_kv_attention_bwd_plain(q, k, v, mask, g)
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.dtype == dt, name
        assert _rel_err(a, r) <= BWD_TOL[dt], name
    dq, dk, dv = got
    assert (dq[1] == 0).all() and (dk[1] == 0).all()
    colmean = g[1].sum(dim=0) / 70
    assert _rel_err(dv[1], colmean.expand_as(dv[1])) <= BWD_TOL[dt]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_box_bwd_kernels_match_plain(dev, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    hg, wg = 12, 16
    q, k, v = (_rand(gen, (2, hg * wg, 4, 64), dt, dev) for _ in range(3))
    g = _rand(gen, (2, hg * wg, 4, 64), dt, dev)
    c = torch.stack([torch.randint(-4, wg + 4, (2, hg * wg), generator=gen),
                     torch.randint(-4, hg + 4, (2, hg * wg), generator=gen)],
                    -1).to(torch.int32)
    c[0, :10] = torch.tensor([-10, -10], dtype=torch.int32)  # off the grid
    c[1, :30] = torch.tensor([5, 6], dtype=torch.int32)      # one crowded cell
    c = c.to(dev)
    out, lse = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    gk.reset_launch_counts()
    got = gk.box_window_attention_bwd(q, k, v, c, out, lse, g, (hg, wg))
    assert gk.LAUNCHES["box_window_attention_bwd_dq"] == 1
    assert gk.LAUNCHES["box_window_attention_bwd_dkv"] == 1
    ref = gk.box_window_attention_bwd_plain(q, k, v, c, out, lse, g,
                                            (hg, wg))
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.dtype == dt, name
        assert _rel_err(a, r) <= BWD_TOL[dt], name
    assert (got[0][0, :10] == 0).all()
    # deterministic: no atomics on the gradients
    again = gk.box_window_attention_bwd(q, k, v, c, out, lse, g, (hg, wg))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_autograd_functions_run_the_backward_kernels(dev):
    gen = torch.Generator().manual_seed(4)
    hg, wg = 6, 8
    q, k, v = (_rand(gen, (1, hg * wg, 4, 64), torch.float32, dev)
               .requires_grad_() for _ in range(3))
    c = torch.randint(0, wg, (1, hg * wg, 2), generator=gen).to(
        torch.int32).to(dev)
    mask = (torch.rand((1, hg * wg), generator=gen) > 0.3).to(dev)
    gk.reset_launch_counts()
    out, _ = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    (out.sum() + gk.masked_kv_attention(q, k, v, mask).sum()).backward()
    assert all(n == 1 for n in gk.LAUNCHES.values()), gk.LAUNCHES
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def _prefix_mask(s, counts):
    """The GAM's mask shape: masked_select_capacity packs the live keys
    first, so row i keeps its first counts[i] keys."""
    mask = torch.zeros((len(counts), s), dtype=torch.bool)
    for i, c in enumerate(counts):
        mask[i, :c] = True
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [70, 1000])
@pytest.mark.parametrize("kind", ["prefix", "random"])
def test_mka_kernels_on_tile_edges(dev, dtype, s, kind):
    """K2 and K3 where key tiles are skipped: live counts around the 64-key
    tile in prefix masks, or a random mask; L and S not tile multiples."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    b, l = 6, 100
    if kind == "prefix":
        mask = _prefix_mask(s, [0, 1, 63, 64, 65, s])
    else:
        mask = torch.rand((b, s), generator=gen) < 0.3
        mask[0] = False
    mask = mask.to(dev)
    q = _rand(gen, (b, l, 4, 64), dt, dev)
    k, v = (_rand(gen, (b, s, 4, 64), dt, dev) for _ in range(2))
    g = _rand(gen, (b, l, 4, 64), torch.float32, dev)
    gk.reset_launch_counts()
    out, stats = gk.masked_kv_attention_fwd(q, k, v, mask, return_stats=True)
    assert gk.LAUNCHES["masked_kv_attention"] == 1
    ref, ref_stats = gk.masked_kv_attention_plain(q, k, v, mask,
                                                  return_stats=True)
    assert out.dtype == torch.float32 and stats.shape == (2, b, l, 4)
    assert (out - ref).abs().max().item() <= 1e-4
    assert (stats - ref_stats).abs().max().item() <= 1e-4
    mean_v = v[0].float().mean(dim=0)
    assert (out[0] - mean_v[None]).abs().max().item() <= 1e-4

    got = gk.masked_kv_attention_bwd(q, k, v, mask, g, out=out, stats=stats)
    assert gk.LAUNCHES["masked_kv_attention_bwd"] == 1
    ref = gk.masked_kv_attention_bwd_plain(q, k, v, mask, g)
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.dtype == dt, name
        assert _rel_err(a, r) <= BWD_TOL[dt], name
    dq, dk, dv = got
    assert (dq[0] == 0).all() and (dk[0] == 0).all()
    colmean = g[0].sum(dim=0) / s
    assert _rel_err(dv[0], colmean.expand_as(dv[0])) <= BWD_TOL[dt]
    # deterministic: no atomics
    again = gk.masked_kv_attention_bwd(q, k, v, mask, g, out=out,
                                       stats=stats)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mka_function_hands_forward_stats_to_backward(dev, dtype):
    """The differentiable op runs K2 once (keeping its output and row
    statistics) and K3 once from them; under no_grad K2 keeps none."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(6)
    s = 70
    mask = _prefix_mask(s, [0, 40, 64, s]).to(dev)
    q = _rand(gen, (4, 100, 4, 64), dt, dev).requires_grad_()
    k, v = (_rand(gen, (4, s, 4, 64), dt, dev).requires_grad_()
            for _ in range(2))
    g = _rand(gen, (4, 100, 4, 64), torch.float32, dev)
    gk.reset_launch_counts()
    gk.masked_kv_attention(q, k, v, mask).backward(g)
    assert gk.LAUNCHES["masked_kv_attention"] == 1
    assert gk.LAUNCHES["masked_kv_attention_bwd"] == 1
    ref = gk.masked_kv_attention_bwd_plain(q.detach(), k.detach(),
                                           v.detach(), mask, g)
    for x, r, name in zip((q, k, v), ref, ("dq", "dk", "dv")):
        assert _rel_err(x.grad, r) <= BWD_TOL[dt], name
    with torch.no_grad():
        out = gk.masked_kv_attention(q, k, v, mask)
    assert gk.LAUNCHES["masked_kv_attention"] == 2
    ref_out = gk.masked_kv_attention_plain(q.detach(), k.detach(),
                                           v.detach(), mask)
    assert (out - ref_out).abs().max().item() <= 1e-4


def test_mka_wrappers_refuse_fills_whose_weights_do_not_vanish(dev):
    """The kernels skip masked key tiles, exact only where a masked key's
    weight underflows to 0 (mask_fill <= -1e4)."""
    q = torch.zeros((1, 8, 1, 64), device=dev)
    mask = torch.ones((1, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="mask_fill"):
        gk.masked_kv_attention_fwd(q, q, q, mask, mask_fill=-1.0)
    with pytest.raises(ValueError, match="mask_fill"):
        gk.masked_kv_attention_bwd(q, q, q, mask, q, mask_fill=-1.0)


def _dkv_centres(case, gen, hg, wg, l):
    """[2, l, 2] int32 centres on an hg x wg grid that load K4's pieces
    (gk.BOX_PIECE contributions a warp) in one way each."""
    c = torch.stack([torch.randint(0, wg, (2, l), generator=gen),
                     torch.randint(0, hg, (2, l), generator=gen)],
                    -1).to(torch.int32)
    off = torch.tensor([-10, -10], dtype=torch.int32)
    piece = gk.BOX_PIECE
    if case == "piece_edges":
        # row 0: groups of piece - 1, piece, piece + 1, 2 piece and
        # 2 piece + 1 queries on one cell each, 10 cells apart (each key
        # near a group counts that group only); the rest off the grid
        c[0] = off
        i = 0
        for n, cell in ((piece - 1, (5, 5)), (piece, (15, 5)),
                        (piece + 1, (25, 5)), (2 * piece, (5, 20)),
                        (2 * piece + 1, (15, 20))):
            c[0, i:i + n] = torch.tensor(cell, dtype=torch.int32)
            i += n
    elif case == "crowded":
        # most of row 0 on one cell, a crowd in a corner of row 1
        c[0, :3 * l // 4] = torch.tensor([20, 17], dtype=torch.int32)
        c[1, 100:140] = 0
    elif case == "offgrid":
        c = torch.stack([torch.randint(-4, wg + 4, (2, l), generator=gen),
                         torch.randint(-4, hg + 4, (2, l), generator=gen)],
                        -1).to(torch.int32)
        c[0, :100] = off                               # fully off
        c[1, :50, 0] = -2                              # partly off
        c[1, 50:100] = torch.tensor([wg + 1, hg + 1], dtype=torch.int32)
    elif case == "empty_row":
        c[1] = torch.tensor([wg + 5, hg + 5], dtype=torch.int32)
    return c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["piece_edges", "crowded", "offgrid",
                                  "empty_row"])
def test_box_dkv_kernel_splits_keys_into_pieces(dev, dtype, case):
    """K4 against the plain backward where its keys' lists of
    contributions are cut into pieces: keys with exactly one piece less
    one, one piece, one piece and one, two pieces and two and one; a key
    covered by > 1000 queries; off-grid and partly-off rows; a batch row
    with no query on the grid. One launch, the same bits twice."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(7)
    hg, wg = 40, 40
    l = hg * wg
    c = _dkv_centres(case, gen, hg, wg, l)
    n_key, _, _ = gk.box_dkv_schedule(c, (hg, wg))
    if case == "piece_edges":
        piece = gk.BOX_PIECE
        assert {piece - 1, piece, piece + 1, 2 * piece,
                2 * piece + 1} <= set(n_key[0].tolist())
    elif case == "crowded":
        assert n_key.max() > 1000
    elif case == "empty_row":
        assert (n_key[1] == 0).all()
    c = c.to(dev)
    q, k, v = (_rand(gen, (2, l, 4, 64), dt, dev) for _ in range(3))
    g = _rand(gen, (2, l, 4, 64), torch.float32, dev)
    out, lse = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    delta = (g * out.float()).sum(-1)
    gk.reset_launch_counts()
    dk, dv = gk.box_window_attention_bwd_dkv(q, k, v, c, lse, delta, g,
                                             (hg, wg))
    assert gk.LAUNCHES["box_window_attention_bwd_dkv"] == 1
    ref = gk.box_window_attention_bwd_plain(q, k, v, c, out, lse, g,
                                            (hg, wg))[1:]
    for a, r, name in zip((dk, dv), ref, ("dk", "dv")):
        assert a.dtype == torch.float32, name
        assert _rel_err(a.to(dt), r) <= BWD_TOL[dt], name
    if case == "empty_row":
        assert (dk[1] == 0).all() and (dv[1] == 0).all()
    again = gk.box_window_attention_bwd_dkv(q, k, v, c, lse, delta, g,
                                            (hg, wg))
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


def _gather_centres(case, gen, hg, wg, l):
    """[2, l, 2] int32 centres on an hg x wg grid that load K1's and K5's
    plan (tiles of gk.BOX_TILE cells of the grid widened by r = 2, pieces of
    gk.BOX_GATHER_PIECE queries) in one way each."""
    c = torch.stack([torch.randint(0, wg, (2, l), generator=gen),
                     torch.randint(0, hg, (2, l), generator=gen)],
                    -1).to(torch.int32)
    t, r, piece = gk.BOX_TILE, 2, gk.BOX_GATHER_PIECE
    if case == "crowded_tile":
        # 2 pieces + 5 queries in the tile of widened cells [2t, 3t)^2,
        # on its 64 cells; a full piece and one more on a single cell
        n = 2 * piece + 5
        c[0, :n] = torch.randint(2 * t - r, 3 * t - r, (n, 2), generator=gen)
        c[1, :piece + 1] = torch.tensor([wg // 2, hg // 2],
                                        dtype=torch.int32)
    elif case == "edges":
        # every centre on a border band, partly off included: windows
        # clamped at all four edges and in the corners
        side = torch.randint(0, 4, (2, l), generator=gen)
        band = torch.randint(-r, r + 1, (2, l), generator=gen)
        c[..., 0] = torch.where(side == 0, band, c[..., 0])
        c[..., 0] = torch.where(side == 1, wg - 1 + band, c[..., 0])
        c[..., 1] = torch.where(side == 2, band, c[..., 1])
        c[..., 1] = torch.where(side == 3, hg - 1 + band, c[..., 1])
        c[0, :4] = torch.tensor([[-2, -2], [wg + 1, -2], [-2, hg + 1],
                                 [wg + 1, hg + 1]], dtype=torch.int32)
    elif case == "offgrid":
        c[0, :100] = torch.tensor([-10, -10], dtype=torch.int32)  # fully off
        c[0, 100:150] = torch.tensor([wg + r + 1, 3], dtype=torch.int32)
        c[1, :50, 0] = -r                                # partly off
        c[1, 50:100] = torch.tensor([wg + 1, hg + 1], dtype=torch.int32)
    elif case == "empty_tiles":
        # row 0 in two tiles only, row 1 with no query on the grid
        c[0] = torch.randint(t - r, 2 * t - r, (l, 2), generator=gen)
        c[0, ::3, 1] += 2 * t
        c[1] = torch.tensor([wg + 5, hg + 5], dtype=torch.int32)
    return c


def _offgrid(c, hg, wg, r=2):
    cx, cy = c[..., 0], c[..., 1]
    return (cx + r < 0) | (cx - r > wg - 1) | (cy + r < 0) | (cy - r > hg - 1)


def _check_gather_plan(case, c, hg, wg):
    """The centres load the plan as the case says (by its torch mirror)."""
    n, pieces, _ = gk.box_gather_schedule(c, (hg, wg))
    off = _offgrid(c, hg, wg)
    if case == "crowded_tile":
        assert pieces.max() >= 3
    elif case == "edges":
        ty, tx = gk.box_gather_tiles((hg, wg))
        n_t = n.view(2, ty, tx)
        for edge in (n_t[:, 0], n_t[:, -1], n_t[:, :, 0], n_t[:, :, -1]):
            assert (edge > 0).any()
    elif case == "offgrid":
        assert off[0].sum() == 150 and not off[1].any()
    elif case == "empty_tiles":
        assert (n[0] > 0).sum() == 2 and (n[1] == 0).all()
    return off


GATHER_CASES = ["crowded_tile", "edges", "offgrid", "empty_tiles"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATHER_CASES)
def test_box_fwd_kernel_gather_plan(dev, dtype, case):
    """K1 against its plain version where the gather plan's edges are: a
    tile of several pieces, windows clamped at the grid's four edges, rows
    whose box misses the grid (out 0, the all-masked LSE), tiles and a
    batch row with no query. One count in LAUNCHES a call, the same bits
    twice."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    hg, wg = 40, 44
    l = hg * wg
    c = _gather_centres(case, gen, hg, wg, l)
    off = _check_gather_plan(case, c, hg, wg).to(dev)
    c = c.to(dev)
    q, k, v = (_rand(gen, (2, l, 4, 64), dt, dev) for _ in range(3))
    gk.reset_launch_counts()
    out, lse = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    assert gk.LAUNCHES["box_window_attention"] == 1
    ref, ref_lse = gk.box_window_attention_plain(q, k, v, c, (hg, wg))
    assert out.dtype == dt and lse.dtype == torch.float32
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if (~off).any():
        assert (lse - ref_lse)[~off].abs().max().item() <= 1e-4
    assert (out[off] == 0).all() and torch.equal(lse[off], ref_lse[off])
    again = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATHER_CASES)
def test_box_dq_kernel_gather_plan(dev, dtype, case):
    """K5 against the plain backward at the same plan edges as K1's test;
    rows whose box misses the grid get dq = 0. One count in LAUNCHES a
    call, the same bits twice."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(9)
    hg, wg = 40, 44
    l = hg * wg
    c = _gather_centres(case, gen, hg, wg, l)
    off = _check_gather_plan(case, c, hg, wg).to(dev)
    c = c.to(dev)
    q, k, v = (_rand(gen, (2, l, 4, 64), dt, dev) for _ in range(3))
    g = _rand(gen, (2, l, 4, 64), torch.float32, dev)
    out, lse = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    delta = (g * out.float()).sum(-1)
    gk.reset_launch_counts()
    dq = gk.box_window_attention_bwd_dq(q, k, v, c, lse, delta, g, (hg, wg))
    assert gk.LAUNCHES["box_window_attention_bwd_dq"] == 1
    ref = gk.box_window_attention_bwd_plain(q, k, v, c, out, lse, g,
                                            (hg, wg))[0]
    assert dq.dtype == torch.float32
    assert _rel_err(dq.to(dt), ref) <= BWD_TOL[dt]
    assert (dq[off] == 0).all()
    again = gk.box_window_attention_bwd_dq(q, k, v, c, lse, delta, g,
                                           (hg, wg))
    assert torch.equal(dq, again)


# ------------------------------------------------- the evaluation path ----

def _correspondences(n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    H = np.array([[0.9, 0.08, 20.0], [-0.05, 1.1, -12.0], [2e-4, -1e-4, 1]])
    p0 = rng.random((n, 2)) * [640, 480]
    ph = np.concatenate([p0, np.ones((n, 1))], 1) @ H.T
    p1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.5, (n, 2))
    p1[rng.choice(n, n // 3, replace=False)] = rng.random((n // 3, 2)) * 600
    return p0.astype(np.float32), p1.astype(np.float32)


@pytest.mark.parametrize("n", [6, 300, 1024])
def test_fit_homography_on_the_card_matches_the_cpu(dev, n):
    """The same injected hypotheses on the card and on the CPU: H within
    1e-4 relative (the same f32 solves; cuSOLVER's eigh against LAPACK's),
    the same inliers."""
    import numpy as np

    from geoformer_tpu_torch.eval.hpatches import (
        fit_capacity,
        fit_homography_np,
    )

    p0, p1 = _correspondences(n, n)
    g = torch.Generator().manual_seed(n)
    m = fit_capacity(n)
    scores = torch.rand((2048, m), generator=g)
    scores[:, n:] = -1.0
    idx = scores.topk(4, dim=-1).indices.numpy()
    H_gpu, inl_gpu = fit_homography_np(p0, p1, 3.0, device=dev,
                                       sample_idx=idx)
    H_cpu, inl_cpu = fit_homography_np(p0, p1, 3.0, device="cpu",
                                       sample_idx=idx)
    assert H_gpu is not None and H_cpu is not None
    np.testing.assert_allclose(H_gpu, H_cpu, rtol=1e-4,
                               atol=1e-4 * np.abs(H_cpu).max())
    np.testing.assert_array_equal(inl_gpu, inl_cpu)
    H_own, _ = fit_homography_np(p0, p1, 3.0, device=dev, seed=1)
    assert H_own is not None and np.isfinite(H_own).all()


def test_prewarm_then_match_batch_launch_k1_k2_per_forward(dev):
    """The bench model (random weights) with both GAM kernels at low coarse
    and fine thresholds, so that random weights leave matches: the
    prewarm's forward and each match_batch forward launch K1 and K2 four
    times each and no backward kernel."""
    import dataclasses

    import numpy as np

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher
    from geoformer_tpu_torch.eval.synthetic import textured_pair
    from geoformer_tpu_torch.models import GeoFormer

    base = bench_config(use_bf16=True)
    cfg = base.replace(match=dataclasses.replace(base.match, thr=1e-6),
                       fine_match=dataclasses.replace(base.fine_match,
                                                      thr=1e-3))
    model = weights.random_init(GeoFormer(cfg), seed=0)
    matcher = BatchedMatcher(cfg, model, batch_size=2, device=dev)
    pairs = [textured_pair((120, 160), s) for s in range(3)]
    gk.reset_launch_counts()
    matcher.prewarm([((120, 160), (120, 160))], log=lambda *a: None)
    assert gk.LAUNCHES["box_window_attention"] == 4
    assert gk.LAUNCHES["masked_kv_attention"] == 4
    gk.reset_launch_counts()
    res = matcher.match_batch([a for a, _ in pairs], [b for _, b in pairs],
                              return_geo=True)
    forwards = 2                                   # 3 pairs, batches of 2
    for name, count in gk.LAUNCHES.items():
        want = 4 * forwards if name in ("box_window_attention",
                                        "masked_kv_attention") else 0
        assert count == want, (name, count)
    assert len(res) == 3 and sum(len(r[0]) for r in res) > 0
    for mk0, mk1, conf, geo in res:
        assert mk0.shape == mk1.shape and conf.shape == mk0.shape[:1]
        for a in (mk0, mk1, conf, geo["H"]):
            assert np.isfinite(a).all()


def test_load_gray_reads_written_png_and_ppm(dev, tmp_path):
    """Files written here (an 8-bit grey PNG, a P6 PPM of a grey image)
    come back byte for byte; the card test runs where cv2 is absent."""
    import struct
    import zlib

    import numpy as np

    from geoformer_tpu_torch.eval.image_io import read_gray, read_size
    from geoformer_tpu_torch.eval.matcher import load_gray

    img = np.random.default_rng(0).integers(0, 256, (48, 64), np.uint8)
    raw = b"".join(b"\x00" + row.tobytes() for row in img)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    (tmp_path / "a.png").write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", 64, 48, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    (tmp_path / "b.ppm").write_bytes(
        b"P6\n64 48\n255\n" + np.repeat(img[..., None], 3, -1).tobytes())
    for name in ("a.png", "b.ppm"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(read_gray(path), img)
        assert read_size(path) == (48, 64)
        im, scale = load_gray(path, 480)
        assert scale == (1.0, 1.0)
        np.testing.assert_array_equal(im, img.astype(np.float32) / 255.0)


# The FIRE and ISC evaluation paths' shapes: FIRE at imsize 768 on square
# fundus images is a 96x96 coarse grid (L = S = 9216); ISC at 480 on a
# 720x640 (portrait) image resizes to 536x480, padded to 576x512: a 72x64
# grid.
EVAL_GRIDS = {"fire": (1, (96, 96)), "isc_portrait": (2, (72, 64))}


def _homography_centres(b, grid_hw, gen):
    """Each query's warped cell under a mild random perspective, some off
    the grid, as the GAM's cross layers give K1."""
    hg, wg = grid_hw
    yy, xx = torch.meshgrid(torch.arange(hg, dtype=torch.float64),
                            torch.arange(wg, dtype=torch.float64),
                            indexing="ij")
    out = []
    for _ in range(b):
        a = 1 + 0.1 * (torch.rand(4, generator=gen, dtype=torch.float64) - 0.5)
        t = 4 * (torch.rand(2, generator=gen, dtype=torch.float64) - 0.5)
        p = 2e-3 * (torch.rand(2, generator=gen, dtype=torch.float64) - 0.5)
        w = 1 + p[0] * xx + p[1] * yy
        cx = (a[0] * xx + (a[1] - 1) * yy + t[0]) / w
        cy = ((a[2] - 1) * xx + a[3] * yy + t[1]) / w
        out.append(torch.stack([cx, cy], -1).reshape(-1, 2))
    return torch.stack(out).floor().to(torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EVAL_GRIDS))
def test_box_kernel_at_the_fire_and_isc_shapes(dev, dtype, case):
    dt = getattr(torch, dtype)
    b, (hg, wg) = EVAL_GRIDS[case]
    gen = torch.Generator().manual_seed(5)
    q, k, v = (_rand(gen, (b, hg * wg, 4, 64), dt, dev) for _ in range(3))
    c = _homography_centres(b, (hg, wg), gen).to(dev)
    out, lse = gk.box_window_attention_fwd(q, k, v, c, (hg, wg))
    ref, ref_lse = gk.box_window_attention_plain(q, k, v, c, (hg, wg))
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol
    valid = ref_lse > -1e6
    assert (lse - ref_lse)[valid].abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EVAL_GRIDS))
def test_mka_kernel_at_the_fire_and_isc_shapes(dev, dtype, case):
    dt = getattr(torch, dtype)
    b, (hg, wg) = EVAL_GRIDS[case]
    gen = torch.Generator().manual_seed(6)
    q = _rand(gen, (b, hg * wg, 4, 64), dt, dev)
    k, v = (_rand(gen, (b, 1024, 4, 64), dt, dev) for _ in range(2))
    n = torch.randint(1, 1025, (b, 1), generator=gen)
    mask = (torch.arange(1024)[None] < n).to(dev)   # inliers packed first
    out = gk.masked_kv_attention(q, k, v, mask)
    ref = gk.masked_kv_attention_plain(q, k, v, mask)
    assert (out - ref).abs().max().item() <= 1e-4


# ------------------------------------------------------- the int8 paths --

INT8_CONVS = {  # name: (N, Cin, H, W, Cout, k, stride); K or N off 8
    "stem_7x7_s2": (4, 1, 48, 64, 128, 7, 2),
    "3x3_196": (2, 196, 15, 20, 196, 3, 1),
    "1x1_s2_down": (2, 128, 30, 40, 196, 1, 2),
}


@pytest.mark.parametrize("name", sorted(INT8_CONVS))
def test_int8_conv_on_the_card_is_the_exact_product(dev, name):
    """torch._int_mm on the card (operands zero-padded to its shape rules)
    gives the exact int32 accumulation (f64 on the card is exact below
    2^53), and int8_conv the dequantized result the CPU gives."""
    import torch.nn.functional as F

    from geoformer_tpu_torch.ops import quantize as qz

    nb, cin, h, w, cout, k, s = INT8_CONVS[name]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((nb, cin, h, w), generator=gen)
    wt = torch.randn((cout, cin, k, k), generator=gen)
    xq, _ = qz.quantize_symmetric(x.to(dev))
    wq, _ = qz.quantize_symmetric(wt.to(dev), dims=(1, 2, 3))
    got = qz.conv_int32(xq, wq, s, k // 2)
    exact = F.conv2d(xq.double(), wq.double(), stride=s,
                     padding=k // 2).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32 and torch.equal(got.double(), exact)
    card = qz.int8_conv(x.to(dev), wt.to(dev), s, k // 2).cpu()
    assert torch.equal(card, qz.int8_conv(x, wt, s, k // 2))


@pytest.mark.parametrize("rows", [5, 17, 4800])
def test_int8_dense_on_the_card_is_the_exact_product(dev, rows):
    from geoformer_tpu_torch.ops import quantize as qz

    gen = torch.Generator().manual_seed(8)
    x = torch.randn((rows, 196), generator=gen)
    wt = torch.randn((13, 196), generator=gen)
    xq, _ = qz.quantize_symmetric(x.to(dev))
    wq, _ = qz.quantize_symmetric(wt.to(dev), dims=(1,))
    got = qz.int_mm(xq, wq.t())
    assert torch.equal(got.double(), xq.double() @ wq.double().t())
    assert torch.equal(qz.int8_dense(x.to(dev), wt.to(dev)).cpu(),
                       qz.int8_dense(x, wt))


def test_int8_full_forward_launches_k1_k2_per_forward(dev):
    """The --int8-full model at a small size through the kernels: K1 and
    K2 4 times a forward, finite matches."""
    import dataclasses

    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import bench_config
    from geoformer_tpu_torch.models import GeoFormer

    cfg = bench_config(use_bf16=True)
    r = dataclasses.replace
    cfg = cfg.replace(backbone=r(cfg.backbone, int8=True),
                      coarse=r(cfg.coarse, int8=True),
                      fine=r(cfg.fine, int8=True), geo=r(cfg.geo, int8=True),
                      match=r(cfg.match, thr=1e-6, max_matches=256))
    model = weights.random_init(GeoFormer(cfg), 0).to(dev).eval()
    x = torch.rand((2, 96, 128, 1), generator=torch.Generator().manual_seed(9))
    gk.reset_launch_counts()
    with torch.no_grad():
        out = model(x.to(dev), x.to(dev),
                    generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["box_window_attention"] == 4
    assert gk.LAUNCHES["masked_kv_attention"] == 4
    assert torch.isfinite(out.fine.mkpts1).all()


# ------------------------------------------------ data parallelism, engine

def _bn_case():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 8, 12, 16)) * 3 + 2).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, g, rng.normal(size=8).astype(np.float32), \
        rng.normal(size=8).astype(np.float32)


def test_global_batchnorm_of_two_ranks_on_the_card(dev, tmp_path):
    """Two gloo ranks on the one card (CUDA tensors; NCCL refuses two
    ranks on one device), each with half of a batch of 4: the outputs, the
    input gradients, the summed parameter gradients and both ranks'
    running statistics equal one process's layer on the whole batch on
    the card, 1e-5 relative / 1e-6 absolute (the ranks sum the moments in
    another order); the metric gather goes through the host."""
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.models.layers import BatchNorm
    from torch_port_ranks import gather_and_bn

    inputs = _bn_case()
    per_rank = [dict(v=np.full(3, r, np.float32), scalar=np.float32(r))
                for r in range(2)]
    res = mesh.launch(gather_and_bn, 2, (per_rank, inputs, "cuda:0"),
                      init_dir=str(tmp_path), timeout=300)
    x, g, w, b = (torch.from_numpy(a).to(dev) for a in inputs)
    bn = BatchNorm(8).to(dev)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    x.requires_grad_(True)
    y = bn(x, train=True)
    (y * g).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in res]),
                               y.detach().cpu().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in res]),
                               x.grad.cpu().numpy(), **tol)
    np.testing.assert_allclose(res[0]["dw"] + res[1]["dw"],
                               bn.weight.grad.cpu().numpy(), **tol)
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(res[0][name], res[1][name])
        np.testing.assert_allclose(res[0][name],
                                   getattr(bn, name).cpu().numpy(), **tol)
    assert res[0]["gathered"]["v"].tolist() == [0, 0, 0, 1, 1, 1]
    assert res[1]["host_mean"] == 0.5


def _to(host: dict, device) -> "object":
    from geoformer_tpu_torch.engine.ba import BAProblem

    return BAProblem(**{k: torch.from_numpy(v).to(device)
                        for k, v in host.items()})


def _same_solution(got, ref):
    """Two BA solutions (cams, points, history) of one problem, compared
    where the problem fixes them: camera 0 alone is frozen, so the scene's
    scale along the baseline is free and f32 sums in another order (the
    card's, another rank count's) let Gauss-Newton settle a few 1e-3 apart
    along it (measured up to 1.8e-3 on cameras, 2e-2 on points, 1.2 % on
    the first step's cost). So: the first cost within 5e-2 relative, both
    final costs below 1e-3 px, the
    camera centres equal within 1e-3 after a similarity alignment, and the
    raw cameras within 2e-2."""
    from geoformer_tpu_torch.engine import trajectory as tr

    cams, _, hist = (torch.as_tensor(x).cpu() for x in got)
    rcams, _, rhist = (torch.as_tensor(x).cpu() for x in ref)
    np.testing.assert_allclose(hist[0], rhist[0], rtol=5e-2)
    assert float(hist[-1]) < 1e-3 and float(rhist[-1]) < 1e-3
    assert float(tr.ate_rmse(tr.camera_centers(cams),
                             tr.camera_centers(rcams))) < 1e-3
    np.testing.assert_allclose(cams, rcams, atol=2e-2)


def test_bundle_adjustment_on_the_card_matches_the_cpu(dev):
    """ba_solve (dense and Huber) and ba_solve_cg on CUDA tensors against
    the same calls on the CPU (_same_solution)."""
    from geoformer_tpu_torch.engine import ba
    from torch_port_ranks import ba_scene

    host = ba_scene(1, C=6, P=80)
    for fn, kw in ((ba.ba_solve, dict(iters=10)),
                   (ba.ba_solve, dict(iters=10, huber_delta=1.0)),
                   (ba.ba_solve_cg, dict(iters=6, cg_iters=16))):
        got = fn(_to(host, dev), **kw)
        assert all(x.device.type == "cuda" for x in got)
        _same_solution(got, fn(_to(host, "cpu"), **kw))


def test_pose_graph_and_umeyama_on_the_card_match_the_cpu(dev):
    """optimize_pose_graph on an 8-pose loop with noisy odometry and an
    exact closure, and align_umeyama / ate_rmse, on CUDA against the CPU
    (poses within 2e-4, the similarity within 1e-4)."""
    from geoformer_tpu_torch.engine import pose_graph as pg
    from geoformer_tpu_torch.engine import trajectory as tr
    from geoformer_tpu_torch.engine.lie import se3_exp

    rng = np.random.default_rng(3)
    step = se3_exp(torch.tensor([0, 0, 0.1, 0.5, 0.05, 0.0]))
    gt = [torch.eye(4)]
    for _ in range(7):
        gt.append(step @ gt[-1])
    noise = se3_exp(torch.from_numpy(rng.normal(0, 0.01, (7, 6))
                                     .astype(np.float32)))
    eT = [noise[i] @ gt[i + 1] @ torch.linalg.inv(gt[i]) for i in range(7)]
    eT.append(gt[7] @ torch.linalg.inv(gt[0]))
    init = [torch.eye(4)]
    for i in range(7):
        init.append(eT[i] @ init[i])
    arrays = dict(poses=torch.stack(init), edge_i=torch.tensor(
        list(range(7)) + [0]), edge_j=torch.tensor(list(range(1, 8)) + [7]),
        edge_T=torch.stack(eT), edge_valid=torch.ones(8, dtype=torch.bool),
        edge_weight=torch.tensor([1.0] * 7 + [10.0]))
    got, hist = pg.optimize_pose_graph(pg.PoseGraph(
        **{k: v.to(dev) for k, v in arrays.items()}), iters=10)
    ref, ref_hist = pg.optimize_pose_graph(pg.PoseGraph(**arrays), iters=10)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-4)
    np.testing.assert_allclose(hist.cpu().numpy(), ref_hist.numpy(),
                               rtol=1e-2, atol=1e-5)
    est = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    gt_c = 2 * est @ se3_exp(torch.tensor([0.1, 0.2, 0.7, 0, 0, 0]))[
        :3, :3].T + torch.tensor([1.0, 2.0, 3.0])
    for a, b in zip(tr.align_umeyama(est.to(dev), gt_c.to(dev)),
                    tr.align_umeyama(est, gt_c)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    assert float(tr.ate_rmse(est.to(dev), gt_c.to(dev))) < 1e-4


def test_sharded_bundle_adjustment_of_two_ranks_on_the_card(dev, tmp_path):
    """ba_solve_sharded and ba_solve_points_sharded at world size 2, two
    gloo ranks with CUDA tensors on the one card, against ba_solve and
    ba_solve_points_sharded in one process on the card (world size 1, its
    observations grouped by point into one slice), every rank alike
    (_same_solution)."""
    from geoformer_tpu_torch.core import mesh
    from geoformer_tpu_torch.engine import ba
    from torch_port_ranks import ba_scene, engine_solve

    hosts = [ba_scene(5), ba_scene(5, by_point_shards=2)]
    res = mesh.launch(engine_solve, 2, (hosts, 8, "cuda:0"),
                      init_dir=str(tmp_path), timeout=300)
    refs = (ba.ba_solve(_to(hosts[0], dev), iters=8),
            ba.ba_solve_points_sharded(_to(ba_scene(5, by_point_shards=1),
                                           dev), iters=8))
    for a, b in zip(res[0], res[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for got, ref in zip(res[0], refs):
        _same_solution(got, ref)
