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
the value). The shapes here are small and not multiples of the kernels'
tiles; chip_smoke.py holds every kernel to its plain version at the main
path's shapes and inside the model.
"""

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
    out, lse = gk.box_window_attention(q, k, v, c, (hg, wg))
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
    out, _ = gk.box_window_attention(q, k, v, c, (hg, wg))
    (out.sum() + gk.masked_kv_attention(q, k, v, mask).sum()).backward()
    assert all(n == 1 for n in gk.LAUNCHES.values()), gk.LAUNCHES
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
