"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker
and skips without a card. The file imports only torch and the port,
because the card's machine has no JAX; tests/conftest.py imports JAX, so
run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances: K1 writes out in the input type, so bf16 at 2e-2 abs (one bf16
ulp at |x| < 4) and f32 at 1e-5; its LSE at 1e-4; K2 writes f32 from the
same inputs, 1e-4 (order of the sums). The shapes here are small and not
multiples of the kernels' tiles; chip_smoke.py holds both kernels to their
plain versions at the main path's shapes and inside the model.
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
