"""Port kernels K1 (box-window attention) and K2 (masked-KV attention).

On the CPU the wrappers compute their plain versions; those are held here
against the Pallas kernels themselves in interpret mode (the JAX package's
own way of running them off the TPU). The CUDA kernels are held against the
plain versions on the card by tests/test_torch_port_cuda.py and by
chip_smoke.py.

Tolerances: f32 at 1e-5 abs / 1e-4 rel (the same softmax summed in another
order); the LSE of in-grid rows at 1e-4 abs (|lse| < 20).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.ops.pallas_attention import (  # noqa: E402
    _box_forward,
    _mka_forward,
    box_attention_reference,
)
from geoformer_tpu_torch.ops import gam_kernels as gk  # noqa: E402
from torch_port_util import assert_close, n, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

FILL = -1e8


def _box_inputs(seed, b=2, hg=6, wg=8, h=2, d=4, lo=-4, hi=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    s = hg * wg
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(dtype) for _ in range(3))
    cx = rng.integers(lo, wg + hi, size=(b, s))
    cy = rng.integers(lo, hg + hi, size=(b, s))
    centers = np.stack([cx, cy], -1).astype(np.int32)
    # one q tile (8 rows) fully off the grid, one row partly off
    centers[0, 8:16] = (-10, -10)
    centers[1, 3] = (-1, 2)
    return q, k, v, centers, (hg, wg)


def _offgrid(centers, grid_hw, r=2):
    hg, wg = grid_hw
    cx, cy = centers[..., 0], centers[..., 1]
    return (cx + r < 0) | (cx - r > wg - 1) | (cy + r < 0) | (cy - r > hg - 1)


@pytest.mark.parametrize("force_tiled", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_plain_matches_pallas_interpret(force_tiled, seed):
    q, k, v, centers, grid = _box_inputs(seed)
    ref_out, ref_lse = _box_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(centers),
        grid, 2, FILL, 8, 8, interpret=True, force_tiled=force_tiled)
    out, lse = gk.box_window_attention_fwd(t(q), t(k), t(v), t(centers),
                                           grid, 2)
    assert out.dtype == torch.float32 and lse.shape == (2, 48, 2)
    assert_close(out, ref_out, 1e-4, 1e-5, "out")
    off = _offgrid(centers, grid)
    assert off.any() and (~off).any()
    # in-grid rows: the LSE of the in-box logits
    assert_close(n(lse)[~off], np.asarray(ref_lse)[~off], 1e-5, 1e-4, "lse")
    # off-grid rows: out exactly 0, LSE of an all-masked row
    assert (n(out)[off] == 0).all()
    empty = np.float32(0.5 * FILL) + np.float32(np.log(48))
    assert (n(lse)[off] == empty).all()
    if not force_tiled:
        # the whole-KV kernel computes exactly that value for them
        np.testing.assert_array_equal(np.asarray(ref_lse)[off], n(lse)[off])
    else:
        # the tiled kernel reports it where every kv tile of the row's q tile
        # was skipped (rows 8..15 of batch 0 form one off-grid q tile)
        np.testing.assert_array_equal(np.asarray(ref_lse)[0, 8:16],
                                      n(lse)[0, 8:16])


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_box_plain_matches_reference_radius(radius):
    q, k, v, centers, grid = _box_inputs(3, hg=5, wg=7, lo=-6, hi=6)
    ref = box_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(centers), grid,
                                  radius)
    out, _ = gk.box_window_attention_plain(t(q), t(k), t(v), t(centers), grid,
                                           radius)
    assert_close(out, ref, 1e-4, 1e-5)


def test_box_plain_keeps_bf16_out_and_f32_lse():
    q, k, v, centers, grid = _box_inputs(4)
    out, lse = gk.box_window_attention_fwd(t(q, torch.bfloat16),
                                           t(k, torch.bfloat16),
                                           t(v, torch.bfloat16), t(centers),
                                           grid)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = gk.box_window_attention_plain(
        t(q, torch.bfloat16).float(), t(k, torch.bfloat16).float(),
        t(v, torch.bfloat16).float(), t(centers), grid)
    # out rounds an f32 result to bf16: within one bf16 ulp (2^-6 at |x|<4)
    assert_close(out, ref, 0, 2e-2)


def _mka_inputs(seed, b=3, l=24, s=8, h=2, d=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, l, h, d)).astype(dtype)
    k, v = (rng.normal(size=(b, s, h, d)).astype(dtype) for _ in range(2))
    mask = rng.random((b, s)) > 0.4
    mask[-1] = False          # RANSAC found no inliers in this batch row
    mask[0, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mka_plain_matches_pallas_interpret(seed):
    q, k, v, mask = _mka_inputs(seed)
    ref = _mka_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask), FILL, 16, interpret=True)
    out = gk.masked_kv_attention(t(q), t(k), t(v), t(mask))
    assert_close(out, ref, 1e-4, 1e-5)


def test_mka_all_masked_row_is_mean_of_values():
    q, k, v, mask = _mka_inputs(5)
    out = n(gk.masked_kv_attention(t(q), t(k), t(v), t(mask)))
    np.testing.assert_allclose(out[-1], np.broadcast_to(
        v[-1].mean(axis=0), out[-1].shape), rtol=1e-5, atol=1e-6)
    assert np.isfinite(out).all()


def test_mka_bf16_inputs_give_f32_matching_pallas():
    q, k, v, mask = _mka_inputs(6)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = _mka_forward(qb, kb, vb, jnp.asarray(mask), FILL, 16,
                       interpret=True)
    out = gk.masked_kv_attention(t(np.asarray(qb.astype(jnp.float32)),
                                   torch.bfloat16),
                                 t(np.asarray(kb.astype(jnp.float32)),
                                   torch.bfloat16),
                                 t(np.asarray(vb.astype(jnp.float32)),
                                   torch.bfloat16), t(mask))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_close(out, ref, 1e-4, 1e-5)


def test_cpu_wrappers_do_not_count_launches():
    gk.reset_launch_counts()
    q, k, v, centers, grid = _box_inputs(7)
    gk.box_window_attention_fwd(t(q), t(k), t(v), t(centers), grid)
    q, k, v, mask = _mka_inputs(7)
    gk.masked_kv_attention(t(q), t(k), t(v), t(mask))
    assert set(gk.LAUNCHES) >= {"box_window_attention",
                                "masked_kv_attention"}
    assert not any(gk.LAUNCHES.values()), gk.LAUNCHES


@pytest.mark.parametrize("fn", ["box", "mka"])
def test_wrapper_raises_on_device_without_kernel(fn):
    """The ops have a kernel for cuda, the plain version for cpu and a fake
    (output shapes only) for meta; any other backend (a sparse CPU tensor
    here) raises rather than falling back."""
    sparse = torch.zeros((1, 8, 1, 64)).to_sparse()
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        if fn == "box":
            gk.box_window_attention_fwd(
                sparse, sparse, sparse,
                torch.zeros((1, 8, 2), dtype=torch.int32).to_sparse(),
                (2, 4))
        else:
            gk.masked_kv_attention(sparse, sparse, sparse,
                                   torch.ones((1, 8)).to_sparse())