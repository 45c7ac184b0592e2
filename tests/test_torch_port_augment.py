"""The port's photometric augmentation against geoformer_tpu/data/augment.py.

Every stage and stack gets the numbers JAX draws along its own key splits
(augment.py), injected as the stage's dict of draws, on the same images
(seeded numpy, [B, H, W, 1] as the pair data has them, and [B, H, W] for
the stages that take both).

Tolerances: the element-wise stages, the convolutions (5x5 and 7-tap, the
same taps summed in another order) and the vignette at 2e-6 abs (f32, a
few ulp of values <= 1). JPEG blocking: both packages compute the 8x8 DCT
in f32 in another order, so a coefficient whose quotient by the table
lies within ~1e-6 of a .5 boundary can round the other way; such a flip
moves its block's pixels by at most q * max|D_ij D_kl| / 255 = q / 4 / 255
for the largest table entry q. The test asserts all but 1 % of the pixels
within 1e-5 and every pixel within that bound, and that the coefficients
themselves agree before rounding (within 1e-3 grey levels).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu.data import augment as ja  # noqa: E402
from geoformer_tpu_torch.data import augment as ta  # noqa: E402
from torch_port_util import n, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

B, H, W = 3, 37, 45        # not multiples of 8: JPEG pads and crops
TOL = 2e-6


def _flat(x):
    return t(x).reshape(-1)


def jax_draws(stage, key, shape):
    """The draws of the JAX stage ``stage`` for ``key`` and image shape."""
    b = shape[0]
    u = jax.random.uniform
    if stage == "brightness_contrast":
        return jax_draws("bc(0.2)", key, shape)
    if stage.startswith("bc("):
        r = float(stage[3:-1])
        kb, kc = jax.random.split(key)
        return {"bright": _flat(u(kb, (b, 1, 1, 1), minval=-r, maxval=r)),
                "contrast": _flat(u(kc, (b, 1, 1, 1), minval=1 - r,
                                    maxval=1 + r))}
    if stage.startswith("gamma"):
        lo, hi = (1.0, 2.0) if stage == "gamma_dark" else (0.8, 1.2)
        return {"gamma": _flat(u(key, (b, 1, 1, 1), minval=lo, maxval=hi))}
    if stage == "noise":
        return {"noise": t(jax.random.normal(key, shape))}
    if stage == "motion_blur":
        return {"angle": t(u(key, (b,), minval=0, maxval=jnp.pi))}
    if stage == "shot_read_noise":
        kg, kr, kn = jax.random.split(key, 3)

        def logu(k, lo, hi):
            return _flat(jnp.exp(u(k, (b, 1, 1, 1), minval=jnp.log(lo),
                                   maxval=jnp.log(hi))))
        return {"gain": logu(kg, 2e-4, 4e-3), "read": logu(kr, 1e-5, 4e-4),
                "noise": t(jax.random.normal(kn, shape))}
    if stage == "jpeg":
        return {"quality": _flat(u(key, (b, 1, 1, 1, 1), minval=30,
                                   maxval=90))}
    if stage == "vignette":
        ks, kc = jax.random.split(key)
        return {"strength": _flat(u(ks, (b, 1, 1), minval=0.0, maxval=0.6)),
                "center": t(u(kc, (b, 2, 1, 1), minval=-0.2,
                              maxval=0.2)).reshape(b, 2)}
    if stage == "defocus":
        return {"sigma": _flat(u(key, (b, 1), minval=0.0, maxval=1.6))}
    if stage == "dark":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"brightness_contrast": jax_draws("bc(0.4)", k1, shape),
                "gamma": jax_draws("gamma_dark", k2, shape),
                "noise": jax_draws("noise", k3, shape)}
    if stage == "mobile":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"motion_blur": jax_draws("motion_blur", k1, shape),
                "brightness_contrast": jax_draws("bc(0.2)", k2, shape),
                "noise": jax_draws("noise", k3, shape)}
    if stage == "sensor":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return {"defocus": jax_draws("defocus", k1, shape),
                "vignette": jax_draws("vignette", k2, shape),
                "noise": jax_draws("shot_read_noise", k3, shape),
                "jpeg": jax_draws("jpeg", k4, shape)}
    raise KeyError(stage)


def _images(seed, ndim=4):
    rng = np.random.default_rng(seed)
    img = rng.random((B, H, W)).astype(np.float32)
    img[0, :, : W // 2] = 0.5                   # a flat region
    return img[..., None] if ndim == 4 else img


# (JAX function, port function, draws stage)
STAGES = {
    "brightness_contrast": (ja.random_brightness_contrast,
                            ta.random_brightness_contrast,
                            "brightness_contrast"),
    "gamma": (ja.random_gamma, ta.random_gamma, "gamma"),
    "gaussian_noise": (ja.gaussian_noise, ta.gaussian_noise, "noise"),
    "motion_blur": (ja.motion_blur, ta.motion_blur, "motion_blur"),
    "shot_read_noise": (ja.shot_read_noise, ta.shot_read_noise,
                        "shot_read_noise"),
    "vignette": (ja.vignette, ta.vignette, "vignette"),
    "defocus_blur": (ja.defocus_blur, ta.defocus_blur, "defocus"),
    "dark_aug": (ja.dark_aug, ta.dark_aug, "dark"),
    "mobile_aug": (ja.mobile_aug, ta.mobile_aug, "mobile"),
}


@pytest.mark.parametrize("name", list(STAGES))
@pytest.mark.parametrize("seed", [0, 1])
def test_stage_matches_jax(name, seed):
    jfn, tfn, stage = STAGES[name]
    img = _images(seed)
    key = jax.random.key(seed + 10)
    ref = np.asarray(jfn(key, jnp.asarray(img)))
    got = tfn(t(img), draws=jax_draws(stage, key, img.shape))
    assert got.shape == img.shape
    np.testing.assert_allclose(n(got), ref, rtol=0, atol=TOL, err_msg=name)
    assert not np.array_equal(n(got), img)      # the stage changed them


@pytest.mark.parametrize("name", ["gaussian_noise", "vignette",
                                  "defocus_blur"])
def test_stage_on_three_dim_images_matches_jax(name):
    jfn, tfn, stage = STAGES[name]
    img = _images(2, ndim=3)
    key = jax.random.key(5)
    ref = np.asarray(jfn(key, jnp.asarray(img)))
    got = tfn(t(img), draws=jax_draws(stage, key, img.shape))
    assert got.shape == img.shape
    np.testing.assert_allclose(n(got), ref, rtol=0, atol=TOL, err_msg=name)


def test_defocus_keeps_sharp_samples_exactly():
    img = _images(3)
    draws = {"sigma": torch.tensor([0.05, 0.099, 1.2])}
    out = n(ta.defocus_blur(t(img), draws=draws))
    np.testing.assert_array_equal(out[:2], img[:2])
    assert not np.array_equal(out[2], img[2])


def _jpeg_bound(quality):
    q = float(np.min(quality))
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    return np.floor((121 * scale + 50.0) / 100.0) / 4 / 255


def _assert_jpeg_close(got, ref, quality):
    err = np.abs(n(got) - ref)
    assert (err > 1e-5).mean() < 0.01, (err > 1e-5).mean()
    assert err.max() <= _jpeg_bound(quality), err.max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jpeg_blocking_matches_jax(seed):
    img = _images(seed)
    key = jax.random.key(seed + 20)
    draws = jax_draws("jpeg", key, img.shape)
    ref = np.asarray(ja.jpeg_blocking(key, jnp.asarray(img)))
    got = ta.jpeg_blocking(t(img), draws=draws)
    assert got.shape == img.shape
    _assert_jpeg_close(got, ref, n(draws["quality"]))
    # the coefficients before rounding, in grey levels
    x = np.pad(img[..., 0], ((0, 0), (0, (-H) % 8), (0, (-W) % 8)),
               mode="edge")
    blocks = x.reshape(B, -1, 8, x.shape[2] // 8, 8).transpose(
        0, 1, 3, 2, 4) * 255.0 - 128.0
    D = np.asarray(ja._dct8_matrix())
    ref_coef = np.einsum("ij,bhwjk,lk->bhwil", D, blocks, D)
    got_coef = n(ta.dct8_matrix() @ t(blocks) @ ta.dct8_matrix().T)
    np.testing.assert_allclose(got_coef, ref_coef, rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(ta.dct8_matrix()), D, rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_sensor_aug_matches_jax(seed):
    img = _images(seed)
    key = jax.random.key(seed + 30)
    draws = jax_draws("sensor", key, img.shape)
    ref = np.asarray(ja.sensor_aug(key, jnp.asarray(img)))
    got = ta.sensor_aug(t(img), draws=draws)
    _assert_jpeg_close(got, ref, n(draws["jpeg"]["quality"]))


def test_draws_from_a_generator():
    img = t(_images(0))
    for name in ("sensor", "dark", "mobile"):
        aug = ta.build_augmentor(name)
        a = aug(img, torch.Generator().manual_seed(3))
        b = aug(img, torch.Generator().manual_seed(3))
        assert torch.equal(a, b) and a.shape == img.shape
        assert a.min() >= 0 and a.max() <= 1
    d = ta.sensor_aug_draws(img.shape, torch.Generator().manual_seed(0))
    q = d["jpeg"]["quality"]
    assert q.shape == (B,) and (q >= 30).all() and (q < 90).all()
    g = ta.shot_read_noise_draws((500, 1, 1, 1),
                                 torch.Generator().manual_seed(0))["gain"]
    assert g.min() >= 2e-4 and g.max() <= 4e-3
    assert torch.equal(ta.build_augmentor(None)(img), img)
    with pytest.raises(ValueError):
        ta.build_augmentor("fisheye")
