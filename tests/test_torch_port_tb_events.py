"""The port's TensorBoard event files and match figures.

The event files are read back by TensorBoard's own reader (its record
reader checks both CRCs of every record) and by the port's; the PNG of an
image summary by cv2. A run_training with tensorboard, val_every and
log_figures writes, as the JAX loop does through tensorboardX, every key
but ``step`` of each metrics line as a scalar at its step (the scalars
equal metrics.jsonl in f32) and the validation batch's match figure under
``val/matches``, its text ("step N", "n matches") as the summary's
description. error_colors, dynamic_alpha and compose_pair are held to the
JAX package's copies exactly; render_matches, which draws without
matplotlib, by what it must draw.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
tb = pytest.importorskip("tensorboard")

import cv2  # noqa: E402
from tensorboard import data_compat  # noqa: E402
from tensorboard.backend.event_processing.event_file_loader import (  # noqa: E402
    EventFileLoader,
)
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (  # noqa: E402
    masked_crc32c as tb_masked_crc32c,
)

from geoformer_tpu.utils import plotting as jplot  # noqa: E402
from geoformer_tpu_torch.train.loop import run_training  # noqa: E402
from geoformer_tpu_torch.utils import plotting, tb_events  # noqa: E402
from torch_port_util import port_config, small_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

# the keys the JAX loop logs (train step scalars + imgs_per_s; val step)
TRAIN_TAGS = {"loss", "loss_c", "loss_d", "loss_f", "num_inliers",
              "num_matches", "grad_norm", "lr", "imgs_per_s"}
VAL_TAGS = {"val_loss", "val_loss_c", "val_loss_d", "val_loss_f",
            "val_corner_err_median", "val_fit_rate", "val_num_matches"}


def _tb_events(path):
    return list(EventFileLoader(str(path)).Load())


def test_crc_matches_tensorboard():
    rng = np.random.default_rng(0)
    for size in (0, 1, 8, 1000):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert tb_events.masked_crc32c(data) == tb_masked_crc32c(data)


def test_scalars_and_images_read_back(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (30, 41, 3), np.uint8)
    with tb_events.EventWriter(str(tmp_path)) as w:
        w.add_scalar("loss", 1.25, 3)
        w.add_scalar("lr", 1e-4, 4)
        w.add_image("val/matches", img, 4, description="step 4\n7 matches")
    (path,) = tmp_path.iterdir()
    assert path.name.startswith("events.out.tfevents.")
    events = _tb_events(path)
    assert events[0].file_version == "brain.Event:2"
    vals = [(e.step, data_compat.migrate_value(e.summary.value[0]))
            for e in events[1:]]
    assert [(s, v.tag) for s, v in vals] == [(3, "loss"), (4, "lr"),
                                             (4, "val/matches")]
    assert vals[0][1].tensor.float_val[0] == 1.25
    assert vals[1][1].tensor.float_val[0] == np.float32(1e-4)
    image = vals[2][1]
    assert image.metadata.plugin_data.plugin_name == "images"
    assert image.metadata.summary_description == "step 4\n7 matches"
    w_, h_, png = image.tensor.string_val
    assert (int(w_), int(h_)) == (41, 30)
    dec = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(dec[..., ::-1], img)      # BGR
    ours = tb_events.read_events(str(path))
    assert ours[0]["file_version"] == "brain.Event:2"
    assert ours[1]["values"][0] == {"tag": "loss", "simple_value": 1.25}
    assert ours[3]["values"][0]["image"]["png"] == png


def test_read_events_finds_a_bad_crc(tmp_path):
    with tb_events.EventWriter(str(tmp_path)) as w:
        w.add_scalar("loss", 1.0, 1)
    (path,) = tmp_path.iterdir()
    data = bytearray(path.read_bytes())
    data[-6] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        tb_events.read_events(str(path))


def test_grey_png_decodes(tmp_path):
    img = np.arange(12 * 7, dtype=np.uint8).reshape(12, 7)
    dec = cv2.imdecode(np.frombuffer(tb_events.encode_png(img), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(dec, img)


def test_run_training_logs_what_the_jax_loop_logs(tmp_path):
    h, w = 64, 80
    run_training(steps=2, batch_size=2, image_hw=(h, w),
                 ckpt_dir=str(tmp_path), log_every=1, val_every=2,
                 tensorboard=True, log_figures=True,
                 model_cfg=port_config(small_config()), bank_size=3,
                 device="cpu")
    (path,) = (tmp_path / "tb").iterdir()
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2, 2]
    scalars, images = {}, []
    for e in _tb_events(path)[1:]:
        v = data_compat.migrate_value(e.summary.value[0])
        if v.metadata.plugin_data.plugin_name == "images":
            images.append((e.step, v))
        else:
            scalars[(v.tag, e.step)] = v.tensor.float_val[0]
    assert {tag for tag, _ in scalars} == TRAIN_TAGS | VAL_TAGS
    for m in lines:
        for k, v in m.items():
            if k != "step":
                assert scalars.pop((k, m["step"])) == np.float32(v), k
    assert not scalars
    (step, image), = images
    assert step == 2 and image.tag == "val/matches"
    n_matches = int(image.metadata.summary_description.split("\n")[1]
                    .split()[0])
    assert image.metadata.summary_description.startswith("step 2\n")
    assert n_matches >= 0
    width, height, png = image.tensor.string_val
    assert (int(width), int(height)) == (2 * w + 10, h)
    assert cv2.imdecode(np.frombuffer(png, np.uint8),
                        cv2.IMREAD_UNCHANGED).shape == (h, 2 * w + 10, 3)


def test_figure_helpers_are_the_jax_ones():
    errs = np.array([0.0, 1.0, 3.0, 10.0])
    np.testing.assert_array_equal(plotting.error_colors(errs, 3.0, 0.5),
                                  jplot.error_colors(errs, 3.0, 0.5))
    for k in (0, 1, 150, 300, 999, 1500, 5000):
        assert plotting.dynamic_alpha(k) == jplot.dynamic_alpha(k)
    a = np.random.default_rng(0).random((20, 30)).astype(np.float32)
    b = np.random.default_rng(1).random((25, 16)).astype(np.float32)
    for got, ref in zip(plotting.compose_pair(a, b), jplot.compose_pair(a, b)):
        np.testing.assert_array_equal(got, ref)


def test_render_matches_draws_segments_and_dots():
    img0 = np.full((40, 50), 0.5, np.float32)
    img1 = np.full((40, 50), 0.25, np.float32)
    rgb = plotting.render_matches(img0, img1, np.array([[5.0, 10.0]]),
                                  np.array([[20.0, 10.0]]))
    assert rgb.shape == (40, 110, 3) and rgb.dtype == np.uint8
    # one match (alpha 0.998): a green row from (5, 10) to (80, 10)
    a = plotting.dynamic_alpha(1)
    green = 255 * (a * np.array([0, 1, 0]) + (1 - a) * 0.25)
    np.testing.assert_allclose(rgb[10, 61:78], np.tile(green, (17, 1)),
                               atol=1)
    np.testing.assert_allclose(rgb[9:12, 79:82].reshape(-1, 3),
                               np.tile(green, (9, 1)), atol=1)
    assert (rgb[30, :50] == 128).all() and (rgb[30, 60:] == 64).all()
    assert (rgb[30, 50:60] == 255).all()                  # the gap
    # many matches: translucent, blended over the grey
    n = 600
    p = np.stack([np.full(n, 5.0), np.linspace(0, 39, n)], -1)
    rgb = plotting.render_matches(img0, img1, p, p)
    keep = (1 - plotting.dynamic_alpha(n)) ** (np.rint(p[:, 1]) == 20).sum()
    np.testing.assert_allclose(rgb[20, 30], 255 * np.array(
        [0.5 * keep, 1 - 0.5 * keep, 0.5 * keep]), atol=1)
