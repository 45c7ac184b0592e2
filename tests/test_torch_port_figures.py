"""The GAM window view and the figure files of ``cli infer --draw
--draw-geo`` (utils/plotting.py) against the JAX package's matplotlib
figures.

geo_window_points returns what make_geo_window_figure draws: its segments
(the LineCollection) and its two scatters (window points, then queries),
read back from the figure's axes; both are float64 computations of the
same formulas, held equal within 1e-9 px. The numpy renderer is not
pixel-equal to matplotlib (see the module's docstring); its canvas, colours
and file round trip are checked on their own. ``cli infer`` writes both
figures as PNG files that the port's decoder reads back at the canvas's
size, with the JAX figure's text in an iTXt chunk.
"""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu_torch import cli  # noqa: E402
from geoformer_tpu_torch.data.synthetic import procedural_texture  # noqa
from geoformer_tpu_torch.eval import hpatches_synth as hs  # noqa: E402
from geoformer_tpu_torch.eval.image_io import read_gray  # noqa: E402
from geoformer_tpu_torch.eval.parity_drill import (  # noqa: E402
    fabricate_checkpoint,
)
from geoformer_tpu_torch.utils import plotting as pp  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"

# (H, img0 shape, img1 shape, stride)
CASES = {
    "near_identity": (np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, 2.0],
                                [1e-5, 0.0, 1.0]]), (120, 160), (120, 160),
                      7),
    "perspective": (np.array([[0.9, 0.1, 20.0], [-0.05, 1.1, -8.0],
                              [4e-4, -2e-4, 1.0]]), (96, 128), (112, 144), 3),
    "zoom_out_of_bounds": (np.diag([2.0, 2.0, 1.0]), (160, 120), (96, 128),
                           5),
    "shifted_off": (np.array([[1.0, 0, 150.0], [0, 1, 0], [0, 0, 1]]),
                    (80, 160), (80, 160), 1),
    "default_stride": (np.eye(3), (480, 640), (480, 640), 777),
}


def _text_chunks(data: bytes):
    out, pos = {}, 8
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body)
        if kind == b"iTXt":
            key, rest = body.split(b"\0", 1)
            out[key.decode()] = rest[4:].decode("utf-8")
        pos += 12 + n
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_geo_window_points_equal_the_jax_figure(case):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from geoformer_tpu.utils.plotting import make_geo_window_figure

    H, hw0, hw1, stride = CASES[case]
    rng = np.random.default_rng(0)
    img0, img1 = rng.random(hw0), rng.random(hw1)
    fig = make_geo_window_figure(img0, img1, H, True, scale=8,
                                 window_size=5, stride=stride)
    qs, pts, segs = pp.geo_window_points(H, hw0, hw1, 8, 5, stride)
    ax = fig.axes[0]
    plt.close(fig)
    if not len(segs):
        assert not ax.collections
        return
    lines, win, query = ax.collections
    np.testing.assert_allclose(np.asarray(lines.get_segments()), segs,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(win.get_offsets()), pts, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(query.get_offsets()), qs, rtol=0,
                               atol=1e-9)
    assert tuple(lines.get_colors()[0]) == (0.0, 1.0, 0.0, 0.08)


def test_the_window_view_draws_its_points_in_their_colours():
    H, hw0, hw1, stride = CASES["near_identity"]
    rng = np.random.default_rng(1)
    img0, img1 = rng.random(hw0) * 0.5, rng.random(hw1) * 0.5
    rgb = pp.render_geo_windows(img0, img1, H, True, 8, 5, stride)
    assert rgb.shape == (120, 330, 3) and rgb.dtype == np.uint8
    qs, pts, _ = pp.geo_window_points(H, hw0, hw1, 8, 5, stride)
    for x, y in np.rint(qs).astype(int):
        assert tuple(rgb[y, x]) == (0, 255, 255)           # cyan queries
    assert len(pts) > len(qs)
    assert (rgb == [0, 255, 0]).all(-1).any()               # lime window
    canvas, _ = pp.compose_pair(img0, img1)
    bare = pp.render_geo_windows(img0, img1, H, False)
    np.testing.assert_array_equal(
        bare, np.rint(np.repeat(canvas[..., None], 3, -1).astype(np.float64)
                      * 255).astype(np.uint8))


@pytest.mark.parametrize("text", [None, pp.NO_H_TEXT])
def test_write_png_round_trips_with_its_text(tmp_path, text):
    rgb = (np.random.default_rng(2).random((13, 21, 3)) * 255).astype(
        np.uint8)
    path = tmp_path / "f.png"
    pp.write_png(str(path), rgb, text=text)
    grey = read_gray(str(path))
    assert grey.shape == (13, 21)
    data = path.read_bytes()
    assert _text_chunks(data) == ({} if text is None
                                  else {"Description": text})
    assert data.endswith(b"IEND\xaeB`\x82")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("infer_figs")
    rng = np.random.default_rng(4)
    base = procedural_texture(rng, (180, 240))
    warped = hs.warp_perspective(base, hs._corner_h(rng, (180, 240),
                                                    (180, 240), 0.05),
                                 (180, 240))
    for name, img in (("a.png", base), ("b.png", warped)):
        pp.write_png(str(d / name), np.rint(img * 255).astype(np.uint8))
    return d


def test_cli_infer_draws_both_figures_from_a_torch_checkpoint(files, capsys):
    if not CKPT.is_file():
        pytest.skip("trained checkpoint not in this checkout")
    ckpt = files / "x.ckpt"
    fabricate_checkpoint(str(CKPT), str(ckpt))
    m, g = files / "m.png", files / "g.png"
    cli.main(["infer", str(files / "a.png"), str(files / "b.png"), "--ckpt",
              str(ckpt), "--imsize", "120", "--device", "cpu", "--draw",
              str(m), "--draw-geo", str(g)])
    out = capsys.readouterr().out.splitlines()
    n = int(out[0].split()[0])
    assert n > 50 and "has_H=True" in out[0]
    assert out[1:] == [f"figure -> {m}", f"GAM window figure -> {g}"]
    canvas = (120, 160 + 10 + 160)
    assert read_gray(str(m)).shape == read_gray(str(g)).shape == canvas
    assert _text_chunks(m.read_bytes()) == {
        "Description": f"GeoFormer-TPU\n{n} matches"}
    assert _text_chunks(g.read_bytes()) == {}


def test_cli_infer_without_a_homography_draws_the_bare_canvas(files,
                                                              capsys):
    g = files / "bare.png"
    cli.main(["infer", str(files / "a.png"), str(files / "b.png"),
              "--imsize", "64", "--device", "cpu", "--draw-geo", str(g)])
    out = capsys.readouterr().out.splitlines()
    assert "has_H=False" in out[0] and out[1] == pp.NO_H_TEXT
    assert _text_chunks(g.read_bytes()) == {"Description": pp.NO_H_TEXT}
    got = read_gray(str(g))
    assert got.shape == (64, 80 + 10 + 80)          # 180x240 at imsize 64
    assert (got[:, 80:90] == 255).all()                    # the white gap
