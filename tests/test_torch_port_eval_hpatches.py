"""The port's HPatches driver against the JAX one on the CPU.

A synthetic fixture in the HPatches layout is written into tmp_path: two
sequences, ``i_*`` (near-identity homographies, brightness changes) and
``v_*`` (perspective), each with 1.ppm ... 6.ppm (P6) and H_1_k, at two
sizes (the v sequence's images 4-6 lie on larger canvases, one of them
portrait, so that the sequence pads into a bucket no single image lands
in). Both drivers run the trained checkpoint at imsize 120, each with its
own RANSAC draws.

Tolerances: the same output keys, n_pairs, est_failed and prewarm census
exactly; each pair's corner error within 0.5 px where both packages are
under 3 px; every AUC within 0.02. Measured: corner errors within 1e-4 px,
AUCs within 1e-5, the same mean matches and inlier rate.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu.config import (  # noqa: E402
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
)
from geoformer_tpu.eval import hpatches as j_hpatches  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.eval import hpatches  # noqa: E402
from geoformer_tpu_torch.eval.selfcheck import load_model  # noqa: E402
from torch_port_util import port_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
IMSIZE = 120


def write_ppm(path: Path, grey: np.ndarray, tint=(1.0, 0.96, 0.9)) -> None:
    """A P6 file of a [h, w] image in [0, 1], tinted per channel."""
    rgb = np.clip(np.round(grey[..., None] * np.array(tint) * 255), 0, 255)
    h, w = grey.shape
    path.write_bytes(b"P6\n%d %d\n255\n" % (w, h)
                     + rgb.astype(np.uint8).tobytes())


def write_hpatches(root: Path, seed: int = 0) -> None:
    """The fixture: i_fixture at 240x320, v_fixture at 200x300 with its
    images 4 and 5 on a 216x340 canvas and image 6 on a 300x220 one."""
    rng = np.random.default_rng(seed)
    for name, hw, big in (("i_fixture", (240, 320), {}),
                          ("v_fixture", (200, 300),
                           {4: (216, 340), 5: (216, 340), 6: (300, 220)})):
        d = root / name
        d.mkdir(parents=True)
        base = native.native_textures(1, *hw, seed=seed + len(name))[0]
        write_ppm(d / "1.ppm", base)
        h, w = hw
        for k in range(2, 7):
            if name[0] == "i":
                H = np.array([[1.0, 0.0, rng.uniform(-3, 3)],
                              [0.0, 1.0, rng.uniform(-3, 3)],
                              [0.0, 0.0, 1.0]])
            else:
                src = np.array([[0, 0], [w, 0], [w, h], [0, h]], float)
                dst = src + rng.uniform(-0.12, 0.12, (4, 2)) * [w, h]
                H = _homography(src, dst)
            canvas = big.get(k, hw)
            padded = np.zeros((max(h, canvas[0]), max(w, canvas[1])),
                              np.float32)
            padded[:h, :w] = base
            padded = padded[:canvas[0], :canvas[1]]
            img = native.native_warp(padded[None], H[None])[0]
            gain = rng.uniform(0.6, 1.3) if name[0] == "i" else 1.0
            write_ppm(d / f"{k}.ppm", np.clip(img * gain, 0, 1))
            np.savetxt(d / f"H_1_{k}", H)


def _homography(src, dst):
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    H = np.linalg.svd(np.array(A))[2][-1].reshape(3, 3)
    return H / H[2, 2]


def _run(driver, module, *args, **kw):
    """driver's result, its log lines and the per-pair corner errors (the
    first list handed to ``module.correctness``, all pairs in order)."""
    seen, lines = [], []
    real = module.correctness

    def spy(errors, thresholds):
        seen.append(list(errors))
        return real(errors, thresholds)

    module.correctness = spy
    try:
        out = driver(*args, imsize=IMSIZE, log=lines.append, **kw)
    finally:
        module.correctness = real
    return out, lines, np.array(seen[0])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("hpatches")
    write_hpatches(root)
    jcfg = GeoFormerConfig(match=MatchConfig(thr=0.2, max_matches=1024),
                           geo=GeoModuleConfig(ransac_iters=256,
                                               max_inliers=1024))
    ref = _run(j_hpatches.eval_hpatches, j_hpatches,
               load_variables(str(CKPT)), jcfg, str(root))
    pcfg = port_config(jcfg)
    got = _run(hpatches.eval_hpatches, hpatches,
               load_model(pcfg, str(CKPT), "cpu"), pcfg, str(root),
               device="cpu")
    return ref, got


def test_same_keys_counts_and_census(run):
    (ref, ref_log, _), (got, got_log, _) = run
    assert set(got) == set(ref)
    assert got["n_pairs"] == ref["n_pairs"] == 10
    assert got["est_failed"] == ref["est_failed"] == 0
    # the census: one bucket a sequence, the v sequence's padded
    assert got_log[0] == ref_log[0] == \
        "prewarm: 2 bucket(s): 128x192 (x1), 192x192 (x1)"
    assert set(got["mma_a"]) == set(ref["mma_a"]) == set(range(1, 16))


def test_corner_errors_and_aucs_agree(run):
    (ref, _, ref_d), (got, _, got_d) = run
    both = (ref_d < 3) & (got_d < 3)
    assert both.sum() >= 8
    assert np.abs(ref_d - got_d)[both].max() <= 0.5
    for key in ("auc_a", "auc_i", "auc_v"):
        np.testing.assert_allclose(got[key], ref[key], atol=0.02)
    assert abs(got["mean_matches"] - ref["mean_matches"]) <= \
        0.05 * ref["mean_matches"]


def test_the_fixture_reads_as_written(tmp_path):
    write_hpatches(tmp_path)
    shapes = hpatches._sequence_shapes(sorted(tmp_path.glob("*")), IMSIZE)
    assert shapes == [((120, 160), (120, 160)), ((160, 184), (160, 184))]
