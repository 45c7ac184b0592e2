"""The port's FIRE driver, ROC/EER and corpus builders against the JAX ones.

Both FIRE drivers run on the same files: a corpus written by the JAX
package's own builder (scripts/fire_isc_protocol.py, loaded by path: cv2
JPEGs of 3 pairs, one a class, at 192 px), at imsize 128 with the trained
checkpoint. The JAX draws of the GAM's RANSAC and of the fit are handed to
the port (tests/torch_port_util.JaxDrawsMatcher).

Tolerances: equal pair, failed and inaccurate counts; each pair's mean
control-point error within 1e-3 px; every AUC within 1e-6. Measured: the
errors within 2.5e-5 px (0.48-0.89 px), the AUCs equal. ROC and EER
exactly on random labels and tied scores. The port's builders give the JAX
builders' classes, homographies and control points exactly (bit for bit;
the bar is 1e-9 relative for the homographies) for the same seed; their
images differ by the warp's and the blur's rounding and by another JPEG
encoder: measured mean 0.1-0.8 grey levels (bar 1.5).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from geoformer_tpu.config import (  # noqa: E402
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
)
from geoformer_tpu.eval import fire as j_fire  # noqa: E402
from geoformer_tpu.eval import isc as j_isc  # noqa: E402
from geoformer_tpu.eval import matcher as j_matcher  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu_torch.eval import fire, isc  # noqa: E402
from geoformer_tpu_torch.eval import fire_isc_protocol as proto  # noqa: E402
from geoformer_tpu_torch.eval.selfcheck import load_model  # noqa: E402
from torch_port_util import JaxDrawsMatcher, port_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
IMSIZE = 128


def jax_protocol():
    """scripts/fire_isc_protocol.py as a module (the JAX builders)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fire_isc_protocol", ROOT / "scripts" / "fire_isc_protocol.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eval_config():
    return GeoFormerConfig(match=MatchConfig(thr=0.2, max_matches=1024),
                           geo=GeoModuleConfig(ransac_iters=256,
                                               max_inliers=1024))


def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.fixture(scope="module")
def fire_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("fire")
    assert jax_protocol().build_fire(str(root), seed=5, size=192, n_s=1,
                                     n_p=1, n_a=1) == 3
    jcfg = eval_config()
    draws = JaxDrawsMatcher(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        draws.patch_jax(mp, j_matcher)
        ref_err = []
        _spy(mp, j_fire, "_auc_curve", ref_err)
        ref = j_fire.eval_fire(load_variables(str(CKPT)), jcfg, str(root),
                               imsize=IMSIZE, log=lambda s: None)
    pcfg = port_config(jcfg)
    model = load_model(pcfg, str(CKPT), "cpu")
    handle = draws.patch_port(model)
    with pytest.MonkeyPatch.context() as mp:
        JaxDrawsMatcher.patch_fits(mp, fire)
        got_err = []
        _spy(mp, fire, "_auc_curve", got_err)
        lines = []
        got = fire.eval_fire(model, pcfg, str(root), imsize=IMSIZE,
                             log=lines.append, device="cpu")
    handle.remove()
    assert draws._next == len(draws.draws) == 3
    return ref, got, ref_err, got_err, lines


def test_fire_counts_agree(fire_run):
    ref, got, _, _, lines = fire_run
    assert set(got) == set(ref)
    for key in ("n_pairs", "failed", "inaccurate"):
        assert got[key] == ref[key], key
    assert got["n_pairs"] == 3 and got["failed"] == 0
    assert lines[-1].startswith(">>FIRE: pairs=3 failed=0")


def test_fire_errors_and_aucs_agree(fire_run):
    ref, got, ref_err, got_err, _ = fire_run
    assert len(ref_err) == len(got_err) == 3           # S, P, A
    for (a,), (b,) in zip(ref_err, got_err):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(b, a, atol=1e-3, rtol=0)
    assert set(got["auc_per_class"]) == set(ref["auc_per_class"]) == \
        {"S", "P", "A"}
    for c in "SPA":
        assert abs(got["auc_per_class"][c] - ref["auc_per_class"][c]) <= 1e-6
    assert abs(got["mAUC"] - ref["mAUC"]) <= 1e-6
    assert got["mAUC"] > 0.5


def test_fire_auc_curve_is_strict():
    errs = np.array([1.0, 2.0, 2.5, np.inf])
    assert fire._auc_curve(errs) == j_fire._auc_curve(errs)
    assert fire._auc_curve(np.array([])) == 0.0
    # an error of exactly 1 px is not below the 1 px threshold
    assert fire._auc_curve(np.array([1.0]), limit=1) == 0.0


# ------------------------------------------------------------- ROC / EER --

@pytest.mark.parametrize("seed", range(6))
def test_roc_and_eer_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    labels = rng.integers(0, 2, n)
    labels[:2] = [0, 1]
    scores = rng.integers(0, 12, n).astype(float)       # many ties
    if seed % 2:
        scores = scores * 0.37 + rng.random(n) * (seed == 5)
    for got, ref in zip(isc.roc_curve_np(labels, scores),
                        j_isc.roc_curve_np(labels, scores)):
        np.testing.assert_array_equal(got, ref)
    assert isc.compute_eer(labels, scores) == j_isc.compute_eer(labels,
                                                                scores)


def test_eer_edge_cases():
    for labels, scores in (([1, 0], [5, 1]), ([0, 1], [5, 1]),
                           ([1, 1, 0], [3, 3, 3]), ([0, 0, 1], [0, 0, 0])):
        assert isc.compute_eer(np.array(labels), np.array(scores)) == \
            j_isc.compute_eer(np.array(labels), np.array(scores))


# ----------------------------------------------------------- the builders --

def _images_mean_diff(a_dir: Path, b_dir: Path):
    diffs = []
    for f in sorted(a_dir.rglob("*.jpg")):
        a = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE).astype(int)
        b = cv2.imread(str(b_dir / f.relative_to(a_dir)),
                       cv2.IMREAD_GRAYSCALE).astype(int)
        assert a.shape == b.shape
        diffs.append(np.abs(a - b).mean())
    return diffs


def test_build_fire_gives_the_jax_corpus(tmp_path):
    jp = jax_protocol()
    a, b = tmp_path / "jax", tmp_path / "port"
    assert jp.build_fire(str(a), seed=9, size=160, n_s=2, n_p=1, n_a=1) == \
        proto.build_fire(str(b), seed=9, size=160, n_s=2, n_p=1, n_a=1) == 4
    names = sorted(p.name for p in (a / "ground_truth").iterdir())
    assert names == sorted(p.name for p in (b / "ground_truth").iterdir())
    assert [n[len("control_points_")] for n in names] == list("APSS")
    for n in names:
        np.testing.assert_array_equal(np.loadtxt(b / "ground_truth" / n),
                                      np.loadtxt(a / "ground_truth" / n))
    diffs = _images_mean_diff(a, b)
    assert len(diffs) == 8 and max(diffs) <= 1.5


def test_build_isc_gives_the_jax_corpus(tmp_path):
    jp = jax_protocol()
    a, b = tmp_path / "jax", tmp_path / "port"
    assert jp.build_isc(str(a), seed=4, n_pairs=2) == \
        proto.build_isc(str(b), seed=4, n_pairs=2) == 2
    for f in sorted((a / "gd").iterdir()):
        np.testing.assert_array_equal(np.loadtxt(b / "gd" / f.name),
                                      np.loadtxt(f))
    diffs = _images_mean_diff(a, b)
    assert len(diffs) == 4 and max(diffs) <= 1.5
    assert jp.build_isc_cls(str(a), str(a / "cls.txt"), seed=6) == \
        proto.build_isc_cls(str(b), str(b / "cls.txt"), seed=6) == 4
    assert (a / "cls.txt").read_text().replace(str(a), "R") == \
        (b / "cls.txt").read_text().replace(str(b), "R")


@pytest.mark.parametrize("seed", range(4))
def test_perspective_transform_is_cv2s_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    for size in (160, 640, 1024):
        src = np.array([[0, 0], [size, 0], [size, size], [0, size]],
                       np.float32)
        dst = src + rng.uniform(-0.12, 0.12, (4, 2)).astype(np.float32) \
            * size
        ref = cv2.getPerspectiveTransform(src, dst)
        got = proto.perspective_transform(src, dst)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sigma,size", [(1.2, 64), (8.0, 192), (42.67, 300)])
def test_gaussian_blur_is_cv2s(sigma, size):
    x = np.random.default_rng(1).standard_normal((size, size + 7))
    x = x.astype(np.float32)
    ref = cv2.GaussianBlur(x, (0, 0), sigma)
    got = proto.gaussian_blur(x, sigma)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6
    k = cv2.getGaussianKernel(int(np.rint(sigma * 8 + 1)) | 1, sigma,
                              cv2.CV_32F)[:, 0]
    np.testing.assert_allclose(proto.gaussian_kernel(sigma), k, rtol=1e-6)


def test_the_gate_reads_the_jax_thresholds():
    good = {"fire": {"mAUC": 0.99, "failed": 0}, "isc": {"auc": [0.97]},
            "isc_cls": {"eer": 0.05}}
    assert proto.gate(good)
    for key, bad in (("fire", {"mAUC": 0.999, "failed": 1}),
                     ("fire", {"mAUC": 0.98, "failed": 0}),
                     ("isc", {"auc": [0.969]}), ("isc_cls", {"eer": 0.06})):
        assert not proto.gate(dict(good, **{key: bad}))
