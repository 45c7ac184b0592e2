"""The port's ISC-HE drivers (homography and classification) against the
JAX ones on the CPU.

Both run on the same files: an ISC corpus written by the JAX package's own
builder (scripts/fire_isc_protocol.py, loaded by path: 2 pairs of cv2
JPEGs at 480-720 x 640-800) and its classification list (2 positive and 2
negative lines), at imsize 128 with the trained checkpoint. The JAX draws
of the GAM's RANSAC and of the fits are handed to the port
(tests/torch_port_util.JaxDrawsMatcher).

Tolerances: equal pair, failed and inaccurate counts; each pair's mean
control-point error within 1e-3 px; AUCs within 1e-6; the same inlier
count on every classification line, and then the same EER and threshold
exactly. Measured: the errors within 7.2e-6 px, the AUCs within 4e-8, the
inlier rate and every inlier count equal.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from geoformer_tpu.eval import isc as j_isc  # noqa: E402
from geoformer_tpu.eval import matcher as j_matcher  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu_torch.eval import isc  # noqa: E402
from geoformer_tpu_torch.eval.image_io import read_size  # noqa: E402
from geoformer_tpu_torch.eval.selfcheck import load_model  # noqa: E402
from test_torch_port_eval_fire_isc import (  # noqa: E402
    CKPT,
    _spy,
    eval_config,
    jax_protocol,
)
from torch_port_util import JaxDrawsMatcher, port_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

IMSIZE = 128


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("isc")
    jp = jax_protocol()
    assert jp.build_isc(str(root), seed=3, n_pairs=2) == 2
    assert jp.build_isc_cls(str(root), str(root / "cls.txt"), seed=4) == 4
    return root


@pytest.fixture(scope="module")
def run(corpus):
    jcfg = eval_config()
    draws = JaxDrawsMatcher(jcfg)
    variables = load_variables(str(CKPT))
    seen = {"ref_d": [], "ref_eer": [], "got_d": [], "got_eer": []}
    with pytest.MonkeyPatch.context() as mp:
        draws.patch_jax(mp, j_matcher)
        _spy(mp, j_isc, "cal_error_auc", seen["ref_d"])
        _spy(mp, j_isc, "compute_eer", seen["ref_eer"])
        ref = j_isc.eval_isc(variables, jcfg, str(corpus), imsize=IMSIZE,
                             log=lambda s: None)
        ref_cls = j_isc.eval_isc_classification(
            variables, jcfg, str(corpus / "cls.txt"), imsize=IMSIZE,
            ransac_thr=3.0, log=lambda s: None)
    pcfg = port_config(jcfg)
    model = load_model(pcfg, str(CKPT), "cpu")
    handle = draws.patch_port(model)
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        JaxDrawsMatcher.patch_fits(mp, isc)
        _spy(mp, isc, "cal_error_auc", seen["got_d"])
        _spy(mp, isc, "compute_eer", seen["got_eer"])
        got = isc.eval_isc(model, pcfg, str(corpus), imsize=IMSIZE,
                           log=lines.append, device="cpu")
        got_cls = isc.eval_isc_classification(
            model, pcfg, str(corpus / "cls.txt"), imsize=IMSIZE,
            ransac_thr=3.0, log=lines.append, device="cpu")
    handle.remove()
    assert draws._next == len(draws.draws) == 6
    return ref, got, ref_cls, got_cls, seen, lines


def test_the_corpus_has_a_portrait_and_a_landscape_pair(corpus):
    sizes = {read_size(str(p)) for p in (corpus / "query").iterdir()}
    assert any(h > w for h, w in sizes) and any(h < w for h, w in sizes)


def test_isc_counts_agree(run):
    ref, got, _, _, _, lines = run
    assert set(got) == set(ref)
    for key in ("n_pairs", "failed", "inaccurate"):
        assert got[key] == ref[key], key
    assert got["n_pairs"] == 2 and got["failed"] == 0
    assert lines[0].startswith(">>ISC-HE: pairs=2 failed=0")


def test_isc_errors_and_aucs_agree(run):
    ref, got, _, _, seen, _ = run
    (ref_d, _), = seen["ref_d"]
    (got_d, _), = seen["got_d"]
    np.testing.assert_allclose(got_d, ref_d, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["auc"], ref["auc"], atol=1e-6, rtol=0)
    assert abs(got["acceptable"] - ref["acceptable"]) <= 1e-12
    assert abs(got["inlier_rate"] - ref["inlier_rate"]) <= 1e-3


def test_isc_classification_agrees(run):
    _, _, ref_cls, got_cls, seen, lines = run
    (ref_labels, ref_counts), = seen["ref_eer"]
    (got_labels, got_counts), = seen["got_eer"]
    np.testing.assert_array_equal(got_labels, ref_labels)
    np.testing.assert_array_equal(got_counts, ref_counts)
    assert list(ref_labels) == [1, 0, 1, 0]
    assert got_cls == ref_cls
    assert got_cls["n_pairs"] == 4 and got_cls["match_failed"] == 0
    assert lines[-1].startswith(">>ISC-cls: EER: ")


def test_a_pair_that_fails_counts_as_no_inliers(corpus, tmp_path):
    """A missing file is logged and counted as 0 inliers, as in JAX."""
    lines = [f"{tmp_path / 'none.jpg'} {tmp_path / 'none.jpg'} 1",
             f"{tmp_path / 'none.jpg'} {tmp_path / 'none.jpg'} 0"]
    (tmp_path / "bad.txt").write_text("\n".join(lines) + "\n")
    cfg = port_config(eval_config())
    log = []
    out = isc.eval_isc_classification(
        load_model(cfg, str(CKPT), "cpu"), cfg, str(tmp_path / "bad.txt"),
        imsize=IMSIZE, log=log.append, device="cpu")
    assert out["match_failed"] == 2 and out["n_pairs"] == 2
    assert sum(line.startswith("match failed: ") for line in log) == 2
    assert Path(corpus).is_dir()
