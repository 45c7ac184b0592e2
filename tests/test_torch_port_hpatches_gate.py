"""The HPatches driver of both packages on the gate's corpus, with the same
draws.

The JAX builder (scripts/hpatches_synth.py, loaded by path, with cv2)
writes a cut of the gate's corpus: 2 i_ and 3 v_ sequences at the
census's full sizes, two of the v_ sequences changing size between
images. The JAX and the port's eval_hpatches run it at imsize 128 with the
trained checkpoint, without prewarm, the JAX draws of the GAM's RANSAC and
of the fits handed to the port (tests/torch_port_util.JaxDrawsMatcher).
Tolerances: equal n_pairs and est_failed, the same mean matches, each
pair's corner error within 1e-3 px, every AUC within 1e-4 (the AUC moves by
at most the mean error change over the threshold, 1e-3 at 1 px) and the
correctness fractions equal. Measured: the AUCs within 2.3e-5 (the two
f32 forwards sum in other orders; the fit amplifies that into the corner
errors).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from geoformer_tpu.config import (  # noqa: E402
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
)
from geoformer_tpu.eval import hpatches as j_hpatches  # noqa: E402
from geoformer_tpu.eval import matcher as j_matcher  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu_torch.eval import hpatches  # noqa: E402
from geoformer_tpu_torch.eval.selfcheck import load_model  # noqa: E402
from torch_port_util import JaxDrawsMatcher, port_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
IMSIZE = 128


def _spy_corner_errors(monkeypatch, module, seen):
    """Keep the corner errors that the driver's AUCs are computed from
    (cal_error_auc's first argument: all pairs, then each split)."""
    real = module.cal_error_auc

    def spy(errors, *a, **kw):
        seen.append(np.asarray(errors, np.float64))
        return real(errors, *a, **kw)

    monkeypatch.setattr(module, "cal_error_auc", spy)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not CKPT.is_file():
        pytest.skip("trained checkpoint not in this checkout")
    root = tmp_path_factory.mktemp("hp_gate")
    spec = importlib.util.spec_from_file_location(
        "jax_hpatches_synth", ROOT / "scripts" / "hpatches_synth.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    assert synth.build(str(root), n_i=2, n_v=3, seed=0) == 5
    jcfg = GeoFormerConfig(match=MatchConfig(thr=0.2, max_matches=1024),
                           geo=GeoModuleConfig(ransac_iters=256,
                                               max_inliers=1024))
    draws = JaxDrawsMatcher(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        draws.patch_jax(mp, j_matcher)
        ref_err = []
        _spy_corner_errors(mp, j_hpatches, ref_err)
        ref = j_hpatches.eval_hpatches(load_variables(str(CKPT)), jcfg,
                                       str(root), imsize=IMSIZE,
                                       prewarm=False, log=lambda s: None)
    pcfg = port_config(jcfg)
    model = load_model(pcfg, str(CKPT), "cpu")
    handle = draws.patch_port(model)
    with pytest.MonkeyPatch.context() as mp:
        JaxDrawsMatcher.patch_fits(mp, hpatches)
        got_err = []
        _spy_corner_errors(mp, hpatches, got_err)
        got = hpatches.eval_hpatches(model, pcfg, str(root), imsize=IMSIZE,
                                     prewarm=False, log=lambda s: None,
                                     device="cpu")
    handle.remove()
    assert draws._next == len(draws.draws) == 15     # 5 sequences x 3
    return ref, got, ref_err, got_err


def test_the_drivers_count_the_same_pairs_and_failures(runs):
    ref, got, _, _ = runs
    assert set(got) == set(ref)
    assert got["n_pairs"] == ref["n_pairs"] == 25
    assert got["est_failed"] == ref["est_failed"] == 0
    assert got["mean_matches"] == pytest.approx(ref["mean_matches"], abs=0)


def test_the_corner_errors_agree(runs):
    _, _, ref_err, got_err = runs
    assert len(ref_err) == len(got_err) == 3            # a, i, v
    assert [len(e) for e in got_err] == [len(e) for e in ref_err] == \
        [25, 10, 15]
    for a, b in zip(got_err, ref_err):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


@pytest.mark.parametrize("split", ["a", "i", "v"])
def test_the_aucs_agree(runs, split):
    ref, got, _, _ = runs
    np.testing.assert_allclose(got[f"auc_{split}"], ref[f"auc_{split}"],
                               rtol=0, atol=1e-4)
    assert got[f"correct_{split}"] == ref[f"correct_{split}"]
    assert got["auc_a"][3] > 0.5
