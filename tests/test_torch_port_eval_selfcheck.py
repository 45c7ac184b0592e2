"""The port's self-check core against the JAX script's protocol on the CPU.

The inputs are the JAX script's (scripts/selfcheck_eval.py): procedural
textures from the seed (cpp/synthgen.cpp, the port's build of the same
source), homographies from jax.random, warps by synthgen_warp; the model is
the trained checkpoint at the script's configuration, at a reduced size
(2 pairs of 120x160, one batch). The GAM's RANSAC samples are drawn with
JAX as the JAX forward draws them and injected; so are the fit's.

Tolerances: the final matches by the JAX package's parity bar
(__graft_entry__.py: (i, j) match sets overlap >= 0.9, keypoints of the
common matches within 0.05 px); corner errors within 0.05 px of the JAX
script's. Measured: overlap 1.0 and keypoints equal on every pair, corner errors
within 4.2e-5 px (the same on four pairs).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from geoformer_tpu.config import (  # noqa: E402
    GeoFormerConfig,
    GeoModuleConfig,
    MatchConfig,
)
from geoformer_tpu.eval.hpatches import fit_homography_np as j_fit  # noqa: E402
from geoformer_tpu.geometry.homography import (  # noqa: E402
    sample_homography as j_sample_homography,
)
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.eval import selfcheck  # noqa: E402
from geoformer_tpu_torch.eval.metrics import corner_error  # noqa: E402
from geoformer_tpu_torch.geometry.homography import (  # noqa: E402
    sample_homography,
    sample_homography_draws,
)
from torch_port_util import (  # noqa: E402
    jax_fit_sample_idx,
    jax_forward_and_draws,
    match_bar,
    n,
)
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
PAIRS, HW, SEED = 2, (120, 160), 123456
JAX_KEYS = {"pairs", "mean_matches", "match_time_per_pair_s",
            "correct@1/3/5/10", "auc@1/3/5/10", "failed"}


@pytest.fixture(scope="module")
def run():
    base = native.native_textures(PAIRS, *HW, SEED)
    keys = jax.random.split(jax.random.key(SEED), PAIRS)
    Hs = np.asarray(jax.vmap(lambda k: j_sample_homography(k, HW))(keys))
    warped = native.native_warp(base, Hs)
    cfg = GeoFormerConfig(match=MatchConfig(max_matches=1024),
                          geo=GeoModuleConfig(ransac_iters=256,
                                              max_inliers=1024))
    out, gam_idx = jax_forward_and_draws(
        cfg, load_variables(str(CKPT)), base[..., None], warped[..., None],
        jax.random.key(0))
    valid = np.asarray(out.fine.valid)
    ids = np.stack([np.asarray(out.matches.i_ids),
                    np.asarray(out.matches.j_ids)], -1)
    kp = np.concatenate([np.asarray(out.fine.mkpts0),
                         np.asarray(out.fine.mkpts1)], -1)
    ref = [(ids[b][valid[b]], kp[b][valid[b]]) for b in range(PAIRS)]
    dists = []
    for b, (_, k) in enumerate(ref):
        Hp, _ = j_fit(k[:, :2], k[:, 2:], 3.0)
        dists.append(corner_error(Hs[b], Hp, HW))
    model = selfcheck.load_model(selfcheck.selfcheck_config(), str(CKPT),
                                 "cpu")
    return dict(base=base, warped=warped, Hs=Hs, gam_idx=gam_idx, ref=ref,
                dists=dists, model=model)


def test_the_pairs_are_matched_and_fitted(run):
    assert all(len(k) > 50 for _, k in run["ref"])
    assert max(run["dists"]) < 3.0


def test_match_pairs_meets_the_forward_bar(run):
    outputs = []
    hook = run["model"].register_forward_hook(
        lambda mod, args, out: outputs.append(out))
    try:
        matches, seconds = selfcheck.match_pairs(
            run["model"], run["base"], run["warped"], "cpu",
            gam_sample_idx=run["gam_idx"])
    finally:
        hook.remove()
    assert seconds > 0 and len(matches) == PAIRS and len(outputs) == 1
    out = outputs[0]
    for b, (ref_ids, ref_kp) in enumerate(run["ref"]):
        v = n(out.fine.valid[b]).astype(bool)
        ids = np.stack([n(out.matches.i_ids[b]), n(out.matches.j_ids[b])],
                       -1)[v]
        kp = np.concatenate([n(out.fine.mkpts0[b]), n(out.fine.mkpts1[b])],
                            -1)[v]
        # match_pairs returns this forward's valid keypoints
        np.testing.assert_array_equal(np.concatenate(matches[b], 1), kp)
        overlap, kp_px = match_bar(ref_ids, ref_kp, ids, kp)
        assert overlap >= 0.9, (b, overlap)
        assert kp_px < 0.05, (b, kp_px)


def test_fit_pairs_gives_the_jax_corner_errors(run):
    matches = [(k[:, :2], k[:, 2:]) for _, k in run["ref"]]
    idx = [jax_fit_sample_idx(len(p0), 0) for p0, _ in matches]
    dists, seconds = selfcheck.fit_pairs(matches, run["Hs"], HW,
                                         device="cpu", fit_sample_idx=idx)
    assert seconds > 0
    np.testing.assert_allclose(dists, run["dists"], atol=0.05)


def test_make_pairs_draws_the_port_protocol():
    base, warped, Hs = selfcheck.make_pairs(3, (48, 64), 5)
    np.testing.assert_array_equal(base, native.native_textures(3, 48, 64, 5))
    want = sample_homography(sample_homography_draws(
        3, (48, 64), torch.Generator().manual_seed(5)), (48, 64)).numpy()
    np.testing.assert_array_equal(Hs, want)
    assert Hs.dtype == np.float32
    np.testing.assert_array_equal(warped, native.native_warp(base, Hs))
    photos, _, _ = selfcheck.make_pairs(3, (48, 64), 5, ["held-out-photos"])
    assert photos.shape == (3, 48, 64)
    np.testing.assert_array_equal(photos[0], photos[2])   # two, cycled
    assert not np.array_equal(photos[0], photos[1])
    try:
        paths = selfcheck.real_photos()
    except FileNotFoundError:
        pytest.skip("no package photographs (sklearn, matplotlib, pygame)")
    real, _, _ = selfcheck.make_pairs(len(paths), (48, 64), 5,
                                      ["real-photos"])
    assert real.shape == (len(paths), 48, 64)


def test_real_photos_are_the_jax_script_bases():
    """--image real-photos globs the JAX script's photographs and reads
    them as it does (cv2.imread grey, cv2.resize to the pair size): the
    decode exactly, the bases within the resize's 1/255."""
    cv2 = pytest.importorskip("cv2")
    try:
        paths = selfcheck.real_photos()
    except FileNotFoundError:
        pytest.skip("no package photographs (sklearn, matplotlib, pygame)")
    hw = (120, 160)
    base, _, _ = selfcheck.make_pairs(len(paths) + 1, hw, 5, ["real-photos"])
    for i, p in enumerate(paths + paths[:1]):
        im = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(
            selfcheck.read_gray(p), im, err_msg=p)
        ref = cv2.resize(im, hw[::-1]).astype(np.float32) / 255.0
        assert np.abs(base[i] - ref).max() <= 1 / 255 + 1e-7, p


def test_the_script_prints_the_jax_keys(capsys, monkeypatch):
    import json

    selfcheck.main(["--pairs", "2", "--height", "64", "--width", "80",
                    "--device", "cpu", "--ckpt", str(CKPT)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == JAX_KEYS
    assert rec["pairs"] == 2 and len(rec["auc@1/3/5/10"]) == 4
    # the int8 flags give the int8 model (its forward and fits:
    # tests/test_torch_port_int8_model.py)
    seen = {}

    def run_pairs(model, base, *args):
        seen["cfg"] = model.config
        return dict(dists=[0.5] * len(base), n_matches=[9] * len(base),
                    match_s=0.0, fit_s=0.0)

    monkeypatch.setattr(selfcheck, "run_pairs", run_pairs)
    for flag, full in (("--int8", False), ("--int8-full", True)):
        selfcheck.main([flag, "--pairs", "2", "--height", "64", "--width",
                        "80", "--device", "cpu", "--ckpt", str(CKPT)])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(rec) == JAX_KEYS and rec["pairs"] == 2
        c = seen["cfg"]
        assert c.backbone.int8 and (c.coarse.int8, c.fine.int8,
                                    c.geo.int8) == (full,) * 3
