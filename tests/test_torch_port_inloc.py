"""The port's dense-depth localization (eval/inloc.py) against the JAX
package's.

On tests/torch_port_util.localization_scene, each db camera gets a depth
map with the scene's points splatted into 3x3 pixel blocks (zero
elsewhere, the invalid depth), saved as the npz scans load_db_scans
reads. unproject_depth and load_db_scans equal JAX's value for value;
localize_queries_dense with JAX's PnP draws injected gives the same
``ok``, inlier counts within 2 and poses within the f32 bar of
tests/test_torch_port_sfm_localize.py (0.1 deg, 2 cm), and a query with
no valid depth under its matches is not localized.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu.eval import inloc as JI  # noqa: E402
from geoformer_tpu.eval import sfm_localize as JS  # noqa: E402
from geoformer_tpu_torch.eval import inloc as PI  # noqa: E402
from geoformer_tpu_torch.eval import sfm_localize as PS  # noqa: E402
from torch_port_util import (  # noqa: E402
    LOC_HW,
    LOC_K,
    JaxPnpDraws,
    close_poses,
    localization_scene,
)
from torch_port_util import one_torch_thread  # noqa: E402,F401


def _scans(sc, root):
    h, w = LOC_HW
    for name, T in sc["db_cams"].items():
        pc = sc["points"] @ T[:3, :3].T + T[:3, 3]
        uv = pc @ LOC_K.T
        uv = np.round(uv[:, :2] / uv[:, 2:]).astype(int)
        depth = np.zeros(LOC_HW, np.float32)
        for (u, v), z in sorted(zip(uv, pc[:, 2]), key=lambda x: -x[1]):
            if z > 0.2 and 1 <= u < w - 1 and 1 <= v < h - 1:
                depth[v - 1:v + 2, u - 1:u + 2] = z
        np.savez(f"{root}/{name[:-4]}.npz", depth=depth, K=LOC_K, T_w2c=T)
    return list(sc["db_cams"])


def test_unproject_and_scans_equal_jax(tmp_path):
    sc = localization_scene(str(tmp_path))
    names = _scans(sc, str(tmp_path))
    got = PI.load_db_scans(str(tmp_path), names + ["missing.jpg"])
    ref = JI.load_db_scans(str(tmp_path), names + ["missing.jpg"])
    assert got.keys() == ref.keys() == set(names)
    rng = np.random.default_rng(1)
    uv = np.concatenate([rng.uniform(-20, 660, (200, 2)),
                         sc["match"]("db00.jpg", "db01.jpg")[:, :2]])
    for n in names:
        for k in ("depth", "K", "T_w2c"):
            np.testing.assert_array_equal(got[n][k], ref[n][k])
        p = PI.unproject_depth(uv, got[n]["depth"], got[n]["K"],
                               got[n]["T_w2c"])
        j = JI.unproject_depth(uv, ref[n]["depth"], ref[n]["K"],
                               ref[n]["T_w2c"])
        np.testing.assert_array_equal(p[1], j[1])
        np.testing.assert_array_equal(p[0], j[0])


def test_localize_queries_dense_with_jax_draws(tmp_path, monkeypatch):
    sc = localization_scene(str(tmp_path))
    scans = PI.load_db_scans(str(tmp_path), _scans(sc, str(tmp_path)))
    qcams = JS.parse_queries_with_intrinsics(sc["queries_txt"])
    qm = {}
    for q, d in sc["query_pairs"]:
        qm.setdefault(q, {})[d] = sc["match"](q, d)
    qm["q_off.jpg"] = {"db00.jpg": np.full((8, 4), -50.0)}  # off the scans
    qcams["q_off.jpg"] = qcams["q00.jpg"]
    draws = JaxPnpDraws()
    draws.patch_jax(monkeypatch)
    ref = JI.localize_queries_dense(qcams, qm, scans, seed=2)
    assert len(draws.draws) == 2
    got = PI.localize_queries_dense(
        qcams, qm, scans, seed=2, device="cpu",
        sample_idx=dict(zip(sc["queries"], draws.draws)))
    close_poses(got, ref)
    assert not got["q_off.jpg"]["ok"]
    for q, T in sc["queries"].items():
        c = -PS.qvec2rotmat(got[q]["qvec"]).T @ got[q]["tvec"]
        assert got[q]["ok"] and np.linalg.norm(
            c - (-T[:3, :3].T @ T[:3, 3])) < 0.05
