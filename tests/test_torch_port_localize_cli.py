"""`cli localize` (both modes) and `cli slam` of the port through the
trained checkpoint, on the CPU at a small size.

The localization protocol's scene (eval/localize_protocol.build_scene,
cut to 2 db images and 1 query, with the db scans) and the ATE
protocol's sequence (eval/ate_protocol.build_sequence, 3 frames of
96x128) go through the commands at --imsize 64 with the JAX commands'
flags (8 matcher forwards in all). The outputs have the JAX commands' format: poses.txt is what the
JAX write_pose_file writes for the same poses, the SfM run leaves the
JAX driver's files (empty and triangulated models, pair list, h5
exports, database), `slam` prints the JAX command's JSON keys and its
trajectory file is what the JAX save_trajectory writes. The pipelines are
held to the JAX package with injected matchers in
tests/test_torch_port_{slam,sfm_localize,inloc}.py.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from geoformer_tpu.engine import slam as JS  # noqa: E402
from geoformer_tpu.eval import sfm_localize as JL  # noqa: E402
from geoformer_tpu_torch import cli  # noqa: E402
from geoformer_tpu_torch.eval import (  # noqa: E402
    ate_protocol,
    localize_protocol,
)

CKPT = str(Path(__file__).resolve().parent.parent / "checkpoints"
           / "tpu_r3_main" / "params_final.npz")
SMALL = ["--ckpt", CKPT, "--imsize", "64", "--device", "cpu"]


def _poses(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        p = line.split()
        assert len(p) == 8
        out[p[0]] = {"qvec": np.asarray(p[1:5], float),
                     "tvec": np.asarray(p[5:8], float)}
    return out


def _same_as_jax_writer(path, tmp_path):
    poses = _poses(path)
    JL.write_pose_file(poses, str(tmp_path / "jax_poses.txt"))
    assert Path(path).read_text() == \
        (tmp_path / "jax_poses.txt").read_text()
    return poses


def test_cli_localize_both_modes(tmp_path, capsys):
    scene = str(tmp_path / "scene")
    cams = localize_protocol.build_scene(scene, n_db=2, n_query=1,
                                         scans=True)
    base = ["localize", "--images", f"{scene}/images", "--queries",
            f"{scene}/queries.txt", "--query-pairs",
            f"{scene}/query_pairs.txt", "--covis-topk", "3", *SMALL]
    cli.main(base + ["--nvm", f"{scene}/model.nvm", "--database",
                     f"{scene}/db.db", "--out", str(tmp_path / "sfm")])
    cli.main(base + ["--scan-dir", f"{scene}/scans", "--out",
                     str(tmp_path / "dense")])
    printed = capsys.readouterr().out
    assert "localized" in printed and "poses ->" in printed
    for mode in ("sfm", "dense"):
        poses = _same_as_jax_writer(tmp_path / mode / "poses.txt", tmp_path)
        assert sorted(poses) == sorted(cams["query"])
        for p in poses.values():
            assert np.isfinite(p["tvec"]).all()
            assert abs(np.linalg.norm(p["qvec"]) - 1) < 1e-6
    made = {str(p.relative_to(tmp_path / "sfm"))
            for p in (tmp_path / "sfm").rglob("*")}
    assert {"keypoints.h5", "matches.h5", "result.db",
            "pairs-db-covis3.txt", "empty_sfm/images.bin",
            "sfm_model/points3D.bin"} <= made
    with pytest.raises(SystemExit, match="--scan-dir"):
        cli.main(base + ["--out", str(tmp_path / "x")])


def test_cli_slam_prints_the_jax_keys(tmp_path, capsys):
    seq = str(tmp_path / "seq")
    ate_protocol.build_sequence(seq, frames=3, hw=(96, 128))
    traj = str(tmp_path / "traj.txt")
    cli.main(["slam", "--images", seq, "--glob", "frame_*.png",
              "--loop-stride", "2", "--gt", f"{seq}/gt.npz", "--out", traj,
              *SMALL])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert list(out) == ["frames", "edges_ok", "edges_total",
                         "corner_drift_chained_px",
                         "corner_drift_optimized_px", "trajectory"]
    assert out["frames"] == 3 and out["edges_total"] == 3
    assert out["trajectory"] == traj
    H = np.asarray([ln.split()[1:] for ln in
                    Path(traj).read_text().splitlines()], float)
    assert H.shape == (3, 9)
    JS.save_trajectory(H.reshape(3, 3, 3), str(tmp_path / "jax.txt"))
    assert Path(traj).read_text() == (tmp_path / "jax.txt").read_text()
    rec = ate_protocol.record(out, 20260819, 3, 2)
    assert set(rec) == {"protocol", "seed", "frames", "loop_stride",
                        "corner_drift_chained_px",
                        "corner_drift_optimized_px", "gate_px", "pass"}
    assert os.path.exists(f"{seq}/frame_002.png")
    with pytest.raises(SystemExit, match="need >=2 frames"):
        cli.main(["slam", "--images", seq, "--glob", "none_*.png", *SMALL])
