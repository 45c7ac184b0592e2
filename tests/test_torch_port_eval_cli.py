"""The port's command line (infer, eval, parity) and image-directory
training, on the CPU.

``eval fire``, ``eval isc`` and ``eval isc-cls`` run on a small corpus of
JPEG files that the port's gate module builds, and write the JAX drivers'
keys; their protocol defaults are the JAX CLI's.

``infer`` runs on two PNG files written into tmp_path (a procedural
texture at 300x400 and its warp by a known homography) with the trained
checkpoint, through both packages' CLIs, each with its own RANSAC draws.
The saved arrays have the same layout ([K, 5]: keypoints in the files'
frame, then the confidence) and the same match set; the rows are compared
after sorting by the first keypoint, because the order of matches with
saturated confidences may differ (top-k ties). Tolerances: keypoints within
0.05 px of the resized frame (the parity bar of __graft_entry__.py, times
the scale back to the file's frame; measured exact), confidences within
1e-4.
"""

import argparse
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from geoformer_tpu import cli as j_cli  # noqa: E402
from geoformer_tpu_torch import cli  # noqa: E402
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.train.loop import run_training  # noqa: E402
from geoformer_tpu_torch.weights import load_npz  # noqa: E402
from torch_port_util import port_config, small_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz")
H_TRUE = np.array([[0.95, 0.04, 10.0], [-0.03, 0.97, 6.0], [1e-5, 2e-5, 1.0]])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("infer")
    base = native.native_textures(1, 300, 400, seed=3)
    warped = native.native_warp(base, H_TRUE[None])
    for name, img in (("a.png", base[0]), ("b.png", warped[0])):
        cv2.imwrite(str(d / name), np.round(img * 255).astype(np.uint8))
    return d


def test_infer_saves_what_the_jax_cli_saves(pair, capsys):
    ns = argparse.Namespace(
        image0=str(pair / "a.png"), image1=str(pair / "b.png"), imsize=160,
        ckpt=CKPT, match_thr=0.2, max_matches=1024, gam_ransac_iters=256,
        gam_max_inliers=1024, pallas=False, bf16=False, int8=False,
        int8_full=False, seq_shard=0, draw=None, draw_geo=None,
        out=str(pair / "jax.npy"))
    j_cli.cmd_infer(ns)
    ref_line = capsys.readouterr().out.splitlines()[0]
    cli.main(["infer", ns.image0, ns.image1, "--imsize", "160", "--ckpt",
              CKPT, "--device", "cpu", "--out", str(pair / "port.npy")])
    out = capsys.readouterr().out.splitlines()
    # "<K> matches in <s>s (GAM: has_H=<b> inliers=<n>)", then the path
    assert out[0].split(" in ")[0] == ref_line.split(" in ")[0]
    assert out[0].split("(")[1] == ref_line.split("(")[1]
    assert out[1] == f"saved -> {pair / 'port.npy'}"
    ref = np.load(pair / "jax.npy")
    got = np.load(pair / "port.npy")
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float64
    assert len(got) > 200
    ref = ref[np.lexsort((ref[:, 1], ref[:, 0]))]
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    scale = 400 / 208                      # the file's frame over 160x208
    np.testing.assert_allclose(got[:, :4], ref[:, :4], atol=0.05 * scale)
    np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=1e-4)
    # in the file's frame: the second keypoints lie near H_TRUE's image
    p = np.concatenate([got[:, :2], np.ones((len(got), 1))], 1) @ H_TRUE.T
    err = np.linalg.norm(p[:, :2] / p[:, 2:] - got[:, 2:4], axis=1)
    assert np.median(err) < 1.5


@pytest.mark.parametrize("argv,match", [
    (["infer", "a.png", "b.png", "--seq-shard", "2"], "--seq-shard"),
    (["infer", "a.png", "b.png", "--int8-full", "--seq-shard", "4"],
     "item 3"),
])
def test_unported_flags_and_benchmarks_raise(pair, argv, match):
    """Flags the port does not take yet raise and name their ROADMAP item:
    after the int8 flags, only --seq-shard is left."""
    argv = [str(pair / a) if a.endswith(".png") else a for a in argv]
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv + ["--device", "cpu"])


def test_infer_fails_on_a_missing_file_before_the_model(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["infer", str(tmp_path / "none.png"),
                  str(tmp_path / "none.png"), "--device", "cpu"])


def test_eval_and_parity_run_the_hpatches_protocol(pair, tmp_path, capsys,
                                                   monkeypatch):
    """eval takes the benchmark's protocol (480, 3.0) unless overridden;
    parity gates the AUC block one-sidedly and exits 1 below it."""
    from geoformer_tpu_torch.eval import hpatches

    seen = []

    def fake(model, cfg, data, imsize, ransac_thr, max_seqs, device):
        seen.append((data, imsize, ransac_thr, max_seqs, device))
        return {"auc_a": [0.5, 0.7, 0.8, 0.9], "est_failed": 0,
                "n_pairs": 10, "mean_matches": 100.0}

    monkeypatch.setattr(hpatches, "eval_hpatches", fake)
    monkeypatch.setattr(cli, "_model", lambda args: (None, None))
    cli.main(["eval", "hpatches", "--data", "root", "--device", "cpu",
              "--json-out", str(tmp_path / "o.json")])
    cli.main(["eval", "hpatches", "--data", "root", "--imsize", "240",
              "--ransac-thr", "5", "--device", "cpu"])
    assert seen == [("root", 480, 3.0, None, "cpu"),
                    ("root", 240, 5.0, None, "cpu")]
    assert json.loads((tmp_path / "o.json").read_text())["n_pairs"] == 10
    capsys.readouterr()
    cli.main(["parity", "--hpatches", "root", "--device", "cpu",
              "--expect", "0.5,0.7,0.8,0.9"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["pass"] and rec["delta_pt"] == [0.0] * 4
    with pytest.raises(SystemExit) as e:
        cli.main(["parity", "--hpatches", "root", "--device", "cpu",
                  "--expect", "0.52,0.7,0.8,0.9"])
    assert e.value.code == 1


@pytest.mark.parametrize("benchmark,module,fn,proto", [
    ("fire", "fire", "eval_fire", (768, 15.0)),
    ("isc", "isc", "eval_isc", (480, 3.0)),
    ("isc-cls", "isc", "eval_isc_classification", (480, 3.0)),
])
def test_eval_fire_and_isc_take_the_protocol_defaults(benchmark, module, fn,
                                                      proto, monkeypatch):
    """The JAX CLI's protocols (imsize, RANSAC threshold) unless given,
    and the device flag."""
    import importlib

    mod = importlib.import_module(f"geoformer_tpu_torch.eval.{module}")
    seen = []

    def fake(model, cfg, data, imsize, ransac_thr, device):
        seen.append((data, imsize, ransac_thr, device))
        return {"n_pairs": 0}

    monkeypatch.setattr(mod, fn, fake)
    monkeypatch.setattr(cli, "_model", lambda args: (None, None))
    cli.main(["eval", benchmark, "--data", "root", "--device", "cpu"])
    cli.main(["eval", benchmark, "--data", "root", "--imsize", "96",
              "--ransac-thr", "2", "--device", "meta"])
    assert seen == [("root", *proto, "cpu"), ("root", 96, 2.0, "meta")]


JAX_EVAL_KEYS = {
    "fire": {"n_pairs", "failed", "inaccurate", "auc_per_class", "mAUC"},
    "isc": {"n_pairs", "failed", "inaccurate", "auc", "acceptable",
            "inlier_rate"},
    "isc-cls": {"eer", "threshold", "n_pairs", "match_failed"},
}


def test_eval_fire_isc_and_isc_cls_write_the_jax_keys(tmp_path, capsys):
    """The three benchmarks on a small corpus that the port's gate module
    builds (JPEG files), through `cli eval ... --device cpu` with the
    trained checkpoint: the --json-out record has the keys of the JAX
    drivers' (geoformer_tpu/eval/fire.py, isc.py)."""
    from geoformer_tpu_torch.eval import fire_isc_protocol as proto

    fire_dir, isc_dir = tmp_path / "fire", tmp_path / "isc"
    proto.build_fire(str(fire_dir), seed=1, size=96, n_s=1, n_p=0, n_a=0)
    proto.build_isc(str(isc_dir), seed=2, n_pairs=1)
    q = isc_dir / "query" / "isc000_2.jpg"
    (isc_dir / "cls.txt").write_text(
        f"{q} {isc_dir / 'refer' / 'isc000_1.jpg'} 1\n{q} {q} 0\n")
    for benchmark, data in (("fire", fire_dir), ("isc", isc_dir),
                            ("isc-cls", isc_dir / "cls.txt")):
        out = tmp_path / f"{benchmark}.json"
        cli.main(["eval", benchmark, "--data", str(data), "--ckpt", CKPT,
                  "--device", "cpu", "--json-out", str(out),
                  "--imsize", "64"])
        rec = json.loads(out.read_text())
        assert set(rec) == JAX_EVAL_KEYS[benchmark], benchmark
        assert rec["n_pairs"] == {"fire": 1, "isc": 1, "isc-cls": 2}[
            benchmark]
        printed = capsys.readouterr().out
        assert json.loads(printed[printed.index("\n{\n") + 1:]) == rec


def test_run_training_on_an_image_directory(tmp_path):
    """Two steps of the narrow test model at 64x80 from a directory of PNG
    and PPM files mixed half and half with the procedural bank; the loop
    writes its metrics and the final weights."""
    rng = np.random.default_rng(0)
    images = tmp_path / "images"
    images.mkdir()
    for i, ext in enumerate(("png", "ppm", "png")):
        tex = native.native_textures(1, 90, 120, seed=i)[0]
        img = np.round(tex * 255).astype(np.uint8)
        if ext == "ppm":
            img = np.stack([img, img, rng.integers(0, 256, img.shape,
                                                   np.uint8)], -1)
        cv2.imwrite(str(images / f"{i}.{ext}"), img)
    out = tmp_path / "run"
    run_training(image_dir=str(images), image_fraction=0.5, steps=2,
                 batch_size=2, image_hw=(64, 80), ckpt_dir=str(out),
                 log_every=1, bank_size=4, device="cpu",
                 model_cfg=port_config(small_config()))
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in lines)
    assert int(load_npz(str(out / "params_final.npz"))["step"]) == 2
