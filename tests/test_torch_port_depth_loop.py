"""The port's depth training loop, its validation metrics and the
train-depth command, on the CPU.

- run_depth_training on a corpus the port renders (data/depth_corpus.py:
  two train scenes and one val scene of three 96x128 views) for 3 steps
  at 64x64, batch 2, with a validation after steps 2 and 3: the
  metrics.jsonl lines carry the JAX loop's keys (the train step's
  scalars, held to JAX's in tests/test_torch_port_depth_step.py, with step
  and imgs_per_s; the pose AUCs, the epipolar precision and the val
  step's scalars, held in tests/test_torch_port_depth_val.py, with step);
  the rolling checkpoints (keep 3) and the auc@10-ranked ones in best/ are
  written as the JAX loop writes them; params_final.npz holds the step.
- resume: the restored state equals the saved one bit for bit, and a
  resumed run continues from the rolling directory.
- error_auc and aggregate_metrics equal the JAX functions;
  all_gather_metrics is the identity without a process group (the host
  pose estimator is held to cv2's in tests/test_torch_port_pose_host.py).
- `cli train-depth` has the JAX subcommand's dests and defaults plus
  --device (default cuda), and runs a step on the CPU.
"""

import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu import cli as jcli  # noqa: E402
from geoformer_tpu.eval import pose as jpose  # noqa: E402
from geoformer_tpu_torch import cli  # noqa: E402
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch.core.dist import all_gather_metrics  # noqa: E402
from geoformer_tpu_torch.data.depth_corpus import build_scene  # noqa: E402
from geoformer_tpu_torch.eval import pose as ppose  # noqa: E402
from geoformer_tpu_torch.train import checkpoint as ck  # noqa: E402
from geoformer_tpu_torch.train import depth_loop  # noqa: E402
from geoformer_tpu_torch.train.trainer import init_state  # noqa: E402
from geoformer_tpu_torch.weights import load_npz  # noqa: E402
from torch_port_util import port_config, small_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

HW = (64, 64)
TRAIN_KEYS = {"loss", "loss_c", "loss_d", "loss_f", "num_matches",
              "grad_norm", "lr", "step", "imgs_per_s"}
VAL_KEYS = {"auc@5", "auc@10", "auc@20", "prec@5e-04", "val_loss",
            "val_loss_c", "val_loss_d", "val_loss_f", "val_num_matches",
            "step"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_corpus")
    for name, index, seed in (("scene0000", "index", 1),
                              ("scene0001", "index", 2),
                              ("val0000", "index_val", 3)):
        build_scene(str(root), str(root / index), name, seed, n_cams=3,
                    hw=(96, 128), cluttered=True)
    return root


def _kw(corpus, out):
    return dict(npz_dir=str(corpus / "index"), root_dir=str(corpus),
                val_npz_dir=str(corpus / "index_val"), batch_size=2,
                image_hw=HW, ckpt_dir=str(out), log_every=1, val_every=2,
                n_val_batches=1, model_cfg=port_config(small_config()),
                depth_pad=128, device="cpu")


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    state, best = depth_loop.run_depth_training(steps=3,
                                                **_kw(corpus, out))
    return dict(out=out, state=state, best=best)


def _lines(out):
    return [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]


def test_metrics_lines_carry_the_jax_keys(trained):
    lines = _lines(trained["out"])
    assert [m["step"] for m in lines] == [1, 2, 2, 3, 3]
    for m in lines:
        assert set(m) == (VAL_KEYS if "auc@5" in m else TRAIN_KEYS), m
        assert all(np.isfinite(v) for v in m.values())
    assert trained["best"]["step"] in (2, 3)
    assert trained["state"].step == 3


def test_checkpoints_are_written_as_the_jax_loop_writes_them(trained):
    out = trained["out"]
    assert sorted(ck.checkpoint_steps(str(out))) == [2, 3]
    best = out / "best"
    assert sorted(ck.checkpoint_steps(str(best))) == [2, 3]
    for s in (2, 3):
        saved = json.loads((best / str(s) / ck.METRICS_FILE).read_text())
        line = [m for m in _lines(out) if m["step"] == s and "auc@10" in m]
        assert saved == {"auc@10": line[0]["auc@10"]}
    flat = load_npz(str(out / "params_final.npz"))
    assert int(flat["step"]) == 3


def test_resume_restores_bit_for_bit_and_continues(trained, corpus,
                                                   capsys):
    out = trained["out"]
    fresh = init_state(port_config(small_config()),
                       tcfg.TrainConfig(batch_size=2, image_hw=HW), seed=7,
                       device="cpu")
    back = ck.restore_checkpoint(str(out), fresh, require=True)
    a, b = back.model.state_dict(), trained["state"].model.state_dict()
    assert back.step == 3 and all(torch.equal(a[k], b[k]) for k in a)
    pa = dict(back.model.named_parameters())
    pb = dict(trained["state"].model.named_parameters())
    for k in pa:
        for slot in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(back.optimizer.state[pa[k]][slot],
                               trained["state"].optimizer.state[pb[k]][slot])
    kw = _kw(corpus, out)
    kw["val_npz_dir"] = None
    state, _ = depth_loop.run_depth_training(steps=4, resume=True, **kw)
    assert "resumed at step 3" in capsys.readouterr().out
    assert state.step == 4
    assert [m["step"] for m in _lines(out)][-1] == 4
    assert sorted(ck.checkpoint_steps(str(out))) == [2, 3, 4]


def test_error_auc_and_aggregate_match_jax():
    rng = np.random.default_rng(0)
    errs = np.concatenate([rng.exponential(8, 40), [np.inf, np.nan, 0.0]])
    assert ppose.error_auc(errs) == jpose.error_auc(errs)
    assert ppose.error_auc([], (5, 10)) == jpose.error_auc([], (5, 10))
    m = {"identifiers": ["a", "b", "a", "c"],
         "R_errs": [1.0, 30.0, 2.0, np.inf], "t_errs": [3.0, 1.0, 0.5, 4.0],
         "epi_errs": [rng.random(5) * 1e-3, rng.random(3) * 1e-3,
                      np.array([]), rng.random(7) * 1e-3]}
    assert ppose.aggregate_metrics(m) == jpose.aggregate_metrics(m)


def test_all_gather_metrics_is_the_identity_on_one_process():
    m = {"R_errs": np.arange(3.0), "identifiers": np.arange(3)}
    assert all_gather_metrics(m) is m


def _jax_parser(monkeypatch, name):
    """The JAX CLI's subparser ``name`` (geoformer_tpu/cli.py builds its
    parser inside main)."""
    class Built(Exception):
        pass

    def capture(self, *args, **kwargs):
        raise Built(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Built) as e:
        jcli.main()
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


def test_cli_train_depth_has_the_jax_flags(monkeypatch):
    req = ["--npz-dir", "a", "--root", "b"]
    ref = vars(_jax_parser(monkeypatch, "train-depth").parse_args(req))
    got = vars(cli.build_parser().parse_args(["train-depth", *req]))
    ref.pop("fn")
    got.pop("fn")
    assert got.pop("cmd") == "train-depth" and got.pop("device") == "cuda"
    assert got == ref


def test_cli_train_depth_one_step_on_the_cpu(corpus, tmp_path, capsys):
    cli.main(["train-depth", "--npz-dir", str(corpus / "index"), "--root",
              str(corpus), "--imsize", "64", "--batch", "1", "--steps", "1",
              "--depth-pad", "128", "--max-matches", "64",
              "--gam-ransac-iters", "32", "--gam-max-inliers", "64",
              "--out", str(tmp_path), "--device", "cpu"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert [m["step"] for m in out] == [1]
    assert int(load_npz(str(tmp_path / "params_final.npz"))["step"]) == 1
