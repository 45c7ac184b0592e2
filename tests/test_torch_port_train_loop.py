"""The port's training loop at full length against the JAX package.

- Data: make_pair_batch(sensor=True) with every draw injected (the JAX
  key splits of data/synthetic.py:230-257 and augment.py); the base-image
  stream with bank_refresh, bit for bit, with the texture library on (the
  JAX stream is handed the port's build of the same cpp/synthgen.cpp,
  since the JAX binding builds into cpp/) and off in both packages (the
  numpy textures, copied, bit for bit).
- State checkpoints: a bit-exact round trip (parameters, running
  statistics, both AdamW moments, the step count), the next step from a
  restored state equal to the next step of the saved one, keep=5, the
  monitored top-k, require=True, and a crash while writing.
- run_training: a resumed run's first base batch is the JAX stream's at
  seed + 1_000_003 * k, and 2 steps then 2 resumed steps leave the
  checkpoints {2, 4} and metrics.jsonl steps 1-4.
- cli train: the JAX train subcommand's dests and defaults, plus
  --device; a 2-step run on the CPU writes its files.

Tolerances: pair images after the sensor stack as in
tests/test_torch_port_augment.py (JPEG: all but 1 % of the pixels within
1e-5, every pixel within a flipped coefficient's reach); homographies at
1e-5 rel, masks exactly.
"""

import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import geoformer_tpu.cli as jcli  # noqa: E402
from geoformer_tpu.data import native as j_native  # noqa: E402
from geoformer_tpu.data import synthetic as jsyn  # noqa: E402
from geoformer_tpu_torch import cli  # noqa: E402
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch.data import native  # noqa: E402
from geoformer_tpu_torch.data import synthetic as tsyn  # noqa: E402
from geoformer_tpu_torch.train import checkpoint as ck  # noqa: E402
from geoformer_tpu_torch.train import loop  # noqa: E402
from geoformer_tpu_torch.train.trainer import (  # noqa: E402
    init_state,
    make_train_step,
)
from geoformer_tpu_torch.weights import load_npz  # noqa: E402
from test_torch_port_augment import _assert_jpeg_close, jax_draws  # noqa: E402
from test_torch_port_train_data import HW, jax_pair_draws  # noqa: E402
from torch_port_util import assert_close, n, port_config, small_config, t  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

TINY = (24, 32)          # numpy-texture banks: 64 images a bank


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_pair_batch_with_sensor_matches_jax(seed):
    b = 6
    base = np.random.default_rng(seed).random((b, *HW)).astype(np.float32)
    key = jax.random.key(seed)
    ref = jsyn.make_pair_batch(jnp.asarray(base), key, sensor=True)
    draws = jax_pair_draws(key, b, HW)
    ks0, ks1 = jax.random.split(jax.random.split(key, 6)[5])
    for view, k in (("sensor0", ks0), ("sensor1", ks1)):
        draws[view] = jax_draws("sensor", k, (b, *HW, 1))
    got = tsyn.make_pair_batch(t(base), draws=draws, sensor=True)
    q = np.minimum(n(draws["sensor0"]["jpeg"]["quality"]),
                   n(draws["sensor1"]["jpeg"]["quality"]))
    for name in ("image0", "image1"):
        _assert_jpeg_close(got[name], np.asarray(ref[name]), q)
    for name in ("H_0to1", "H_1to0"):
        assert_close(got[name], ref[name], 1e-5, 1e-4, name)
    for name in ("mask0", "mask1"):
        np.testing.assert_array_equal(n(got[name]), np.asarray(ref[name]))


@pytest.fixture
def jax_native_is_the_ports(monkeypatch):
    """The JAX stream's texture library is the port's build."""
    monkeypatch.setattr(j_native, "native_textures_mixed",
                        native.native_textures_mixed)
    monkeypatch.setattr(j_native, "native_textures", native.native_textures)


@pytest.mark.parametrize("style", ["mixed", "structured"])
def test_stream_with_bank_refresh_matches_jax(style, jax_native_is_the_ports):
    kw = dict(seed=5, texture_style=style, bank_size=4, bank_refresh=2)
    ref = jsyn.base_image_stream((48, 64), 3, **kw)
    got = tsyn.base_image_stream((48, 64), 3, **kw)
    for _ in range(5):          # banks from seeds 5, 5 + 1009, 5 + 2018
        np.testing.assert_array_equal(next(got), next(ref))


@pytest.mark.parametrize("fn", ["procedural_texture", "dead_leaves_texture",
                                "fbm_texture"])
def test_numpy_textures_match_jax(fn):
    ref = getattr(jsyn, fn)(np.random.default_rng(3), (40, 56))
    got = getattr(tsyn, fn)(np.random.default_rng(3), (40, 56))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tsyn._value_noise(np.random.default_rng(4), (40, 56), 8),
        jsyn._value_noise(np.random.default_rng(4), (40, 56), 8))
    np.testing.assert_array_equal(
        tsyn.mixed_texture_bank(np.random.default_rng(5), (24, 32), 3),
        jsyn.mixed_texture_bank(np.random.default_rng(5), (24, 32), 3))


@pytest.mark.parametrize("style,refresh,batches", [("mixed", 0, 2),
                                                   ("structured", 1, 3)])
def test_stream_without_the_library_matches_jax(style, refresh, batches,
                                                monkeypatch, capsys):
    """No compiler: the port falls back to the numpy textures (one line
    says so), and so does the JAX package without its library."""
    def no_compiler(*args, **kwargs):
        raise native.NoCompiler("g++ not found")

    monkeypatch.setattr(tsyn, "native_textures_mixed", no_compiler)
    monkeypatch.setattr(tsyn, "native_textures", no_compiler)
    monkeypatch.setattr(j_native, "native_textures_mixed",
                        lambda *a, **k: None)
    monkeypatch.setattr(j_native, "native_textures", lambda *a, **k: None)
    kw = dict(seed=9, texture_style=style, bank_size=8, bank_refresh=refresh)
    ref = jsyn.base_image_stream(TINY, 4, **kw)
    got = tsyn.base_image_stream(TINY, 4, **kw)
    for _ in range(batches):
        np.testing.assert_array_equal(next(got), next(ref))
    assert "numpy textures" in capsys.readouterr().out


def test_a_failed_build_still_raises(monkeypatch):
    def failed(*args, **kwargs):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(tsyn, "native_textures_mixed", failed)
    with pytest.raises(RuntimeError):
        next(tsyn.base_image_stream(TINY, 2, bank_size=4))


# ---------------------------------------------------------- checkpoints --

B, H, W = 2, 64, 80


def _state(seed=0):
    cfg = port_config(small_config())
    tc = tcfg.TrainConfig(batch_size=B, image_hw=(H, W))
    return init_state(cfg, tc, seed, "cpu"), make_train_step(tc)


def _pair(seed):
    base = torch.rand((B, H, W), generator=torch.Generator().manual_seed(seed))
    return tsyn.make_pair_batch(base, torch.Generator().manual_seed(seed))


def _step(state, step_fn, seed):
    return step_fn(state, _pair(seed), 1e-3,
                   generator=torch.Generator().manual_seed(seed))


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    pa = dict(a.model.named_parameters())
    pb = dict(b.model.named_parameters())
    for name in pa:
        oa, ob = a.optimizer.state[pa[name]], b.optimizer.state[pb[name]]
        for slot in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[slot], ob[slot]), (name, slot)


@pytest.fixture(scope="module")
def trained():
    state, step_fn = _state()
    _step(state, step_fn, 1)
    return state, step_fn


def test_checkpoint_round_trip_is_bit_exact(trained, tmp_path):
    state, step_fn = trained
    ck.save_checkpoint(str(tmp_path), state, state.step)
    with np.load(tmp_path / "1" / ck.STATE_FILE, allow_pickle=False) as z:
        keys = set(z.files)
    names = set(ck.state_dict_to_jax(state.model))
    assert names <= keys and {"step", "opt_state/count"} <= keys
    assert any(k.startswith("opt_state/mu/") for k in keys)
    fresh, _ = _state(seed=7)
    back = ck.restore_checkpoint(str(tmp_path), fresh, require=True)
    assert back is fresh
    _assert_same_state(back, state)
    # the next step from the restored state is the saved one's next step
    a = _step(back, step_fn, 2)
    b = _step(state, step_fn, 2)
    assert {k: float(v) for k, v in a.items()} == \
        {k: float(v) for k, v in b.items()}
    _assert_same_state(back, state)


def test_checkpoint_keeps_the_five_newest(trained, tmp_path):
    state, _ = trained
    for s in range(1, 8):
        ck.save_checkpoint(str(tmp_path), state, s)
    assert sorted(ck.checkpoint_steps(str(tmp_path))) == [3, 4, 5, 6, 7]
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


@pytest.mark.parametrize("mode,best", [("max", [2, 4, 5]),
                                       ("min", [1, 3, 6])])
def test_monitored_checkpoint_keeps_the_best(trained, tmp_path, mode, best):
    state, _ = trained
    ck.save_checkpoint(str(tmp_path), state, 100)     # no metric: kept
    for s, v in zip(range(1, 7), [0.1, 0.9, 0.3, 0.7, 0.8, 0.2]):
        ck.save_checkpoint_monitored(str(tmp_path), state, s,
                                     {"auc@10": v}, mode=mode, keep=3)
    assert sorted(ck.checkpoint_steps(str(tmp_path))) == best + [100]


def test_restore_without_a_checkpoint(trained, tmp_path):
    state, _ = trained
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path / "none"), state, require=True)
    assert ck.restore_checkpoint(str(tmp_path), state) is state


def test_a_crash_while_writing_keeps_the_earlier_steps(trained, tmp_path,
                                                      monkeypatch):
    state, _ = trained
    ck.save_checkpoint(str(tmp_path), state, 1)

    def crash(path, **arrays):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.np, "savez", crash)
    with pytest.raises(OSError):
        ck.save_checkpoint(str(tmp_path), state, 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1"]


# ------------------------------------------------------------ the loop ----

def _run(tmp_path, steps, **kw):
    return loop.run_training(
        steps=steps, batch_size=B, image_hw=(H, W), ckpt_dir=str(tmp_path),
        log_every=1, model_cfg=port_config(small_config()), bank_size=3,
        device="cpu", **kw)


def test_resume_continues_with_moved_data_seeds(tmp_path, monkeypatch,
                                                capsys,
                                                jax_native_is_the_ports):
    _run(tmp_path, 2)
    first = []

    def recording_stream(*args, **kwargs):
        stream = tsyn.base_image_stream(*args, **kwargs)
        first.append(next(stream))
        yield first[0]
        yield from stream

    monkeypatch.setattr(loop, "base_image_stream", recording_stream)
    state = _run(tmp_path, 4, resume=True)
    assert state.step == 4
    assert "resumed at step 2" in capsys.readouterr().out
    ref = next(jsyn.base_image_stream((H, W), B, 66 + 1_000_003 * 2,
                                      bank_size=3))
    np.testing.assert_array_equal(first[0], ref)
    assert sorted(ck.checkpoint_steps(str(tmp_path))) == [2, 4]
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2, 3, 4]
    assert int(load_npz(str(tmp_path / "params_final.npz"))["step"]) == 4


def test_resume_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _run(tmp_path, 2, resume=True)


def test_checkpoints_every_ckpt_every_steps_and_at_the_end(tmp_path):
    state = _run(tmp_path, 3, ckpt_every=2)
    assert sorted(ck.checkpoint_steps(str(tmp_path))) == [2, 3]
    back, _ = _state(seed=5)
    ck.restore_checkpoint(str(tmp_path), back)
    _assert_same_state(back, state)


# ------------------------------------------------------------- cli train --

def _jax_train_parser(monkeypatch):
    """The JAX CLI's train subparser (geoformer_tpu/cli.py builds its
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
    return sub.choices["train"]


def test_cli_train_has_the_jax_flags(monkeypatch):
    ref = vars(_jax_train_parser(monkeypatch).parse_args([]))
    got = vars(cli.build_parser().parse_args(["train"]))
    ref.pop("fn")
    got.pop("fn")
    assert got.pop("cmd") == "train" and got.pop("device") == "cuda"
    assert got == ref


def test_cli_train_two_steps_on_the_cpu(tmp_path, capsys):
    cli.main(["train", "--steps", "2", "--batch", "1", "--height", "64",
              "--width", "80", "--out", str(tmp_path), "--log-every", "1",
              "--bank-size", "2", "--device", "cpu"])
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert [json.loads(ln)["step"] for ln in out] == [1, 2]
    assert (tmp_path / "metrics.jsonl").is_file()
    assert int(load_npz(str(tmp_path / "params_final.npz"))["step"]) == 2
    assert sorted(ck.checkpoint_steps(str(tmp_path))) == [2]
