"""The HPatches gate's corpus builder (eval/hpatches_synth.py), gate module
(eval/hpatches_protocol.py) and parity drill (eval/parity_drill.py) of the
port against the JAX scripts.

Corpus: the JAX builder (scripts/hpatches_synth.py, loaded by path, with
cv2) and the port's build one cut corpus from the same seed: 2 i_ and 3 v_
sequences at the census's full sizes (min edge 480-960; two of the v_
sequences change size between images). Tolerances: the sequence names,
every image's size and the H_1_k files equal (as text); each image within
1 grey level and a mean difference under 0.01 level (measured: at most 1,
means 1e-4-3e-4; cv2 rounds the warp's positions to 1/32 px, the port's
warp does not). The port's warp_perspective at the source's size equals
native_warp within 1e-6 (measured 1.2e-7: the C++ build may fuse
multiply-adds).

Gate module and drill: on the first sequence of the port's corpus on the
CPU with the trained checkpoint, the module prints the JAX script's record
keys; the drill, on a torch checkpoint it writes through the port's own
converter, passes ``cli parity`` gated by the module's AUCs, and its AUCs
equal the module's exactly (the same weights, seeds and CPU).
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from geoformer_tpu_torch.data.native import native_warp  # noqa: E402
from geoformer_tpu_torch.eval import hpatches_protocol  # noqa: E402
from geoformer_tpu_torch.eval import hpatches_synth as hs  # noqa: E402
from geoformer_tpu_torch.eval import parity_drill  # noqa: E402
from geoformer_tpu_torch.eval.image_io import read_gray  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tpu_r3_main" / "params_final.npz"
CUT = dict(n_i=2, n_v=3, seed=0)


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    jroot = tmp_path_factory.mktemp("jax_corpus")
    proot = tmp_path_factory.mktemp("port_corpus")
    assert jax_script("hpatches_synth").build(str(jroot), **CUT) == 5
    assert hs.build(str(proot), **CUT) == 5
    return jroot, proot


def test_the_corpus_has_the_jax_names_sizes_and_homographies(corpora):
    jroot, proot = corpora
    names = sorted(p.name for p in jroot.iterdir())
    assert names == sorted(p.name for p in proot.iterdir()) == [
        "i_synth000", "i_synth001", "v_synth000", "v_synth001", "v_synth002"]
    changes = 0
    for seq in names:
        shapes = set()
        for i in range(1, 7):
            a = read_gray(str(jroot / seq / f"{i}.ppm"))
            b = read_gray(str(proot / seq / f"{i}.ppm"))
            assert a.shape == b.shape, (seq, i)
            shapes.add(a.shape)
            if i > 1:
                assert (jroot / seq / f"H_1_{i}").read_text() == \
                    (proot / seq / f"H_1_{i}").read_text(), (seq, i)
        changes += len(shapes) > 1
        assert min(min(s) for s in shapes) >= 480
    assert changes >= 1


@pytest.mark.parametrize("seq", ["i_synth000", "i_synth001", "v_synth000",
                                 "v_synth001", "v_synth002"])
def test_the_images_are_within_a_grey_level(corpora, seq):
    jroot, proot = corpora
    for i in range(1, 7):
        a = read_gray(str(jroot / seq / f"{i}.ppm")).astype(int)
        b = read_gray(str(proot / seq / f"{i}.ppm")).astype(int)
        d = np.abs(a - b)
        assert d.max() <= 1 and d.mean() < 0.01, (i, d.max(), d.mean())
        if i == 1:
            assert d.max() == 0            # the texture itself is exact


def test_the_files_are_binary_ppm_with_three_equal_channels(corpora):
    _, proot = corpora
    data = (proot / "v_synth001" / "3.ppm").read_bytes()
    head, _, _ = data.partition(b"\n255\n")
    assert head.startswith(b"P6\n")
    w, h = map(int, head.split(b"\n")[1].split())
    px = np.frombuffer(data[len(head) + 5:], np.uint8).reshape(h, w, 3)
    assert (px[..., 0] == px[..., 1]).all() and (px[..., 1] ==
                                                 px[..., 2]).all()


@pytest.mark.parametrize("seed", range(4))
def test_warp_perspective_equals_native_warp_at_equal_sizes(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(40, 120)), int(rng.integers(40, 120))
    img = rng.random((h, w)).astype(np.float32)
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    mag = (0.02, 0.1, 0.25, 0.6)[seed]
    H = hs.perspective_transform(
        src, src + (rng.uniform(-mag, mag, (4, 2)) * [w, h]).astype(
            np.float32))
    ref = native_warp(img[None], H[None])[0]
    got = hs.warp_perspective(img, H, (h, w))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_warp_perspective_to_another_size_keeps_the_convention():
    """An output larger than the source: the identity copies the source
    and leaves zeros outside it; a translation by (3, 2) moves it."""
    rng = np.random.default_rng(0)
    img = rng.random((30, 40)).astype(np.float32)
    out = hs.warp_perspective(img, np.eye(3), (50, 45))
    assert out.shape == (50, 45)
    np.testing.assert_array_equal(out[:30, :40], img)
    assert not out[30:].any() and not out[:, 40:].any()
    T = np.array([[1.0, 0, 3], [0, 1, 2], [0, 0, 1]])
    moved = hs.warp_perspective(img, T, (36, 44))
    np.testing.assert_array_equal(moved[2:32, 3:43], img)


def _rec_keys(path: Path, name: str):
    """The keys of the dict literal assigned to ``name`` in a script."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == name for t in node.targets):
            return [k.value for k in node.value.keys]
    raise LookupError(name)


@pytest.fixture(scope="module")
def gate_record(corpora):
    if not CKPT.is_file():
        pytest.skip("trained checkpoint not in this checkout")
    _, proot = corpora
    return hpatches_protocol.main(["--corpus", str(proot), "--ckpt",
                                   str(CKPT), "--max-seqs", "1",
                                   "--device", "cpu"])


def test_the_gate_module_prints_the_jax_record(gate_record):
    keys = _rec_keys(ROOT / "scripts" / "hpatches_protocol.py", "rec")
    assert list(gate_record) == keys
    assert gate_record["protocol"] == "hpatches_synth_540"
    assert gate_record["n_pairs"] == 5 and gate_record["est_failed"] == 0
    assert all(0 < a <= 1 for a in gate_record["auc_a"])
    assert gate_record["mma_i@3"] is not None


def test_the_drill_passes_parity_with_the_module_aucs(corpora, gate_record,
                                                      tmp_path, capsys):
    _, proot = corpora
    ckpt = tmp_path / "drill.ckpt"
    expect = ",".join(repr(a) for a in gate_record["auc_a"])
    code = parity_drill.main(["--npz", str(CKPT), "--corpus", str(proot),
                              "--ckpt-out", str(ckpt), "--expect", expect,
                              "--max-seqs", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    rec = json.loads([ln for ln in out if ln.startswith('{"auc_a"')][-1])
    assert code == 0 and rec["pass"] and rec["n_pairs"] == 5
    assert rec["auc_a"] == gate_record["auc_a"]
    assert rec["delta_pt"] == [0.0] * 4
    assert out[0] == f"fabricated torch checkpoint: {ckpt} (234 tensors)"
    assert ckpt.is_file()
