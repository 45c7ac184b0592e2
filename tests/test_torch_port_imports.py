"""The port stands alone: torch, numpy and the standard library only.

Neither geoformer_tpu_torch nor chip_smoke.py may import JAX, flax, the
JAX package, cv2, h5py, PIL, matplotlib or scipy (the card's machine has
none of them but scipy, and the port needs none), and chip_smoke.py must
fail, printing no result, where there is no CUDA device or no port.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "geoformer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "geoformer_tpu",
             "cv2", "PIL", "kornia", "matplotlib", "h5py", "scipy"}
ALLOWED = {"torch", "numpy", "geoformer_tpu_torch"}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
OK_LINE = '{"ok": true'


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_only_torch_numpy_stdlib(path):
    roots = set(_imported_roots(path))
    assert not roots & FORBIDDEN, (path, roots & FORBIDDEN)
    others = {r for r in roots
              if r not in ALLOWED and r not in sys.stdlib_module_names
              and r != "__future__"}
    assert not others, (path, others)


def test_the_walk_covers_the_sequence_parallel_modules():
    for rel in ("core/spmd.py", "core/mesh.py", "core/dist.py"):
        assert PORT / rel in FILES, rel


def test_every_port_module_imports_without_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT.rglob("*.py")]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_reads_no_data_file():
    """No data file of the repository but the trained checkpoints, which
    phase 8 reads through the port's loader (and, with it, the held-out
    photographs through the port's self-check) and phase 12 through
    eval/depth_gate.py; the files phases 7 and 12 decode they write
    themselves."""
    src = (ROOT / "chip_smoke.py").read_text()
    for word in ("imread", "open(", ".jpg", "torch.load", "load_npz",
                 "holdout"):
        assert word not in src, word
    assert src.count('"checkpoints"') == 1
    assert ('CKPT = REPO / "checkpoints" / "tpu_r3_main" / '
            '"params_final.npz"') in src


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_cuda_device():
    r = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert OK_LINE not in r.stdout
    assert "no CUDA device" in r.stderr


def test_chip_smoke_fails_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert OK_LINE not in r.stdout


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from geoformer_tpu_torch.ops import cuda_lib

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed at its default path")
    with pytest.raises(FileNotFoundError, match="nvcc"):
        cuda_lib.find_nvcc()


def test_kernel_sources_and_hash():
    from geoformer_tpu_torch.ops import cuda_lib

    names = {p.name for p in cuda_lib.CSRC_DIR.glob("*.cu")}
    assert names == {"box_window_attention.cu", "masked_kv_attention.cu",
                     "box_window_attention_bwd.cu",
                     "masked_kv_attention_bwd.cu", "streaming_match.cu"}
    for p in cuda_lib.CSRC_DIR.glob("*.cu"):
        src = p.read_text()
        assert "torch/extension.h" not in src
        assert 'extern "C"' in src and "cudaGetLastError" in src
    h = cuda_lib.source_hash()
    assert len(h) == 16 and h == cuda_lib.source_hash()
    assert set(cuda_lib.SIGNATURES) == {
        "gam_box_window_attention", "gam_masked_kv_attention",
        "gam_masked_kv_attention_bwd", "gam_box_window_attention_bwd_dq",
        "gam_box_window_attention_bwd_dkv", "gam_streaming_match_lse",
        "gam_streaming_match_argmax"}
    for name in cuda_lib.SIGNATURES:
        assert sum(f'"C" int {name}(' in p.read_text()
                   for p in cuda_lib.CSRC_DIR.glob("*.cu")) == 1, name


def _c_prototypes():
    """exported symbol -> its parameter list, from the CUDA sources."""
    import re

    from geoformer_tpu_torch.ops import cuda_lib

    protos = {}
    for p in cuda_lib.CSRC_DIR.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             p.read_text()):
            protos[m.group(1)] = [a.strip() for a in m.group(2).split(",")]
    return protos


def _ctype_of(param: str):
    import ctypes

    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[param.split()[0]]


@pytest.mark.parametrize("name", [
    "gam_box_window_attention", "gam_masked_kv_attention",
    "gam_masked_kv_attention_bwd", "gam_box_window_attention_bwd_dq",
    "gam_box_window_attention_bwd_dkv", "gam_streaming_match_lse",
    "gam_streaming_match_argmax"])
def test_signatures_follow_the_c_prototypes(name):
    """ctypes passes each argument as SIGNATURES types it: a pointer or the
    stream as c_void_p, an int as c_int, a float as c_float, one for one
    with the C declaration (a pointer typed as an int would be cut)."""
    from geoformer_tpu_torch.ops import cuda_lib

    params = _c_prototypes()[name]
    assert list(cuda_lib.SIGNATURES[name]) == [_ctype_of(p) for p in params]


def test_the_int8_and_alternate_modules_are_walked():
    """The modules of the int8 paths and the forward's alternates are
    among the files the AST walk and the import run cover."""
    new = {"ops/quantize.py", "ops/sinkhorn.py", "ops/nms.py",
           "eval/nn_matching.py", "models/loftr.py"}
    walked = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert new <= walked, new - walked
