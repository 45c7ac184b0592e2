"""Build and load the package's CUDA kernels.

The kernels in ``geoformer_tpu_torch/csrc/*.cu`` have a plain C interface
and are compiled with ``nvcc`` for Hopper (``sm_90a``): one object per
source, all compiled at once, then linked into one shared library that is
loaded with ``ctypes``. The build runs at first use, on the machine with the
card, into ``geoformer_tpu_torch/_build/<hash of the sources>/``; a later
call with the same sources reuses it. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libgam_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported symbol -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "gam_box_window_attention": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    "gam_masked_kv_attention": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P),
    "gam_masked_kv_attention_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
        _I, _P),
    "gam_box_window_attention_bwd_dq": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
        _P),
    "gam_box_window_attention_bwd_dkv": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I, _F, _I, _P),
}


class BuildInfo(NamedTuple):
    """What a build did: library path, seconds, compiler output, and
    whether the library of these sources already existed."""

    path: Path
    seconds: float
    log: str
    cached: bool


_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    srcs, headers = _sources()
    h = hashlib.sha256()
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all; raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{o}")
    return "".join(outs)


def build() -> BuildInfo:
    """Compile the kernels if this version of the sources has no library."""
    digest = source_hash()
    out_dir = BUILD_DIR / digest
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return BuildInfo(lib_path, 0.0, "", cached=True)
    nvcc = find_nvcc()
    srcs, _ = _sources()
    tmp = BUILD_DIR / f"tmp-{digest}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    objs = [tmp / (s.stem + ".o") for s in srcs]
    log = _run_all([[nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(s), "-o",
                     str(o)] for s, o in zip(srcs, objs)])
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o",
                      str(tmp / LIB_NAME), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    try:
        tmp.rename(out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(lib_path, seconds, log, cached=False)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
