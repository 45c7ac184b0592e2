"""ctypes binding of the repository's texture generator (cpp/synthgen.cpp):
texture banks and the homography warp of host images.

The port's own binding: it compiles ``cpp/synthgen.cpp`` with ``g++`` at
first use into ``geoformer_tpu_torch/_build/<hash of the source and
flags>/libsynthgen.so`` (through a temporary directory renamed into place,
so concurrent first uses do not collide) and never writes into ``cpp/``.
The flags are those of ``cpp/Makefile``. A failed build raises; where
there is no compiler, build raises NoCompiler and the texture bank falls
back to the numpy textures (data/synthetic.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

REPO_DIR = Path(__file__).resolve().parent.parent.parent
SOURCE = REPO_DIR / "cpp" / "synthgen.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libsynthgen.so"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread",
         "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


class NoCompiler(FileNotFoundError):
    """No C++ compiler to build the generator with (neither $CXX nor g++)."""


def build() -> Path:
    """Compile the generator if this version of the source has no
    library; returns the library's path. Raises if g++ fails."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:16]
    out_dir = BUILD_DIR / f"synthgen-{digest}"
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NoCompiler("g++ not found: cannot build cpp/synthgen.cpp")
    tmp = BUILD_DIR / f"tmp-synthgen-{digest}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    r = subprocess.run([cxx, *FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"g++ failed ({r.returncode}) on {SOURCE}:\n"
                           f"{r.stderr}")
    try:
        tmp.rename(out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The loaded generator library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("synthgen_textures", "synthgen_textures_mixed"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                           ctypes.c_int]
            fn.restype = None
        lib.synthgen_warp.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.synthgen_warp.restype = None
        _lib = lib
    return _lib


def _textures(name: str, batch: int, h: int, w: int, seed: int,
              n_blobs: int) -> np.ndarray:
    if batch <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"texture bank shape {(batch, h, w)}")
    out = np.empty((batch, h, w), np.float32)
    getattr(load_library(), name)(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), batch, h, w,
        seed & 0xFFFFFFFFFFFFFFFF, n_blobs)
    return out


def native_textures(batch: int, h: int, w: int, seed: int,
                    n_blobs: int = 60) -> np.ndarray:
    """[batch, h, w] float32 structured textures in [0, 1]."""
    return _textures("synthgen_textures", batch, h, w, seed, n_blobs)


def native_textures_mixed(batch: int, h: int, w: int, seed: int,
                          n_blobs: int = 60) -> np.ndarray:
    """[batch, h, w] float32 training bank: structured, dead-leaves and fBm
    textures by index % 3."""
    return _textures("synthgen_textures_mixed", batch, h, w, seed, n_blobs)


def native_warp(src: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Warp [B, h, w] images by per-sample homographies [B, 3, 3] on the
    host (bilinear, zeros outside; cv2.warpPerspective's convention:
    dst(p) = src(H^-1 p), with H^-1 taken in float64)."""
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 3 or np.shape(H) != (len(src), 3, 3):
        raise ValueError(f"native_warp: images {src.shape}, H {np.shape(H)}")
    b, h, w = src.shape
    Hinv = np.ascontiguousarray(np.linalg.inv(np.asarray(H, np.float64)))
    dst = np.empty_like(src)
    load_library().synthgen_warp(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        Hinv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), b, h, w)
    return dst
