"""ctypes binding of the data layer's host ops in native/dataops.cpp: the
covisibility random walk, the uint8 normalisation and the uint8 bilinear
resize with normalisation (the JAX package binds the same source in
mapanything_tpu/native.py).

The library is built from the unchanged source with g++ at first use, into
``build/host/`` at the repository root; its file name carries a hash of the
source and the flags, so an edited source rebuilds. Nothing is built at
import.

There is no fallback: the numpy walk (``BaseDataset._random_walk_sampling_py``)
draws other views from the same seed, and numpy's normalisation differs in
the last bits, so a silent fallback would change the samples training sees.
A library that does not build or load raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "dataops.cpp"
BUILD_DIR = ROOT / "build" / "host"
# no -fopenmp: the loader's worker threads already run one image each, and
# every op is elementwise or sequential, so the results do not depend on it
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            f"g++ not found on PATH: the data layer's host ops are built from "
            f"{SOURCE} at first use, and have no fallback")
    return found


def build() -> Path:
    """Compile the library if its hashed object is missing; returns its
    path. Raises RuntimeError naming g++ when the build fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing: the data layer's host ops "
                           "are built from it with g++")
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libdataops-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_compiler(), *GXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}) building the data layer's "
                f"host ops:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees old or new
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.covis_random_walk.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, i32p]
    lib.covis_random_walk.restype = ctypes.c_int
    lib.normalize_u8.argtypes = [u8p, ctypes.c_int, f32p, f32p, f32p]
    lib.normalize_u8.restype = None
    lib.resize_normalize_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p]
    lib.resize_normalize_u8.restype = None
    return lib


def covis_random_walk(covis: np.ndarray, num_samples: int, thres: float,
                      seed: int, max_retries: int = 4,
                      bidirectional: bool = True) -> np.ndarray:
    """Up to `num_samples` frame indices forming a connected walk on the
    thresholded covisibility graph (n x n), drawn from a 64-bit Mersenne
    Twister seeded with `seed`: the longest of `max_retries` walks."""
    covis = np.ascontiguousarray(covis, dtype=np.float32)
    if covis.ndim != 2 or covis.shape[0] != covis.shape[1]:
        raise ValueError(f"covisibility must be square, got {covis.shape}")
    if num_samples < 0:
        raise ValueError(f"num_samples must be >= 0, got {num_samples}")
    out = np.empty(num_samples, np.int32)
    n = load_library().covis_random_walk(
        covis, covis.shape[0], num_samples, float(thres), int(seed),
        int(max_retries), int(bidirectional), out)
    return out[:n]


def normalize_u8(img: np.ndarray, mean: np.ndarray,
                 std: np.ndarray) -> np.ndarray:
    """(img / 255 - mean) / std in float32 for a (..., 3) uint8 image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) channels, got {img.shape}")
    dst = np.empty(img.shape, np.float32)
    load_library().normalize_u8(
        img.reshape(-1), img.size, np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32), dst.reshape(-1))
    return dst


def resize_normalize_u8(img: np.ndarray, out_hw: tuple[int, int],
                        mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """A (H, W, 3) uint8 image resized to out_hw = (h, w) by torch's
    bilinear rule (align_corners=False), then (v / 255 - mean) / std, in
    float32."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    dh, dw = out_hw
    if dh <= 0 or dw <= 0:
        raise ValueError(f"the output size must be positive, got {out_hw}")
    dst = np.empty((dh, dw, 3), np.float32)
    load_library().resize_normalize_u8(
        img, img.shape[0], img.shape[1], dst, dh, dw,
        np.ascontiguousarray(mean, np.float32).reshape(3),
        np.ascontiguousarray(std, np.float32).reshape(3))
    return dst
