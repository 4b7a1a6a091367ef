"""Builds the package's CUDA kernels at first use.

Each library is compiled by ``nvcc`` from the sources under
``mapanything_tpu_torch/csrc/`` into a shared object with a plain C
interface, then loaded with ``ctypes``. The object's file name carries a hash
of its sources, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one is reused. The build directory
is ``build/kernels`` at the repository root (listed in ``.gitignore``).

Nothing here runs at import: the first call of :func:`load_library` builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# library name -> sources under csrc/
LIBRARIES = {
    "flash_attn_fwd": ("flash_attn_fwd.cu",),
    "flash_attn_bwd": ("flash_attn_bwd.cu",),
}


BUILD_DIR = CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built from source at first use")


def build_library(name: str) -> tuple[Path, str]:
    """Compile library `name` if its hashed object is missing.

    Returns (path of the shared object, compiler log; empty when reused).
    """
    sources = [CSRC / s for s in LIBRARIES[name]]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_DIR
    out = out_dir / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees old or new
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def build_all() -> dict[str, tuple[Path, str, float]]:
    """Build every library at once, one nvcc process each, in parallel.

    Returns {name: (path, compiler log, seconds)}; raises the first build's
    error after all have finished.
    """
    def timed(name):
        t0 = time.perf_counter()
        path, log = build_library(name)
        return path, log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = {name: pool.submit(timed, name) for name in LIBRARIES}
    return {name: fut.result() for name, fut in futures.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library `name`, once per process."""
    path, _ = build_library(name)
    return ctypes.CDLL(str(path))
