"""Build the port's CUDA kernels from the repo's sources, at first use.

Every ``pcfm_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
``ctypes``: no PyTorch headers and no ninja, so a build takes seconds.  The
library lands in ``pcfm_torch/_build/`` (git-ignored) and is rebuilt when a
source is newer than it.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libpcfm_kernels.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> list:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from pcfm_torch/csrc at first "
                           "use")
    return found


def is_stale() -> bool:
    if not os.path.isfile(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build(force: bool = False) -> dict:
    """Compile the kernels if the library is missing or stale.

    Returns ``{"path", "built", "seconds", "log"}``; ``log`` holds nvcc's
    output (ptxas register / shared-memory report) when it ran."""
    if not force and not is_stale():
        return {"path": LIB_PATH, "built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, LIB_PATH)
    return {"path": LIB_PATH, "built": True, "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library (once per process)."""
    build()
    return ctypes.CDLL(LIB_PATH)
