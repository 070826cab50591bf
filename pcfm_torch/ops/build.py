"""Build the port's CUDA kernels from the repo's sources, at first use.

Every ``pcfm_torch/csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``: no
PyTorch headers and no ninja, so a build takes seconds.  The library lands
in ``pcfm_torch/_build/`` (git-ignored) and is rebuilt when a source or a
header is newer than it.  A failed build raises with nvcc's output.

``use_kernel`` and ``check_launch`` are the wrappers' shared rules: a CUDA
tensor launches the kernel (a CPU tensor runs its plain version), and a
launch that returns an error raises with CUDA's message; ``current_device``
and ``stream_of`` give a launch its device and stream.
"""
from __future__ import annotations

import contextlib
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

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]


def sources() -> list:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def headers() -> list:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh")))


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
    return any(os.path.getmtime(s) > built for s in sources() + headers())


def _run_all(cmds: list) -> list:
    """Start every command at once; (cmd, returncode, output) for each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        results.append((cmd, proc.returncode, out))
    return results


def build(force: bool = False) -> dict:
    """Compile the kernels if the library is missing or stale.

    Returns ``{"path", "built", "seconds", "log"}``; ``log`` holds nvcc's
    output (ptxas register / shared-memory report) when it ran."""
    if not force and not is_stale():
        return {"path": LIB_PATH, "built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under private names, then rename: concurrent builders never
    # load a half-written library
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in sources()]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.perf_counter()
    try:
        results = _run_all([[nvcc(), *COMPILE_FLAGS, "-o", o, s]
                            for s, o in zip(sources(), objs)])
        if all(rc == 0 for _, rc, _ in results):
            results += _run_all([[nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp,
                                  *objs]])
        log = "".join(out for _, _, out in results)
        for cmd, rc, out in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed (exit {rc}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    seconds = time.perf_counter() - t0
    return {"path": LIB_PATH, "built": True, "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library (once per process)."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    lib.pcfm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pcfm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def use_kernel(x, what: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); no kernel exists for any other device."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return False


def current_device(x):
    """A context in which ``x``'s CUDA device is current, so that a kernel
    launched through the C interface runs there; nothing to do (and no
    cost) when it already is."""
    import torch
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def stream_of(x) -> int:
    """The handle of the current stream of ``x``'s device (the raw getter:
    ``torch.cuda.current_stream`` builds a Stream object on every call)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def check_launch(err: int, what: str) -> None:
    """Raise on the cudaError_t a kernel's C entry point returned."""
    if err != 0:
        msg = load_library().pcfm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")
