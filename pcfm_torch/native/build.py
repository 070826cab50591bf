"""Build + ctypes bindings for the port's native host-IO library (its own
copy of pcfm/native/build.py).

Compiles ``pcfm_torch/native/ply_io.cpp`` with ``g++ -O3 -shared -fPIC
-pthread`` at first use into ``pcfm_torch/_build/libpcfm_io.so``
(git-ignored; rebuilt when the source is newer) and exposes numpy-friendly
wrappers.  A process compiles into a file of its own and renames it into
place, so processes that build at once never load a half-written library.

Where the library cannot be built, the callers fall back to numpy as the
JAX package's do, and say so: ``available()`` tells whether the library
loaded, ``build()`` raises with the compiler's output, and ``parses``
counts the PLY bodies parsed natively (``pcfm_torch.data.ply.load_ply``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "ply_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libpcfm_io.so")
FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
parses = 0          # PLY bodies parsed by the library in this process


def build(force: bool = False) -> str:
    """Compile the library if it is missing, stale or ``force``; returns
    its path.  Raises RuntimeError with g++'s output when it fails."""
    if not force and os.path.isfile(LIB_PATH) and \
            os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {SRC}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ could not build {SRC}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.pcfm_ply_parse_ascii.restype = ctypes.c_int64
    lib.pcfm_ply_parse_ascii.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.pcfm_subsample_gather.restype = None
    lib.pcfm_subsample_gather.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The library (built at the first call); None when it cannot be
    built or loaded, once per process."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                _lib = _load(build())
            except (RuntimeError, OSError):
                _lib = None
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded in this process."""
    return get_lib() is not None


def parse_ascii_rows(body: bytes, ncols: int,
                     max_rows: int) -> Optional[np.ndarray]:
    """Parse whitespace rows of ``ncols`` floats from a PLY body.  Returns
    (rows, ncols) float32 (at most ``max_rows`` rows), or None if the
    native library is unavailable."""
    global parses
    lib = get_lib()
    if lib is None:
        return None
    if ncols <= 0 or max_rows < 0:
        raise ValueError(f"parse_ascii_rows: ncols {ncols}, max_rows "
                         f"{max_rows}")
    body = bytes(body)
    out = np.empty((max_rows, ncols), np.float32)
    n = lib.pcfm_ply_parse_ascii(
        body, len(body), ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_rows)
    parses += 1
    return out[:n]


def subsample_gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[k] = src[idx[k]] with threads (numpy where the library is
    unavailable).  ``src`` is (n, c), ``idx`` (k,) with every index in
    [0, n): an index outside raises IndexError on both paths."""
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    if src.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"subsample_gather: src {src.shape}, idx "
                         f"{idx.shape}; want (n, c) and (k,)")
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(f"subsample_gather: indices outside [0, "
                         f"{src.shape[0]})")
    lib = get_lib()
    if lib is None:
        return src[idx]
    out = np.empty((idx.shape[0], src.shape[1]), np.float32)
    lib.pcfm_subsample_gather(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[0], src.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.shape[0], out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
