"""Native (C++) host-IO components, loaded through ctypes: the port's copy
of pcfm/native.

Fast ASCII PLY parsing and a threaded subsample-gather for the input
pipeline (host code, not a CUDA kernel).  Callers fall back to numpy where
no C++ compiler builds the library; ``available()`` says which.
"""
from pcfm_torch.native.build import (available, get_lib, parse_ascii_rows,
                                     subsample_gather)

__all__ = ["available", "get_lib", "parse_ascii_rows", "subsample_gather"]
