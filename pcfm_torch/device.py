"""Where an entry point runs: the card, unless the caller asks for the CPU.

The port's entry points (the sampling and training CLIs, ``load_run``,
``train``) take ``device=`` (and ``--device {cuda,cpu}``); the default is
CUDA, and a host without CUDA is an error, never a silent fall-back to the
CPU.
"""
from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(device=None) -> torch.device:
    """``device`` (None = "cuda") as a ``torch.device``; raises when CUDA is
    asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pcfm_torch runs on a CUDA device by default and this host has "
            "none; pass --device cpu (device=\"cpu\") to run on the CPU")
    return dev
