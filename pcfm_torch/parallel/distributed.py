"""Process-group bootstrap — the port of pcfm/parallel/distributed.py, with
torchrun's environment as the reference's own (util.py:71-90).

``torchrun --nproc_per_node=N -m pcfm_torch.train.cli ...`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
``init_distributed`` reads them and joins the group (NCCL for a CUDA run,
gloo for a CPU run).  Multi-host is the same code with torchrun's
``--nnodes``.  A caller that has already initialised a group (a test's
gloo group over ``file://``, or ranks that share one card) keeps it: it
is used as it is and ``cleanup_distributed`` leaves it to that caller.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

# whether this module created the default group (and so destroys it)
_OWNED = {"group": False}


def local_rank() -> int:
    """``LOCAL_RANK`` from torchrun (0 without it)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(device=None) -> Tuple[bool, int, int]:
    """Join the default process group when the environment asks for it.

    Returns (is_distributed, rank, world): (False, 0, 1) without torchrun's
    variables, and the group's own values when the caller initialised one.
    ``device`` picks the backend: NCCL for CUDA (``cuda:LOCAL_RANK`` is
    made current first), gloo for the CPU."""
    if dist.is_initialized():
        return True, dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return False, 0, 1
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.set_device(cuda_device(device))
    dist.init_process_group(backend="nccl" if cuda else "gloo",
                            init_method="env://",
                            rank=int(os.environ.get("RANK", 0)),
                            world_size=int(os.environ["WORLD_SIZE"]))
    _OWNED["group"] = True
    return True, dist.get_rank(), dist.get_world_size()


def cuda_device(device=None) -> torch.device:
    """The card of this rank: ``device`` when it names one (``cuda:1``),
    else ``cuda:LOCAL_RANK``; a local rank with no card is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is not None:
        return dev
    idx, count = local_rank(), torch.cuda.device_count()
    if idx >= count:
        raise RuntimeError(f"LOCAL_RANK={idx} but this host has {count} "
                           "CUDA device(s): start at most one rank a card")
    return torch.device("cuda", idx)


def cleanup_distributed() -> None:
    """Leave the group if ``init_distributed`` created it."""
    if _OWNED["group"] and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED["group"] = False
