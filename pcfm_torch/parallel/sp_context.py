"""Process-level grid context — the port of pcfm/parallel/sp_context.py.

The modules that reduce over the batch or over the points (the voxel ops,
ContextNet, the encoder's pool, BatchNorm, GroupNorm, the train step's
cross-batch losses) sit many modules deep, and sampling and validation
call the same modules on whole clouds.  So, as in the JAX package, the
grid is a process-level context: the train loop calls
``set_sp_group(grid)`` once, and each module asks at call time for the
axis it reduces over (``sp_axis``, ``stats_axis``, ``data_axis``).  With
no grid set, or an axis of size 1, every module runs exactly as on one
device.  ``suspended()`` clears it for work that one rank does alone on
whole clouds (the loop's validation).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from pcfm_torch.parallel.mesh import Axis, ProcessGrid

_GRID = {"grid": None}


def set_sp_group(grid: Optional[ProcessGrid]) -> None:
    """Install (or clear, with None) the grid the modules reduce over."""
    _GRID["grid"] = grid


def get_grid() -> Optional[ProcessGrid]:
    return _GRID["grid"]


def _live(axis: Axis) -> Optional[Axis]:
    return axis if axis.size > 1 else None


def sp_axis() -> Optional[Axis]:
    """The points axis, when the clouds are cut over more than one rank
    (the counterpart of ``sp_mesh_for``); else None."""
    grid = get_grid()
    return None if grid is None else _live(grid.points)


def data_axis() -> Optional[Axis]:
    """The data axis, when the batch is cut over more than one rank."""
    grid = get_grid()
    return None if grid is None else _live(grid.data)


def stats_axis(over: str) -> Optional[Axis]:
    """The axis a BatchNorm's statistics reduce over: every rank for point
    features (``over="points"``: dp x sp), the data axis for a voxel grid
    (``over="grid"``: the grid is replicated over the points axis)."""
    grid = get_grid()
    if grid is None:
        return None
    return _live(grid.world if over == "points" else grid.data)


def world_axis() -> Optional[Axis]:
    grid = get_grid()
    return None if grid is None else _live(grid.world)


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """No grid inside: one rank computes on whole clouds."""
    saved = get_grid()
    set_sp_group(None)
    try:
        yield
    finally:
        set_sp_group(saved)
