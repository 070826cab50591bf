"""The (data, points) process grid — the port of pcfm/parallel/mesh.py.

The JAX package lays its devices out as a (data, points) mesh and lets
GSPMD derive every collective.  Here each rank is one process with one
device: rank ``r`` sits at data index ``r // sp`` and points index
``r % sp`` (the layout of ``make_mesh``'s ``reshape(dp, sp)``), and the
grid holds the process groups the port's collectives run over:

  * ``data``: the dp ranks that share a points index (one per data
    shard): the gradient-free batch statistics of replicated tensors
    (the voxel grids' BatchNorm) and the cross-batch loss terms;
  * ``points``: the sp ranks of one data shard, which hold the same
    clouds cut along the point axis: the voxel grids, the per-cloud
    reductions (coordinate normalisation, GroupNorm, max pools);
  * ``world``: all dp x sp ranks: the point BatchNorm statistics, the
    gradient average, the logged metrics.

Size rule: ``dp * sp`` equals the world size (``dp = -1``: world // sp);
any other layout is an error, never an idle rank.  Batch rule (JAX's
multi-process rule, ``data_axis_process_span``): every data shard loads
``batch_size`` clouds, so the global batch is ``batch_size * dp``; the sp
ranks of a shard load the same clouds and each keeps its block of N / sp
points (``shard_batch``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist


def auto_mesh_sizes(batch_size: int, n_points: int, dp: int = -1,
                    sp: int = 1, n_devices: Optional[int] = None):
    """Clamp requested (dp, sp) to sizes that divide (batch, points) and fit
    the device count; dp=-1 means as many as possible (a copy of
    pcfm/parallel/mesh.py:auto_mesh_sizes; ``n_devices`` defaults to the
    world size)."""
    n = n_devices if n_devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    sp = max(1, int(sp))
    while sp > 1 and (n_points % sp or n % sp):
        sp -= 1
    dp = (n // sp) if (dp is None or dp <= 0) else int(dp)
    dp = max(1, min(dp, n // sp))
    while dp > 1 and batch_size % dp:
        dp -= 1
    return dp, sp


def mesh_sizes(world: int, dp: int, sp: int, n_points: int):
    """(dp, sp) for ``world`` ranks by the size rule, or a ValueError."""
    sp = int(sp)
    if sp < 1 or world % sp:
        raise ValueError(f"sp={sp} does not divide the world size {world}")
    dp = world // sp if dp is None or dp <= 0 else int(dp)
    if dp * sp != world:
        raise ValueError(f"dp={dp} x sp={sp} = {dp * sp} ranks, but the "
                         f"world has {world}: dp * sp must equal WORLD_SIZE "
                         "(dp=-1 takes WORLD_SIZE // sp)")
    if n_points % sp:
        raise ValueError(f"sp={sp} does not divide the {n_points} points "
                         "of a cloud")
    return dp, sp


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the grid as seen from this rank: its process ``group``,
    its ``size`` and this rank's ``index`` along it."""
    group: object
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    dp: int
    sp: int
    rank: int
    data: Axis
    points: Axis
    world: Axis

    @property
    def size(self) -> int:
        return self.dp * self.sp


def make_grid(dp: int, sp: int, n_points: int) -> ProcessGrid:
    """The grid over the default process group (every rank calls this, in
    the same order: ``new_group`` is collective).  Without a group it is
    the one-rank grid."""
    if not dist.is_initialized():
        dp, sp = mesh_sizes(1, dp, sp, n_points)
        one = Axis(None, 1, 0)
        return ProcessGrid(dp, sp, 0, one, one, one)
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, sp = mesh_sizes(world, dp, sp, n_points)
    di, pi = divmod(rank, sp)
    data = points = None
    for p in range(sp):         # the data axis: one group per points index
        g = dist.new_group([d * sp + p for d in range(dp)])
        if p == pi:
            data = g
    for d in range(dp):         # the points axis: one group per data index
        g = dist.new_group([d * sp + p for p in range(sp)])
        if d == di:
            points = g
    return ProcessGrid(dp, sp, rank, Axis(data, dp, di), Axis(points, sp, pi),
                       Axis(dist.group.WORLD, world, rank))


def data_axis_shard(grid: Optional[ProcessGrid]) -> tuple:
    """(shard_index, num_shards) this rank's loader uses: the ranks of one
    points group load the same clouds (pcfm/parallel/mesh.py:110)."""
    if grid is None:
        return 0, 1
    return grid.data.index, grid.dp


def _block(size: int, axis: Axis, what: str) -> slice:
    if size % axis.size:
        raise ValueError(f"{what} of {size} does not split over "
                         f"{axis.size} ranks")
    step = size // axis.size
    return slice(axis.index * step, (axis.index + 1) * step)


def batch_block(grid: Optional[ProcessGrid], b: int) -> slice:
    """This rank's rows of a global batch of ``b`` clouds."""
    return slice(0, b) if grid is None else _block(b, grid.data, "a batch")


def point_block(grid: Optional[ProcessGrid], n: int) -> slice:
    """This rank's points of a cloud of ``n`` points."""
    return slice(0, n) if grid is None else _block(n, grid.points, "a cloud")


def shard_batch(batch: dict, grid: Optional[ProcessGrid],
                data_sharded: bool = False) -> dict:
    """This rank's (B / dp, N / sp) block of a batch dict (the counterpart
    of pcfm/parallel/mesh.py:shard_batch): arrays of 3 or more dims are cut
    on the batch and point axes, arrays of 1 or 2 dims on the batch axis,
    anything else is kept.  ``data_sharded``: the batch axis already is
    this data shard's (a loader batch), so only the points are cut."""
    if grid is None:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "ndim") or v.ndim < 1:
            out[k] = v
            continue
        rows = slice(None) if data_sharded else batch_block(grid, v.shape[0])
        out[k] = v[rows, point_block(grid, v.shape[1])] if v.ndim >= 3 \
            else v[rows]
    return out
