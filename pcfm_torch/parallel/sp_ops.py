"""The voxel ops and the max pool with the points of each cloud cut over
the ranks of the points axis — the port of pcfm/parallel/sp_ops.py and
sp_sorted.py.  The port has one voxel route (pcfm_torch/nn/pvconv.py),
so one module serves both.

The model has no attention: its only interactions across points are the
per-cloud reductions (coordinate normalisation, GroupNorm, BatchNorm),
the voxel grids and the max pools.  The stage cache is built by
``build_stage_cache(..., axis=axis)`` (pcfm_torch/ops/voxel_sorted.py):
the coordinates normalised over the whole cloud, this rank's points
sorted and planned locally (``sort_perm_by_voxel(..., axis=axis)``: the
window kernels of the JAX package and the scatter kernel here only need
the points of a tile to be near in voxel id, which a local sort gives as
well as a global one), and the counts of the whole cloud (the local count
grids all-reduced).  Then:

  * voxelize (``sp_avg_voxelize``, ``shmap_avg_voxelize_sorted``): this
    rank's scatter kernel with weights 1 / global count gives its partial
    grid; the partial grids are all-reduced into the mean grid, a replica
    on every rank of the axis.  Backward: the cotangents of the replicas
    are summed over the axis (the all-reduce's transpose), then this
    rank's K = 1 gather kernel takes its points' share.
  * devoxelize (``shmap_devox_sorted``): ``trilinear_devoxelize_sorted``
    as on one device: this rank's K = 8 gather kernel reads its own
    points from its replica of the grid.  Backward: this rank's K = 8
    scatter kernel, and no all-reduce.  The JAX package has one logical
    grid, so shard_map's transpose sums the grid's cotangent over the
    axis; here every rank computes its own replica of the grid (the
    convolutions, BatchNorm, SE after the voxelize), and a replica's
    cotangent is its own rank's: the voxelize's all-reduce sums them
    where the replicas were made (pcfm_torch/parallel/collectives.py
    states the rule).  Summing here as well would count the grid's
    parameters sp times.
  * max pool (``sp_global_max``, ``sp_global_max_local``): the local max,
    all-reduced; the gradient goes to the elements that attain it on any
    rank, split evenly over ties.

Collectives a PVConv: one (B, R^3, C) all-reduce forward and one
backward; a stage: one (B, R^3) count all-reduce; no point all-gather.
Every kernel launch is this rank's, on its N / sp points, so each rank
launches the kernels as many times as one device would.
"""
from __future__ import annotations

import torch

from pcfm_torch.ops.voxel_sorted import avg_voxelize_sorted
from pcfm_torch.parallel.collectives import all_reduce_max, all_reduce_sum


def sp_avg_voxelize(features: torch.Tensor, cache: dict,
                    resolution: int) -> torch.Tensor:
    """(B, N / sp, C) features -> the whole clouds' (B, R^3, C) fp32 mean
    grid, from a stage cache built with the points axis (``cache['sp']``;
    None: one rank's whole clouds)."""
    partial = avg_voxelize_sorted(features, cache["vox_ids"], resolution,
                                  plan=cache["plan"], inv_pt=cache["inv_pt"])
    return all_reduce_sum(partial, cache.get("sp"))


def sp_global_max(h: torch.Tensor, axis) -> torch.Tensor:
    """Max pool over the points (dim 1) of clouds cut over ``axis``."""
    return all_reduce_max(h, 1, axis)
