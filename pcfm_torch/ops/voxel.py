"""Voxel coordinate math and the plain voxel ops — port of pcfm/ops/voxel.py.

* ``normalize_coords`` — the reference's coordinate normalisation
  (modules/voxelization.py:16-25): mean-centre, divide by twice the max
  point norm (+ eps), + 0.5, scale by R, clamp to [0, R-1]; rounded
  (half to even, as ``jnp.round``) to int32 voxel coordinates.  Always
  fp32 and detached (the reference detaches coords).  With the points of
  a cloud cut over the ranks of an ``axis`` (point-axis parallelism), the
  mean and the max norm are the whole cloud's: the sums, the counts and
  the max are all-reduced, as GSPMD reduces them for the JAX package
  (pcfm/parallel/sp_sorted.py:59-61).
* ``flatten_voxel_ids`` — ``x * R^2 + y * R + z``.
* ``avg_voxelize`` / ``trilinear_devoxelize`` — the plain scatter-mean and
  8-corner trilinear gather on (B, R, R, R, C) grids: the oracle the
  kernels' wrappers (pcfm_torch/ops/voxel_sorted.py) are tested against.
* ``corner_ids_weights`` — the 8 corner ids and weights of each point with
  the reference's frac == 0 collapse (trilinear_devox.cu:64-75): a corner
  whose fractional part is 0 reuses the low index, with weight 0 on the
  high side.

Channel-last throughout, as in the JAX package: features (B, N, C), grids
(B, R, R, R, C) or flat (B, R^3, C).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from pcfm_torch.parallel.collectives import reduce_no_grad


def _cloud_mean(coords: torch.Tensor, axis) -> torch.Tensor:
    """(B, 1, 3) mean of each cloud; over every rank's points with an
    ``axis`` (one all-reduce of the sums and the counts)."""
    if axis is None:
        return coords.mean(dim=1, keepdim=True)
    b, n, _ = coords.shape
    sums = torch.cat([coords.sum(dim=1), coords.new_full((b, 1), n)], 1)
    sums = reduce_no_grad(sums, axis)
    return (sums[:, :3] / sums[:, 3:])[:, None, :]


def normalize_coords(coords: torch.Tensor, resolution: int,
                     normalize: bool = True, eps: float = 0.0, axis=None):
    """(B, N, 3) xyz -> (norm_coords fp32 in [0, R-1], vox_coords int32).
    ``axis``: the points axis of the process grid the cloud is cut over
    (None: the points are the whole cloud)."""
    coords = coords.detach().to(torch.float32)
    r = float(resolution)
    centered = coords - _cloud_mean(coords, axis)
    if normalize:
        norm = torch.linalg.vector_norm(centered, dim=-1, keepdim=True)
        top = reduce_no_grad(norm.amax(dim=1, keepdim=True), axis,
                             dist.ReduceOp.MAX)
        denom = top * 2.0 + eps
        norm_coords = centered / denom + 0.5
    else:
        norm_coords = (centered + 1.0) / 2.0
    norm_coords = torch.clamp(norm_coords * r, 0.0, r - 1.0)
    return norm_coords, torch.round(norm_coords).to(torch.int32)


def flatten_voxel_ids(vox_coords: torch.Tensor, resolution: int
                      ) -> torch.Tensor:
    """(B, N, 3) int voxel coords -> (B, N) flat ids x*R^2 + y*R + z."""
    r = resolution
    return (vox_coords[..., 0] * r + vox_coords[..., 1]) * r \
        + vox_coords[..., 2]


def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """Scatter-mean of (B, N, C) features into a (B, R, R, R, C) fp32 grid;
    empty voxels are 0 (reference vox.cu, with a fixed summation order)."""
    b, n, c = features.shape
    r3 = resolution ** 3
    ids = flatten_voxel_ids(vox_coords, resolution).long()
    rows = (ids + torch.arange(b, device=ids.device)[:, None] * r3)
    sums = torch.zeros((b * r3, c + 1), dtype=torch.float32,
                       device=features.device)
    fc = torch.cat([features.to(torch.float32),
                    features.new_ones((b, n, 1), dtype=torch.float32)], -1)
    sums.index_add_(0, rows.reshape(-1), fc.reshape(b * n, c + 1))
    grid = sums[:, :c] / sums[:, c:].clamp_min(1.0)
    return grid.reshape(b, resolution, resolution, resolution, c)


def corner_ids_weights(norm_coords: torch.Tensor, r: int):
    """(B, N, 3) coords in [0, R-1] -> (ids8 (B, N, 8) int32, w8 (B, N, 8)
    fp32), corners in (x, y, z) binary order, with the frac == 0 collapse."""
    coords = norm_coords.detach().to(torch.float32)
    lo_f = torch.floor(coords)
    frac = coords - lo_f
    lo = lo_f.to(torch.int32)
    hi = lo + (frac > 0).to(torch.int32)
    ids, ws = [], []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                x = hi[..., 0] if sx else lo[..., 0]
                y = hi[..., 1] if sy else lo[..., 1]
                z = hi[..., 2] if sz else lo[..., 2]
                ids.append((x * r + y) * r + z)
                wx = frac[..., 0] if sx else 1.0 - frac[..., 0]
                wy = frac[..., 1] if sy else 1.0 - frac[..., 1]
                wz = frac[..., 2] if sz else 1.0 - frac[..., 2]
                ws.append(wx * wy * wz)
    return torch.stack(ids, dim=-1), torch.stack(ws, dim=-1)


def trilinear_devoxelize(grid: torch.Tensor, norm_coords: torch.Tensor,
                         resolution: int) -> torch.Tensor:
    """Trilinear interpolation of a (B, R, R, R, C) grid at (B, N, 3) coords
    in [0, R-1] -> (B, N, C) fp32."""
    b, r, _, _, c = grid.shape
    if r != resolution:
        raise ValueError(f"grid resolution {r} != {resolution}")
    flat = grid.reshape(b, r ** 3, c).to(torch.float32)
    ids8, w8 = corner_ids_weights(norm_coords, r)
    out = torch.zeros((b, ids8.shape[1], c), dtype=torch.float32,
                      device=grid.device)
    for k in range(8):
        idx = ids8[..., k].long()[..., None].expand(-1, -1, c)
        out = out + w8[..., k, None] * torch.gather(flat, 1, idx)
    return out
