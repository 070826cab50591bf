"""PVConv — point-voxel convolution, the block of the hybrid backbone.
Port of pcfm/nn/pvconv.py (reference pvcnn modules/pvconv.py and
modules/voxelization.py):

  voxel branch: normalise + round coords -> scatter-mean to a (B, R^3, C)
    grid -> 2 x [Conv3d 3^3 (padding 1) -> BatchNorm (eps 1e-4) ->
    LeakyReLU 0.1] -> SE3d -> trilinear gather back to the points
  point branch: SharedMLP
  output: voxel features + point features (fp32).

The scatter and the gather are the port's CUDA kernels on CUDA tensors and
their plain versions on CPU tensors (pcfm_torch/ops/voxel_sorted.py), at
every resolution: the JAX package's choice between its sorted-window
kernels, a dense one-hot matmul (R^3 <= 4096) and XLA's scatter/gather
(``voxel_backend``, ``SORTED_N_MIN``) computes one function, which the
port's kernels compute everywhere.  Conv3d is a library call (cuDNN), as
the JAX package leaves it to ``nn.Conv``; the grid stays channel-last and is
handed to cuDNN as a ``channels_last_3d`` view, so no layout copy surrounds
a convolution.

Dtypes follow the JAX package's island: the scatter's input, the convs,
the grid BatchNorm (``grid_bn`` "auto" / "flat_bf16"; fp32 for "flat" /
"flax") and SE run in ``dtype``; the grid from the scatter, the gathered
features, the SharedMLP's BatchNorm output and the block's output are fp32;
coordinates are always fp32.

In training mode the BatchNorms normalise with the batch statistics
(pcfm_torch/nn/common.py), the scatter and the gather differentiate
through each other's kernel, and the grid BatchNorm's variance is clipped
at 0 only under ``grid_bn`` "flax" (flax's BatchNorm; FlatBatchNorm does
not clip).

Under point-axis parallelism (a stage cache built with the points axis,
``cache['sp']``, or ``sp_context.sp_axis()`` when a PVConv builds its own)
each rank scatters its own points into a partial grid and the partial
grids are all-reduced (``sp_avg_voxelize``); every rank then runs the
convolutions on its replica of the grid and gathers its own points back
(pcfm_torch/parallel/sp_ops.py; pcfm/nn/pvconv.py:85-99,191-211).  The
grid BatchNorms reduce over the data axis (``over="grid"``), the
SharedMLP's over every rank.

Parameter names are the reference's: ``voxel_layers.{0,3}`` Conv3d (out,
in, 3, 3, 3) with a bias, ``voxel_layers.{1,4}`` BatchNorm,
``voxel_layers.6.fc`` SE, ``point_features.layers``.  The JAX package's
convs have no bias and fold a reference checkpoint's into the running mean;
the port keeps the bias (initialised to 0) out of the arithmetic and folds
it the same way, as its BatchNorm's ``shift`` (``dead_conv_biases``:
training leaves it out of the optimizer).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.functional import conv3d, leaky_relu

from pcfm_torch.nn.common import BatchNorm, lecun_normal_tensor_
from pcfm_torch.nn.se import SE3d
from pcfm_torch.nn.shared_mlp import SharedMLP
from pcfm_torch.ops.voxel_sorted import (build_stage_cache,
                                         trilinear_devoxelize_sorted)
from pcfm_torch.parallel.sp_context import sp_axis
from pcfm_torch.parallel.sp_ops import sp_avg_voxelize

GRID_BN = ("auto", "flax", "flat", "flat_bf16")


def grid_bn_dtype(grid_bn: str, dtype: torch.dtype) -> torch.dtype:
    """The grid BatchNorm's normalize dtype (pcfm/nn/pvconv.py:170-183):
    the island's under "auto" / "flat_bf16", fp32 under "flat" / "flax"."""
    if grid_bn not in GRID_BN:
        raise ValueError(f"grid_bn must be one of {GRID_BN}, got "
                         f"{grid_bn!r}")
    return dtype if grid_bn in ("auto", "flat_bf16") else torch.float32


class Voxelization(nn.Module):
    """Parameterless voxeliser (reference modules/voxelization.py:9-28):
    (features (B, N, C), coords (B, N, 3)) -> (grid (B, R, R, R, C) fp32,
    norm_coords (B, N, 3) fp32).  ``cache``: the stage cache
    (``build_stage_cache``) shared by the PVConvs of one resolution."""

    def __init__(self, resolution: int, normalize: bool = True,
                 eps: float = 0.0):
        super().__init__()
        self.resolution, self.normalize, self.eps = resolution, normalize, \
            eps

    def forward(self, features: torch.Tensor, coords: torch.Tensor,
                cache: dict | None = None):
        r = self.resolution
        if cache is None:
            cache = build_stage_cache(coords, r, normalize=self.normalize,
                                      eps=self.eps, axis=sp_axis())
        grid = sp_avg_voxelize(features, cache, r)
        b, _, c = grid.shape
        return grid.reshape(b, r, r, r, c), cache["norm_coords"]


class PVConv(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, resolution: int = 32,
                 with_se: bool = False, normalize: bool = True,
                 eps: float = 0.0, dtype: torch.dtype = torch.float32,
                 grid_bn: str = "auto", *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.resolution, self.kernel_size = resolution, kernel_size
        self.dtype = dtype
        self.bn_dtype = grid_bn_dtype(grid_bn, dtype)
        self.vox = Voxelization(resolution, normalize, eps)
        layers = []
        for cin in (in_channels, out_channels):
            conv = nn.Conv3d(cin, out_channels, kernel_size,
                             padding=kernel_size // 2)
            with torch.no_grad():
                lecun_normal_tensor_(conv.weight, cin * kernel_size ** 3,
                                     generator)
                conv.bias.zero_()
            layers += [conv.to(device),
                       BatchNorm(out_channels, eps=1e-4,
                                 clamp_var=grid_bn == "flax", device=device,
                                 over="grid"),
                       nn.LeakyReLU(0.1)]
        if with_se:
            layers.append(SE3d(out_channels, dtype=dtype,
                               generator=generator, device=device))
        self.voxel_layers = nn.ModuleList(layers)
        self.point_features = SharedMLP(in_channels, out_channels, dtype,
                                        generator=generator, device=device)

    def _conv_bn(self, grid: torch.Tensor, conv: nn.Conv3d,
                 bn: BatchNorm) -> torch.Tensor:
        """Conv3d (in ``dtype``, no bias) -> BatchNorm (bias folded) ->
        LeakyReLU on a channel-last (B, R, R, R, C) grid."""
        x = grid.to(self.dtype).permute(0, 4, 1, 2, 3)     # channels_last_3d
        w = conv.weight.to(self.dtype).contiguous(
            memory_format=torch.channels_last_3d)
        y = conv3d(x, w, padding=self.kernel_size // 2).permute(0, 2, 3, 4, 1)
        return leaky_relu(bn(y, shift=conv.bias, dtype=self.bn_dtype), 0.1)

    def forward(self, features: torch.Tensor, coords: torch.Tensor,
                cache: dict | None = None):
        """features (B, N, C_in), coords (B, N, 3) -> (fused (B, N, C_out)
        fp32, coords)."""
        r = self.resolution
        if cache is None:
            cache = build_stage_cache(coords, r,
                                      normalize=self.vox.normalize,
                                      eps=self.vox.eps, axis=sp_axis())
        grid, norm_coords = self.vox(features.to(self.dtype), coords, cache)
        vl = self.voxel_layers
        grid = self._conv_bn(grid, vl[0], vl[1])
        grid = self._conv_bn(grid, vl[3], vl[4])
        if len(vl) > 6:
            grid = vl[6](grid)
        b, c = grid.shape[0], grid.shape[-1]
        voxel_features = trilinear_devoxelize_sorted(
            grid.reshape(b, r ** 3, c), norm_coords, r, cache=cache)
        return voxel_features + self.point_features(features), coords


def dead_conv_biases(module: nn.Module) -> list:
    """(bias, BatchNorm) of every reference conv bias in ``module`` that
    feeds a BatchNorm: the Conv3d biases of each PVConv and the Conv1x1
    bias of each SharedMLP.  The JAX package has no such parameter (a
    BatchNorm's batch mean absorbs it), so training leaves them out of the
    optimizer, the clip and the weight decay."""
    pairs = []
    for m in module.modules():
        if isinstance(m, PVConv):
            vl = m.voxel_layers
            pairs += [(vl[0].bias, vl[1]), (vl[3].bias, vl[4])]
        elif isinstance(m, SharedMLP):
            pairs += [(m.layers[i].bias, m.layers[i + 1])
                      for i in range(0, len(m.layers), 3)]
    return pairs
