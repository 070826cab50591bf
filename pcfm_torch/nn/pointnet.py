"""PointNet++ set abstraction and feature propagation: port of
pcfm/nn/pointnet.py (the reference's third_party/pvcnn/modules/
ball_query.py and pointnet.py), channel-last, plain torch.

State_dict names are the reference's: ``mlps.{i}`` (``PointNetAModule``,
Conv1d SharedMLPs; ``PointNetSAModule``, Conv2d SharedMLPs, one a radius)
and ``mlp`` (``PointNetFPModule``).  Training or eval mode is the module's
(``train()`` / ``eval()``), where the JAX modules take ``train``.  No model
path of either package calls these.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from pcfm_torch.nn.shared_mlp import SharedMLP
from pcfm_torch.ops.ball_query import ball_query, grouping
from pcfm_torch.ops.interpolate import nearest_neighbor_interpolate
from pcfm_torch.ops.sampling import furthest_point_sample


class BallQuery(nn.Module):
    """Grouper: the neighbours within ``radius`` of each center, their
    coordinates centered (and their features): (B, M, U, 3 (+ C))."""

    def __init__(self, radius: float, num_neighbors: int,
                 include_coordinates: bool = True):
        super().__init__()
        self.radius, self.num_neighbors = radius, num_neighbors
        self.include_coordinates = include_coordinates

    def forward(self, points_coords: torch.Tensor,
                centers_coords: torch.Tensor,
                points_features: torch.Tensor | None = None) -> torch.Tensor:
        idx = ball_query(centers_coords, points_coords, self.radius,
                         self.num_neighbors)                     # (B, M, U)
        neighbor_coords = grouping(points_coords, idx) \
            - centers_coords[:, :, None, :]
        if points_features is None:
            if not self.include_coordinates:
                raise ValueError("BallQuery: no features for grouping")
            return neighbor_coords
        feats = grouping(points_features, idx)
        if self.include_coordinates:
            feats = torch.cat([neighbor_coords, feats], dim=-1)
        return feats


def _nested(out_channels) -> list:
    if not isinstance(out_channels, (list, tuple)):
        return [[out_channels]]
    if not isinstance(out_channels[0], (list, tuple)):
        return [list(out_channels)]
    return [list(oc) for oc in out_channels]


class PointNetAModule(nn.Module):
    """Global aggregation (pointnet.py:11-46): each SharedMLP over the
    points, max over them -> ((B, 1, sum of last widths), zero coords)."""

    def __init__(self, in_channels: int, out_channels: Union[int, Sequence],
                 include_coordinates: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.include_coordinates = include_coordinates
        c_in = in_channels + (3 if include_coordinates else 0)
        self.mlps = nn.ModuleList(
            SharedMLP(c_in, oc, generator=generator, device=device)
            for oc in _nested(out_channels))

    def forward(self, features: torch.Tensor, coords: torch.Tensor):
        if self.include_coordinates:
            features = torch.cat([features, coords], dim=-1)
        out = torch.cat([mlp(features).amax(dim=1, keepdim=True)
                         for mlp in self.mlps], dim=-1)
        return out, coords.new_zeros(coords.shape[0], 1, 3)


class PointNetSAModule(nn.Module):
    """Set abstraction (pointnet.py:49-95): furthest-point-sampled
    centers, one ball-query grouper and Conv2d SharedMLP a radius, max over
    the neighbours -> ((B, M, sum of last widths), centers (B, M, 3))."""

    def __init__(self, num_centers: int,
                 radius: Union[float, Sequence[float]],
                 num_neighbors: Union[int, Sequence[int]], in_channels: int,
                 out_channels: Union[int, Sequence],
                 include_coordinates: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        radii = list(radius) if isinstance(radius, (list, tuple)) \
            else [radius]
        nns = list(num_neighbors) if isinstance(num_neighbors,
                                                (list, tuple)) \
            else [num_neighbors] * len(radii)
        ocs = _nested(out_channels)
        if len(ocs) == 1 and len(radii) > 1:
            ocs = ocs * len(radii)
        self.num_centers = num_centers
        c_in = in_channels + (3 if include_coordinates else 0)
        self.groupers = nn.ModuleList(
            BallQuery(r, u, include_coordinates) for r, u in zip(radii, nns))
        self.mlps = nn.ModuleList(
            SharedMLP(c_in, oc, generator=generator, device=device, dim=2)
            for oc in ocs[:len(radii)])

    def forward(self, features: torch.Tensor, coords: torch.Tensor):
        centers = furthest_point_sample(coords, self.num_centers)
        out = torch.cat([mlp(grouper(coords, centers, features)).amax(dim=2)
                         for grouper, mlp in zip(self.groupers, self.mlps)],
                        dim=-1)
        return out, centers


class PointNetFPModule(nn.Module):
    """Feature propagation (pointnet.py:98-111): the centers' features
    interpolated onto the points (3 nearest, inverse squared distance),
    joined with the points' own, through a SharedMLP -> (features,
    points_coords)."""

    def __init__(self, in_channels: int, out_channels: Union[int, Sequence],
                 *, generator: torch.Generator, device=None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, out_channels, generator=generator,
                             device=device)

    def forward(self, points_coords: torch.Tensor,
                centers_coords: torch.Tensor,
                centers_features: torch.Tensor,
                points_features: torch.Tensor | None = None):
        interp = nearest_neighbor_interpolate(points_coords, centers_coords,
                                              centers_features)
        if points_features is not None:
            interp = torch.cat([interp, points_features], dim=-1)
        return self.mlp(interp), points_coords
