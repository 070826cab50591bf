"""3-nearest-neighbour interpolation: port of pcfm/ops/interpolate.py
(plain torch, as the JAX package computes it with jnp; no Pallas kernel).

For each point, the 3 nearest centers (the reference's insertion scan
keeps the earlier index on ties, and so does JAX's ``lax.top_k``;
``torch.topk`` promises no order among ties, so the port takes three
first-occurrence ``argmin``s, each masking the one before, which is the
stable sort's first three) blend their features with
inverse-squared-distance weights, the distances clamped to [1e-10, 1e10]
as the reference kernel does.  Squared distances are the port's
``pairwise_sqdist`` in full fp32.
"""
from __future__ import annotations

import torch

from pcfm_torch.ops.chamfer import pairwise_sqdist


@torch.no_grad()
def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """points (B, N, 3), centers (B, M, 3) -> (dists (B, N, 3) fp32,
    indices (B, N, 3) int32): the 3 least squared distances a point,
    ascending, the earlier index first on ties."""
    d2 = pairwise_sqdist(points, centers)                       # (B, N, M)
    dists, idx = [], []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)      # first least
        dists.append(torch.gather(d2, -1, i))
        idx.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    return torch.cat(dists, -1), torch.cat(idx, -1).to(torch.int32)


def three_nn_weights(d2: torch.Tensor) -> torch.Tensor:
    """Inverse-squared-distance weights (B, N, 3) with the reference's
    clamps."""
    d = d2.to(torch.float32).clamp(1e-10, 1e10)
    d0, d1, d2_ = d[..., 0], d[..., 1], d[..., 2]
    d0d1, d0d2, d1d2 = d0 * d1, d0 * d2_, d1 * d2_
    inv = 1.0 / (d0d1 + d0d2 + d1d2)
    return torch.stack([d1d2 * inv, d0d2 * inv, d0d1 * inv], dim=-1)


def nearest_neighbor_interpolate(points: torch.Tensor, centers: torch.Tensor,
                                 centers_features: torch.Tensor
                                 ) -> torch.Tensor:
    """Center features (B, M, C) interpolated onto points (B, N, 3) ->
    (B, N, C).  The gradient flows to ``centers_features`` only (the
    reference's backward returns None for both coordinate inputs)."""
    d2, idx = three_nn(points.detach(), centers.detach())
    w = three_nn_weights(d2)                                    # (B, N, 3)
    b, n, _ = idx.shape
    c = centers_features.shape[-1]
    gathered = torch.gather(
        centers_features, 1,
        idx.reshape(b, n * 3, 1).long().expand(-1, -1, c)).reshape(b, n, 3, c)
    return (gathered * w[..., None]).sum(dim=2)
