"""Ball query and grouping: port of pcfm/ops/ball_query.py (plain torch,
as the JAX package computes them with jnp; no Pallas kernel).

The reference's CUDA ball query walks the points in index order and keeps
the first <= U hits within the radius; the first hit back-fills the
remaining slots, and a center with no hit keeps index 0.  As in JAX, the
order comes from keys ``k`` (a hit) and ``N + k`` (no hit): the U least
keys are the first U hits in index order.  The keys are unique, so
``torch.topk(largest=False)`` sorts them exactly.  Squared distances are
the port's ``pairwise_sqdist`` in full fp32 (JAX's HIGHEST precision).
"""
from __future__ import annotations

import torch

from pcfm_torch.ops.chamfer import pairwise_sqdist


@torch.no_grad()
def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               num_neighbors: int) -> torch.Tensor:
    """First-U-within-radius neighbour indices: centers (B, M, 3), points
    (B, N, 3) -> (B, M, U) int32, with the reference's back-fill (a hit
    is squared distance < radius^2)."""
    n = points.shape[1]
    u = int(num_neighbors)
    hit = pairwise_sqdist(centers, points) < float(radius) ** 2  # (B, M, N)
    order = torch.arange(n, device=points.device)
    key = torch.where(hit, order, order + n)
    key_u = torch.topk(key, u, dim=-1, largest=False, sorted=True).values
    valid = key_u < n
    idx = torch.where(valid, key_u, torch.zeros_like(key_u))
    # back-fill: slots past the hit count take the first hit; no hit -> 0
    first = idx[..., :1].expand_as(idx)
    idx = torch.where(valid, idx,
                      torch.where(valid[..., :1], first,
                                  torch.zeros_like(idx)))
    return idx.to(torch.int32)


def grouping(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Neighbour features: features (B, N, C), indices (B, M, U) ->
    (B, M, U, C), the channel-last form of the reference's (B, C, M, U);
    the backward is autograd's scatter-add."""
    bsz, m, u = indices.shape
    flat = indices.reshape(bsz, m * u).long()
    out = torch.gather(features, 1,
                       flat[..., None].expand(-1, -1, features.shape[-1]))
    return out.reshape(bsz, m, u, features.shape[-1])
