"""Furthest point sampling + gather — port of pcfm/ops/sampling.py (plain
torch, as the JAX package has no Pallas kernel for it).

Iterative FPS with the first index fixed to 0 (the reference kernel
sampling.cu:86-167): each round keeps every point's least squared distance
to the chosen set and takes the first point of greatest distance
(``argmax`` picks the first maximum, as the CUDA tree reduction prefers the
lowest index).  The rounds are sequential, one (B, N) pass each.
``logits_mask`` is not ported yet.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def furthest_point_sample_indices(coords: torch.Tensor,
                                  num_samples: int) -> torch.Tensor:
    """(B, N, 3) float -> (B, M) int32 sampled indices (the first is 0)."""
    coords = coords.detach().to(torch.float32)
    b, n, _ = coords.shape
    m = int(num_samples)
    dists = torch.full((b, n), float("inf"), device=coords.device)
    idxs = torch.zeros((b, m), dtype=torch.int32, device=coords.device)
    last = torch.zeros((b,), dtype=torch.int64, device=coords.device)
    for j in range(1, m):
        p = torch.gather(coords, 1, last[:, None, None].expand(-1, 1, 3))
        dists = torch.minimum(dists, ((coords - p) ** 2).sum(dim=-1))
        last = dists.argmax(dim=1)
        idxs[:, j] = last.to(torch.int32)
    return idxs


def gather(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features at (B, M) indices -> (B, M, C)
    (take_along_axis; its backward is autograd's scatter-add)."""
    idx = indices.long()[..., None].expand(-1, -1, features.shape[-1])
    return torch.gather(features, 1, idx)


def furthest_point_sample(coords: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """(B, N, 3) -> (B, M, 3) sampled coordinates (reference
    ``furthest_point_sample``, functional/sampling.py:37-49)."""
    return gather(coords, furthest_point_sample_indices(coords, num_samples))
