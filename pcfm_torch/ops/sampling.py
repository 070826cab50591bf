"""Furthest point sampling + gather — port of pcfm/ops/sampling.py (plain
torch, as the JAX package has no Pallas kernel for it).

Iterative FPS with the first index fixed to 0 (the reference kernel
sampling.cu:86-167): each round keeps every point's least squared distance
to the chosen set and takes the first point of greatest distance
(``argmax`` picks the first maximum, as the CUDA tree reduction prefers the
lowest index).  The rounds are sequential, one (B, N) pass each.
``logits_mask`` draws its selection from an explicit ``torch.Generator``
(JAX: a PRNG key), so it matches the JAX package in distribution, not in
values.
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


def logits_mask(coords: torch.Tensor, logits: torch.Tensor,
                num_points_per_object: int, generator: torch.Generator):
    """Sample points predicted positive by binary logits (reference
    ``logits_mask``, functional/sampling.py:52-85, the frustum pipeline's).

    coords (B, N, 3), logits (B, N, 2), M = ``num_points_per_object`` ->
    (selected (B, M, 3): mean-centered positive coords, mean (B, 3) of the
    positives, mask (B, N) bool).  Each cloud takes its positives in a
    random order drawn from ``generator``, repeated (tiled) when there are
    fewer than M (the reference's draw without replacement and its
    floor / remainder repetition), then shuffled; a cloud with no positive
    selects index 0 of its zeroed coords."""
    b = coords.shape[0]
    m = int(num_points_per_object)
    mask = logits[..., 0] < logits[..., 1]                      # (B, N)
    num_candidates = mask.sum(dim=-1, keepdim=True)             # (B, 1)
    masked_coords = coords * mask[..., None]
    mean = masked_coords.sum(dim=1) / num_candidates.clamp_min(1).to(
        coords.dtype)                                           # (B, 3)
    dev = generator.device
    sel = torch.zeros((b, m), dtype=torch.long, device=coords.device)
    for i in range(b):
        cand = torch.nonzero(mask[i]).flatten()   # the positives, in order
        cnt = cand.numel()
        if cnt == 0:
            continue
        perm = torch.randperm(cnt, generator=generator, device=dev)
        take = perm[torch.arange(m, device=dev) % cnt]
        take = take[torch.randperm(m, generator=generator, device=dev)]
        sel[i] = cand[take.to(cand.device)]
    selected = gather(masked_coords - mean[:, None, :], sel)
    return selected, mean, mask
