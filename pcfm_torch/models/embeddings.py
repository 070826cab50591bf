"""Timestep embedding — port of pcfm/models/embeddings.py."""
from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of continuous t in [0, 1]: (...,) -> (..., dim)
    in fp32, cos || sin halves (reference order)."""
    if dim % 2:
        raise ValueError(f"timestep_embedding dim must be even, got {dim}")
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[..., None].to(torch.float32) * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
