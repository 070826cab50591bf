"""Flow-matching priors — port of pcfm/sample/priors.py (reference
train.py:266-279).  Every draw comes from the given ``torch.Generator`` and
lands on its device."""
from __future__ import annotations

import torch


def make_pf_prior(generator: torch.Generator, shape: tuple,
                  point_prior_std: float = 1.0, color_prior: str = "gauss",
                  color_prior_std: float = 1.0) -> torch.Tensor:
    """Point-flow prior x0 of ``shape`` (B, N, 3) or (B, N, 6); the RGB
    dims follow ``color_prior``: 'gauss' | 'uniform' (U[0,1]) | 'zeros'."""
    b, n, d = shape
    kw = dict(generator=generator, dtype=torch.float32,
              device=generator.device)
    xyz = torch.randn((b, n, 3), **kw) * point_prior_std
    if d == 3:
        return xyz
    if d != 6:
        raise ValueError(f"point prior needs 3 or 6 dims, got {d}")
    if color_prior == "gauss":
        rgb = torch.randn((b, n, 3), **kw) * color_prior_std
    elif color_prior == "uniform":
        rgb = torch.rand((b, n, 3), **kw)
    elif color_prior == "zeros":
        rgb = torch.zeros((b, n, 3), dtype=torch.float32,
                          device=generator.device)
    else:
        raise ValueError(f"unknown color_prior '{color_prior}'")
    return torch.cat([xyz, rgb], dim=-1)


def make_latent_prior(generator: torch.Generator, batch: int,
                      latent_dim: int, latent_prior_std: float = 1.0
                      ) -> torch.Tensor:
    return torch.randn((batch, latent_dim), generator=generator,
                       dtype=torch.float32,
                       device=generator.device) * latent_prior_std
