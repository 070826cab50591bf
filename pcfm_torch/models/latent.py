"""ConditionalLatentVelocityNet — port of pcfm/models/latent.py
(reference models.py:224-290): residual SiLU MLP on [y || emb(t, cond)].
Parameter names: ``t_proj``, ``c_proj``, ``input``, ``blocks.{i}.1``,
``out.1``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.functional import silu

from pcfm_torch.models.velocity import t_c_embed
from pcfm_torch.nn.common import dense, kaiming_normal_, linear, normal02_


class ConditionalLatentVelocityNet(nn.Module):

    def __init__(self, latent_dim: int, cond_dim: int = 0, width: int = 512,
                 depth: int = 6, emb_dim: int = 256,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.cond_dim, self.emb_dim = cond_dim, emb_dim
        self.t_proj = linear(emb_dim, emb_dim, normal02_, generator, device)
        self.c_proj = linear(max(cond_dim, 1), emb_dim, normal02_,
                             generator, device)
        self.latent_dim, self.dtype = latent_dim, dtype
        self.input = linear(latent_dim + emb_dim, width, kaiming_normal_,
                            generator, device)
        self.blocks = nn.ModuleList(
            nn.Sequential(nn.SiLU(), linear(width, width, kaiming_normal_,
                                            generator, device))
            for _ in range(depth - 1))
        self.out = nn.Sequential(
            nn.SiLU(), linear(width, latent_dim, kaiming_normal_, generator,
                              device))

    def forward(self, y: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                cond_drop_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """y (B, Dz), t (B,), cond (B, C) or None -> v (B, Dz) fp32."""
        b = y.shape[0]
        emb = t_c_embed(self, t, cond, cond_drop_mask, b)
        h = dense(torch.cat([y.to(self.dtype), emb], dim=-1), self.input,
                  self.dtype)
        for blk in self.blocks:
            h = h + dense(silu(h), blk[1], self.dtype)
        return dense(silu(h), self.out[1], self.dtype).to(torch.float32)
