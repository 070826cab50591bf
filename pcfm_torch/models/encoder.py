"""ShapeEncoder — port of pcfm/models/encoder.py (reference
models.py:156-187): 3 shared Linear+SiLU layers -> max-pool over points ->
head -> latent z.  Parameter names: ``mlp.{0,2,4}``, ``head.{2j}``.  With
the points cut over the points axis (``sp_context.sp_axis()``) the pool is
over every rank's points."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.functional import silu

from pcfm_torch.nn.common import dense, kaiming_normal_, linear
from pcfm_torch.parallel.sp_context import sp_axis
from pcfm_torch.parallel.sp_ops import sp_global_max


class ShapeEncoder(nn.Module):

    def __init__(self, latent_dim: int = 256, width: int = 128,
                 depth: int = 4, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        mlp = []
        for i in range(3):
            mlp += [linear(in_channels if i == 0 else width, width,
                           kaiming_normal_, generator, device), nn.SiLU()]
        self.mlp = nn.Sequential(*mlp)
        head = []
        for _ in range(max(1, depth - 3)):
            head += [linear(width, width, kaiming_normal_, generator,
                            device), nn.SiLU()]
        head.append(linear(width, latent_dim, kaiming_normal_, generator,
                           device))
        self.head = nn.Sequential(*head)

    def forward(self, pts: torch.Tensor):
        """pts (B, N, in_channels) -> (z (B, latent) fp32, h (B, N, width))."""
        h = pts
        for lin in self.mlp[0::2]:
            h = silu(dense(h, lin, self.dtype))
        d = sp_global_max(h, sp_axis())                            # (B, C)
        for lin in self.head[0:-1:2]:
            d = silu(dense(d, lin, self.dtype))
        z = dense(d, self.head[-1], self.dtype)
        return z.to(torch.float32), h
