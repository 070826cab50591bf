"""HybridMLP — ContextNet + per-point velocity head; port of
pcfm/models/hybrid.py (reference models.py:604-694).

Forward: ``cond_eff = cond * (1 - mask)`` feeds ContextNet; the head gets
``cond`` and the mask separately.  The classifier-free-guidance
unconditional branch of the reference is a zeroed condition for the hybrid
(models.py:691-694), which is what ``make_guided``'s batched two-branch
call gives.  Parameter names: ``ctx_net.*`` and ``head.*``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pcfm_torch.models.context import ContextNet
from pcfm_torch.models.velocity import VelocityNetWithContext


class HybridMLP(nn.Module):

    def __init__(self, cond_dim: int, point_dim: int = 3, ctx_dim: int = 64,
                 ctx_emb_dim: int = 256,
                 stage_channels: Sequence[int] = (128, 256, 256),
                 stage_blocks: Sequence[int] = (2, 2, 2),
                 stage_res: Sequence[int] = (32, 16, 8),
                 with_se: bool = True, norm_type: str = "group",
                 gn_groups: int = 32, with_global: bool = True,
                 voxel_normalize: bool = True, use_t_gate: bool = True,
                 t_gate_k: float = 10.0, t_gate_tau: float = 0.8,
                 pf_width: int = 512, pf_depth: int = 6,
                 pf_emb_dim: int = 256, dtype: torch.dtype = torch.float32,
                 fused_trunk: str = "auto", film_every: int = 1,
                 ctx_island_dtype: torch.dtype = torch.float32,
                 grid_bn: str = "auto", *, generator: torch.Generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cond_dim, self.point_dim = cond_dim, point_dim
        self.dtype = dtype
        self.ctx_net = ContextNet(
            in_point_dim=point_dim, cond_dim=cond_dim, emb_dim=ctx_emb_dim,
            ctx_dim=ctx_dim, stage_channels=tuple(stage_channels),
            stage_blocks=tuple(stage_blocks), stage_res=tuple(stage_res),
            with_se=with_se, norm_type=norm_type, gn_groups=gn_groups,
            with_global=with_global, voxel_normalize=voxel_normalize,
            use_t_gate=use_t_gate, t_gate_k=t_gate_k, t_gate_tau=t_gate_tau,
            island_dtype=ctx_island_dtype, grid_bn=grid_bn, **kw)
        self.head = VelocityNetWithContext(
            cond_dim=cond_dim, point_dim=point_dim, ctx_dim=ctx_dim,
            width=pf_width, depth=pf_depth, emb_dim=pf_emb_dim, dtype=dtype,
            fused_trunk=fused_trunk, film_every=film_every, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor],
                cond_drop_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (B, N, 3|6), t (B,), cond (B, C) or None, cond_drop_mask
        (B, 1) with 1 = dropped -> v (B, N, 3|6) fp32."""
        cond_eff = cond
        if cond is not None and cond_drop_mask is not None:
            cond_eff = cond * (1.0 - cond_drop_mask.to(cond.dtype))
        ctx = self.ctx_net(x, t, cond_eff if self.cond_dim > 0 else None)
        return self.head(x, t, cond, ctx, cond_drop_mask=cond_drop_mask)
