"""Per-point velocity networks — port of pcfm/models/velocity.py.

``VelocityNet`` is the ``mlp`` point-flow backbone (reference
models.py:82-153): a per-point residual MLP on [x || emb(t, cond)] with
FiLM between blocks.  ``VelocityNetWithContext`` is the hybrid's head
(models.py:546-601): the same trunk on [x || ctx || emb(t, cond)], so the
fused FiLM-block kernel serves it too.  Parameter names follow the
reference state_dict
(``t_proj``, ``c_proj``, ``input``, ``blocks.{i}.1``, ``films.{i}.norm``,
``films.{i}.affine``, ``out.1``), so reference checkpoints and
pcfm/interop/torch_ckpt.py read it directly.

Dtype policy as in the flax modules: parameters are fp32; every Linear
casts its input and weights to the compute dtype; LayerNorm statistics are
fp32; the velocity is returned in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.functional import silu

from pcfm_torch.models.embeddings import timestep_embedding
from pcfm_torch.nn.common import dense, kaiming_normal_, linear, normal02_
from pcfm_torch.nn.film import FiLMBlock
from pcfm_torch.ops.film_block import film_block


def use_fused_trunk(flag: str, width: int) -> bool:
    """The JAX rule (pcfm/models/velocity.py:_use_fused_trunk): the fused
    kernel runs only for ``"on"`` and a width that is a multiple of 128;
    ``"auto"`` resolves to off."""
    return flag == "on" and width % 128 == 0


def t_c_embed(mdl: nn.Module, t, cond, cond_drop_mask, batch: int
              ) -> torch.Tensor:
    """Shared [t_emb + c_emb] computation of the velocity nets
    (pcfm/models/velocity.py:_t_c_embed, reference models.py:124-134),
    from ``mdl``'s ``t_proj`` / ``c_proj`` in ``mdl.dtype``."""
    dtype = mdl.dtype
    t_emb = timestep_embedding(t.reshape(batch), mdl.emb_dim).to(dtype)
    t_emb = silu(dense(t_emb, mdl.t_proj, dtype))
    if mdl.cond_dim > 0 and cond is not None:
        if cond_drop_mask is not None:
            cond = cond * (1.0 - cond_drop_mask)                  # 1 -> drop
        c_in = cond.to(dtype)
    else:
        c_in = torch.zeros((batch, max(mdl.cond_dim, 1)), dtype=dtype,
                           device=t.device)
    c_emb = silu(dense(c_in, mdl.c_proj, dtype))
    return t_emb + c_emb


class VelocityNet(nn.Module):
    """Per-point MLP velocity field v(x, t, cond) (pf_backbone=mlp).

    ``fused_trunk="on"`` runs each FiLM block of the trunk through the
    fused kernel (pcfm_torch/ops/film_block.py) with the same parameters;
    ``film_every=k`` applies FiLM only on every k-th block (the films of
    the other blocks do not exist)."""

    def __init__(self, cond_dim: int, width: int = 512, depth: int = 6,
                 emb_dim: int = 256, point_dim: int = 3,
                 dtype: torch.dtype = torch.float32,
                 fused_trunk: str = "auto", film_every: int = 1, *,
                 generator: torch.Generator, device=None, ctx_dim: int = 0):
        super().__init__()
        self.cond_dim, self.emb_dim = cond_dim, emb_dim
        self.t_proj = linear(emb_dim, emb_dim, normal02_, generator, device)
        self.c_proj = linear(max(cond_dim, 1), emb_dim, normal02_,
                             generator, device)
        self.width, self.point_dim = width, point_dim
        self.dtype, self.fused_trunk = dtype, fused_trunk
        self.film_every, self.ctx_dim = film_every, ctx_dim
        self.input = linear(point_dim + ctx_dim + emb_dim, width,
                            kaiming_normal_, generator, device)
        blocks, films = [], {}
        for i in range(depth - 1):
            if i % film_every == 0:
                films[str(i)] = FiLMBlock(width, emb_dim,
                                          generator=generator, device=device)
            blocks.append(nn.Sequential(
                nn.SiLU(), linear(width, width, kaiming_normal_, generator,
                                  device)))
        self.blocks = nn.ModuleList(blocks)
        self.films = nn.ModuleDict(films)
        self.out = nn.Sequential(
            nn.SiLU(), linear(width, point_dim, kaiming_normal_, generator,
                              device))

    def _trunk(self, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """depth-1 x [FiLM -> h + Linear(silu(h))]."""
        fused = use_fused_trunk(self.fused_trunk, self.width)
        for i, blk in enumerate(self.blocks):
            lin = blk[1]
            film = self.films[str(i)] if i % self.film_every == 0 else None
            if fused and film is not None:
                gamma, beta = film.modulation(emb, self.dtype)
                h = film_block(h, film.norm.weight, film.norm.bias,
                               gamma.contiguous(), beta.contiguous(),
                               lin.weight, lin.bias)
                continue
            if film is not None:
                h = film(h, emb, self.dtype)
            h = h + dense(silu(h), lin, self.dtype)
        return h

    def _head(self, x: torch.Tensor, t: torch.Tensor, cond, cond_drop_mask,
              ctx: Optional[torch.Tensor]) -> torch.Tensor:
        """input Linear on [x || ctx || emb] -> trunk -> output Linear."""
        b, n, d = x.shape
        if d != self.point_dim:
            raise ValueError(f"{type(self).__name__} expected point_dim="
                             f"{self.point_dim}, got {d}")
        x = x.to(self.dtype)
        emb = t_c_embed(self, t, cond, cond_drop_mask, b)          # (B, E)
        parts = [x] if ctx is None else [x, ctx.to(self.dtype)]
        h = torch.cat(parts + [emb[:, None, :].expand(b, n, self.emb_dim)],
                      dim=-1)
        h = dense(h, self.input, self.dtype)
        h = self._trunk(h, emb)
        return dense(silu(h), self.out[1], self.dtype).to(torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor],
                cond_drop_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (B, N, point_dim), t (B,), cond (B, cond_dim) or None,
        cond_drop_mask (B, 1) with 1 = dropped -> v (B, N, point_dim) fp32."""
        return self._head(x, t, cond, cond_drop_mask, None)


class VelocityNetWithContext(VelocityNet):
    """The hybrid head (pcfm/models/velocity.py:205): VelocityNet's trunk on
    [x || ctx || emb]; ``ctx`` (B, N, ctx_dim) comes from ContextNet."""

    def __init__(self, cond_dim: int, point_dim: int = 3, ctx_dim: int = 64,
                 width: int = 512, depth: int = 6, emb_dim: int = 256,
                 dtype: torch.dtype = torch.float32,
                 fused_trunk: str = "auto", film_every: int = 1, *,
                 generator: torch.Generator, device=None):
        super().__init__(cond_dim, width=width, depth=depth, emb_dim=emb_dim,
                         point_dim=point_dim, dtype=dtype,
                         fused_trunk=fused_trunk, film_every=film_every,
                         generator=generator, device=device, ctx_dim=ctx_dim)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor], ctx: torch.Tensor,
                cond_drop_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if tuple(ctx.shape[:2]) != tuple(x.shape[:2]):
            raise ValueError(f"ctx shape {tuple(ctx.shape)} does not fit x "
                             f"{tuple(x.shape)}")
        return self._head(x, t, cond, cond_drop_mask, ctx)
