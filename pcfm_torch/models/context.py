"""ContextNet — multi-scale PVConv pyramid producing per-point context.
Port of pcfm/models/context.py (reference models.py:349-543: _PVBlock,
_PVStage, ContextNet):

  * entry sort: points ordered by their stage-0 voxel id, unsorted at exit
    (every op inside is permutation-equivariant); the gathers then read
    neighbouring grid rows for neighbouring points
  * stem = [emb(t, cond) broadcast || xyz (|| rgb)]
  * stages of SharedMLP channel lift + k x (PVConv -> SharedMLP -> FiLM1d
    residual) at decreasing voxel resolutions; one stage cache per
    resolution (``build_stage_cache``), shared by its PVConvs
  * optional global max-pool branch
  * multi-scale concat -> ``head_pre`` -> norm -> silu -> zero-init
    ``head_out``
  * t-gate: alpha = sigmoid(k (t - tau)) blends the PV context with an
    emb-only global context (models.py:534-539)

Training mode differentiates as the JAX package's ``jax.grad`` does: the
BatchNorms normalise with batch statistics, the voxel ops and the entry
sort's permutations run through their autograd Functions
(pcfm_torch/ops/voxel_sorted.py), and the global branch's ``amax`` splits
its gradient evenly over ties, as ``jnp.max``'s does.

Precision island (``island_dtype``, Config ``ctx_dtype``): the Dense / conv
layers of the pyramid compute in it; coordinates, norm statistics, the
embedding, the global branch and the head stay fp32, as in the JAX package.

Parameter names are the reference's (``t_proj``, ``c_proj``,
``stages.{s}.proj``, ``stages.{s}.blocks.{b}.{pvconv,post,film}``,
``global_mlp.{0,2}``, ``head_pre``, ``head_norm``, ``head_out``,
``ctx_from_emb.0``), so reference checkpoints load directly.

Under point-axis parallelism (``sp_context.sp_axis()``; the JAX package's
``sp_mesh`` branches, pcfm/models/context.py:151-162,213-216,279-281)
each rank holds N / sp points of every cloud: the entry sort is this
rank's, of voxel ids from coordinates normalised over the whole cloud,
and its inverse restores this rank's order at exit; the stage caches
hold the whole cloud's voxel counts; the global branch's max pool is over
every rank's points (pcfm_torch/parallel/sp_ops.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn.functional import linear as flinear
from torch.nn.functional import silu

from pcfm_torch.models.embeddings import timestep_embedding
from pcfm_torch.nn.common import (kaiming_normal_, kaiming_normal_tensor_,
                                  linear, make_norm, normal02_)
from pcfm_torch.nn.film import FiLM1d
from pcfm_torch.nn.pvconv import PVConv
from pcfm_torch.nn.shared_mlp import Conv1x1, SharedMLP
from pcfm_torch.ops.voxel_sorted import (build_stage_cache, permute_points,
                                         sort_perm_by_voxel,
                                         unpermute_points)
from pcfm_torch.parallel.sp_context import sp_axis
from pcfm_torch.parallel.sp_ops import sp_global_max

# normalize_coords eps shared by the entry sort, the stage caches and every
# Voxelization — all must agree (a different denominator can move a
# knife-edge point across a voxel boundary)
VOXEL_EPS = 1e-6


class PVBlock(nn.Module):
    """PVConv -> SharedMLP -> residual FiLM1d (models.py:349-368)."""

    def __init__(self, channels: int, resolution: int, emb_dim: int,
                 with_se: bool, norm_type: str = "group", gn_groups: int = 32,
                 voxel_normalize: bool = True, eps: float = VOXEL_EPS,
                 dtype: torch.dtype = torch.float32, grid_bn: str = "auto",
                 *, generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.pvconv = PVConv(channels, channels, 3, resolution, with_se,
                             voxel_normalize, eps, dtype, grid_bn, **kw)
        self.post = SharedMLP(channels, channels, dtype, **kw)
        self.film = FiLM1d(channels, emb_dim, norm_type, gn_groups,
                           device=device)

    def forward(self, f, c, emb, cache: Optional[dict] = None):
        f, c = self.pvconv(f, c, cache)
        f = self.post(f)
        return f + self.film(f, emb), c


class PVStage(nn.Module):
    """SharedMLP channel lift -> num_blocks x PVBlock (models.py:371-389)."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int,
                 resolution: int, emb_dim: int, with_se: bool,
                 norm_type: str = "group", gn_groups: int = 32,
                 voxel_normalize: bool = True,
                 dtype: torch.dtype = torch.float32, grid_bn: str = "auto",
                 *, generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.proj = SharedMLP(in_channels, out_channels, dtype, **kw)
        self.blocks = nn.ModuleList([
            PVBlock(out_channels, resolution, emb_dim, with_se, norm_type,
                    gn_groups, voxel_normalize, VOXEL_EPS, dtype, grid_bn,
                    **kw) for _ in range(num_blocks)])

    def forward(self, f, c, emb, cache: Optional[dict] = None):
        f = self.proj(f)
        for blk in self.blocks:
            f, c = blk(f, c, emb, cache)
        return f, c


class ContextNet(nn.Module):

    def __init__(self, in_point_dim: int, cond_dim: int, emb_dim: int = 256,
                 ctx_dim: int = 64,
                 stage_channels: Sequence[int] = (128, 256, 256),
                 stage_blocks: Sequence[int] = (2, 2, 2),
                 stage_res: Sequence[int] = (32, 16, 8),
                 with_se: bool = True, norm_type: str = "group",
                 gn_groups: int = 32, with_global: bool = True,
                 voxel_normalize: bool = True, use_t_gate: bool = True,
                 t_gate_k: float = 10.0, t_gate_tau: float = 0.4,
                 island_dtype: torch.dtype = torch.float32,
                 grid_bn: str = "auto", *, generator: torch.Generator,
                 device=None):
        super().__init__()
        if not len(stage_channels) == len(stage_blocks) == len(stage_res):
            raise ValueError("stage_channels, stage_blocks and stage_res "
                             "must have one entry per stage")
        kw = dict(generator=generator, device=device)
        self.in_point_dim, self.cond_dim = in_point_dim, cond_dim
        self.emb_dim, self.stage_res = emb_dim, tuple(int(r) for r in
                                                      stage_res)
        self.voxel_normalize, self.with_global = voxel_normalize, with_global
        self.use_t_gate, self.t_gate_k, self.t_gate_tau = \
            use_t_gate, t_gate_k, t_gate_tau
        self.island_dtype = island_dtype
        self.t_proj = linear(emb_dim, emb_dim, normal02_, generator, device)
        self.c_proj = linear(max(cond_dim, 1), emb_dim, normal02_, generator,
                             device)
        stages, in_c = [], emb_dim + in_point_dim
        for sc, nb, rs in zip(stage_channels, stage_blocks, stage_res):
            stages.append(PVStage(in_c, sc, nb, int(rs), emb_dim, with_se,
                                  norm_type, gn_groups, voxel_normalize,
                                  island_dtype, grid_bn, **kw))
            in_c = sc
        self.stages = nn.ModuleList(stages)
        c_last = stage_channels[-1]
        if with_global:
            self.global_mlp = nn.ModuleList([
                linear(c_last, c_last, kaiming_normal_, generator, device),
                nn.SiLU(),
                linear(c_last, c_last, kaiming_normal_, generator, device)])
        head_in = sum(stage_channels) + (c_last if with_global else 0)
        self.head_pre = Conv1x1(head_in, c_last, kaiming_normal_tensor_,
                                **kw)
        self.head_norm = make_norm(norm_type, c_last, gn_groups,
                                   device=device)
        self.head_out = Conv1x1(c_last, ctx_dim, None, **kw)  # zero init
        if use_t_gate:
            self.ctx_from_emb = nn.ModuleList([
                linear(emb_dim, ctx_dim, kaiming_normal_, generator,
                       device)])

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, N, 3|6), t (B,), cond (B, cond_dim) or None -> ctx
        (B, N, ctx_dim) in x's dtype."""
        b, n, d = x.shape
        if d != self.in_point_dim:
            raise ValueError(f"ContextNet expected in_point_dim="
                             f"{self.in_point_dim}, got {d}")
        out_dtype = x.dtype
        x = x.to(torch.float32)
        axis = sp_axis()
        perm, inv = sort_perm_by_voxel(x[..., :3], self.stage_res[0],
                                       normalize=self.voxel_normalize,
                                       eps=VOXEL_EPS, axis=axis)
        x = permute_points(x, perm, inv)
        coords = x[..., :3]
        t = t.reshape(b).to(torch.float32)

        t_emb = silu(flinear(timestep_embedding(t, self.emb_dim),
                             self.t_proj.weight, self.t_proj.bias))
        if cond is None or cond.numel() == 0:
            # zero vector at the model's cond width
            c_in = torch.zeros((b, max(self.cond_dim, 1)),
                               dtype=torch.float32, device=x.device)
        else:
            c_in = cond.to(torch.float32)
        emb = t_emb + silu(flinear(c_in, self.c_proj.weight,
                                   self.c_proj.bias))               # (B, E)

        feats = [emb[:, None, :].expand(b, n, self.emb_dim), coords]
        if self.in_point_dim == 6:
            feats.append(x[..., 3:])
        f = torch.cat(feats, dim=-1).to(self.island_dtype)

        caches = {r: build_stage_cache(coords, r,
                                       normalize=self.voxel_normalize,
                                       eps=VOXEL_EPS, axis=axis)
                  for r in dict.fromkeys(self.stage_res)}
        ms_feats, c = [], coords
        for stage, r in zip(self.stages, self.stage_res):
            f, c = stage(f, c, emb, caches[r])
            ms_feats.append(f)
        if self.with_global:
            g0, _, g1 = self.global_mlp
            g = sp_global_max(f, axis).to(torch.float32)            # (B, C)
            g = flinear(silu(flinear(g, g0.weight, g0.bias)), g1.weight,
                        g1.bias)
            ms_feats.append(g[:, None, :].expand(b, n, g.shape[-1]))
        f_cat = torch.cat([m.to(torch.float32) for m in ms_feats], dim=-1)

        h = silu(self.head_norm(self.head_pre(f_cat, torch.float32)))
        ctx = self.head_out(h, torch.float32)                   # (B, N, ctx)
        if self.use_t_gate:
            glb = self.ctx_from_emb[0]
            ctx_glb = flinear(emb, glb.weight, glb.bias)[:, None, :]
            alpha = torch.sigmoid(
                self.t_gate_k * (t[:, None, None] - self.t_gate_tau))
            ctx = alpha * ctx + (1.0 - alpha) * ctx_glb
        return unpermute_points(ctx, perm, inv).to(out_dtype)
