"""Differentiable collectives over one axis of the process grid.

The JAX package differentiates one program over the (data, points) mesh,
and GSPMD derives the collectives of its backward.  Here every rank runs
its own forward and backward, so each collective that a gradient crosses
is a ``torch.autograd.Function`` with its transpose written out.

The rule that makes the gradients right.  Rank r computes the loss L_r
of its own (B / dp, N / sp) block as if that block were the whole batch:
a mean over its rows and points, and over its clouds for a per-cloud
term.  A collective's output is a replica: every rank of the axis holds
the same value, and rank r's replica feeds only L_r.  So the backward of
a forward all-reduce (or all-gather) SUMS the cotangents of the replicas
over the axis: it gives each rank d(sum_r L_r) / d(its input).  The
parameter gradients are then averaged over the whole world
(``TrainState.apply_gradients``), which gives d(mean_r L_r) / d(theta).
That is the single-device loss's gradient: the world's dp * sp blocks
are equal parts of the global batch, so a per-point mean averages to the
global mean; a per-cloud term (the latent flow, a pooled code) is the
same on the sp ranks of a data shard, so it enters mean_r L_r sp times
out of dp * sp, once per data shard: the factors of sp cancel; a
cross-batch term computed on the gathered batch enters every L_r alike.
A replica whose value no collective made (a voxel grid computed on every
rank of the points axis from the all-reduced partial grid) keeps its own
cotangent: the all-reduce that made its input sums them.

Only all-reduce, all-gather and broadcast are used, which NCCL and gloo
both offer; reduced values go over the wire in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from pcfm_torch.parallel.mesh import Axis


def all_reduce_(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """All-reduce ``x`` in place over ``axis`` (in fp32 for narrower
    floats) and return it; no gradient."""
    if x.dtype in (torch.bfloat16, torch.float16):
        y = x.float()
        dist.all_reduce(y, op=op, group=axis.group)
        x.copy_(y)
    else:
        dist.all_reduce(x, op=op, group=axis.group)
    return x


def _own(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` for a collective to write into."""
    return x.detach().clone(memory_format=torch.contiguous_format)


def reduce_no_grad(x: torch.Tensor, axis: Optional[Axis],
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce of a value no gradient crosses (counts, coordinates,
    logged metrics), into a new tensor."""
    if axis is None or axis.size == 1:
        return x
    return all_reduce_(_own(x), axis, op)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(_own(x), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_own(g), ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over the ranks of ``axis``; the backward sums the cotangents."""
    if axis is None or axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        top = x.amax(dim=dim).float()
        all_reduce_(top, axis, dist.ReduceOp.MAX)
        top = top.to(x.dtype)            # the max of x's values is one
        hit = x == top.unsqueeze(dim)
        ties = hit.sum(dim=dim, dtype=torch.float32)
        all_reduce_(ties, axis)
        ctx.save_for_backward(hit, ties)
        ctx.dim, ctx.axis = dim, axis
        return top

    @staticmethod
    def backward(ctx, g):
        hit, ties = ctx.saved_tensors
        share = all_reduce_(_own(g.float()), ctx.axis) / ties
        return (hit * share.unsqueeze(ctx.dim)).to(g.dtype), None, None


def all_reduce_max(x: torch.Tensor, dim: int,
                   axis: Optional[Axis]) -> torch.Tensor:
    """The max of ``x`` over ``dim`` and over the ranks of ``axis`` (a
    max pool over points cut over ranks).  The backward sums the
    cotangents over the axis and splits each evenly over the elements,
    on every rank, that attain the max, as ``jnp.max``'s and
    ``Tensor.amax``'s gradients split over ties."""
    if axis is None or axis.size == 1:
        return x.amax(dim=dim)
    return _AllReduceMax.apply(x, dim % x.dim(), axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        ctx.dim, ctx.axis, ctx.len = dim, axis, x.shape[dim]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(_own(g), ctx.axis)
        return g.narrow(ctx.dim, ctx.axis.index * ctx.len,
                        ctx.len).contiguous(), None, None


def all_gather(x: torch.Tensor, dim: int,
               axis: Optional[Axis]) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in the axis's order
    (equal shapes on every rank).  The backward sums the cotangents over
    the axis and keeps this rank's block."""
    if axis is None or axis.size == 1:
        return x
    return _AllGather.apply(x, dim % x.dim(), axis)


def broadcast_(tensors, src: int = 0) -> None:
    """Rank ``src``'s values into ``tensors`` on every rank of the world
    (no gradient)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src)
