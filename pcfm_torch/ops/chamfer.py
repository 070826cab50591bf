"""Chamfer distance (any point dimension) — port of pcfm/ops/chamfer.py.

Plain torch, as the JAX package computes it outside any Pallas kernel: the
squared distances of a chunk of the first cloud to all of the second come
from the dot trick ``|a|^2 + |b|^2 - 2 a.b`` (a batched matmul, TF32 off),
which picks the nearest neighbour; its distance is then recomputed exactly
in difference form in fp32.  Chunking along N keeps the (chunk, M) tile
small at 20k x 20k.  The chamfer kernel of pcfm/ops/pallas/chamfer_v3.py is
still to port.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_fp32_matmul():
    """fp32 matmuls in full precision (TF32 off) for the block, as the JAX
    version's HIGHEST precision."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _direction(x: torch.Tensor, y: torch.Tensor, chunk: int):
    """For every point of x, its nearest point of y: (min squared distance
    (B, N) fp32, argmin (B, N) int32)."""
    y2 = (y * y).sum(dim=-1)                                       # (B, M)
    d_all, i_all = [], []
    for s in range(0, x.shape[1], chunk):
        xc = x[:, s:s + chunk]
        d2 = ((xc * xc).sum(dim=-1)[:, :, None] + y2[:, None, :]
              - 2.0 * torch.bmm(xc, y.transpose(1, 2)))
        imin = d2.argmin(dim=-1)
        ynn = torch.gather(y, 1, imin[..., None].expand(-1, -1, y.shape[-1]))
        d_all.append(((xc - ynn) ** 2).sum(dim=-1))
        i_all.append(imin.to(torch.int32))
    return torch.cat(d_all, dim=1), torch.cat(i_all, dim=1)


@torch.no_grad()
def chamfer_distance(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096):
    """Bidirectional nearest-neighbour squared-L2 Chamfer distance of a
    (B, N, D) and b (B, M, D): (dist1 (B, N), dist2 (B, M), idx1, idx2),
    the interface of the reference's ``chamfer_3DDist``."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    with _full_fp32_matmul():
        dist1, idx1 = _direction(a, b, chunk)
        dist2, idx2 = _direction(b, a, chunk)
    return dist1, dist2, idx1, idx2


def chamfer_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Train-time CD of the reference (train.py:80-84): per cloud, the sum
    of the two direction means of the min squared distance.  (B,)."""
    dist1, dist2, _, _ = chamfer_distance(pred, target)
    return dist1.mean(dim=1) + dist2.mean(dim=1)


def fscore(dist1: torch.Tensor, dist2: torch.Tensor,
           threshold: float = 0.001):
    """F-score at a squared-distance threshold from Chamfer outputs:
    (fscore, precision1, precision2), each (B,)."""
    precision_1 = (dist1 < threshold).to(torch.float32).mean(dim=1)
    precision_2 = (dist2 < threshold).to(torch.float32).mean(dim=1)
    denom = precision_1 + precision_2
    f = torch.where(denom > 0, 2 * precision_1 * precision_2
                    / denom.clamp_min(1e-30), torch.zeros_like(denom))
    return f, precision_1, precision_2
