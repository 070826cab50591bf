"""Gradient-reversal adversary — port of pcfm/models/adversary.py
(reference models.py:190-221).

``GradReverse`` is the identity forward whose backward scales the
cotangent by -lambda; ``CondAdversary`` predicts the joint condition from z
for GRL-based removal of joint information (wired behind ``lambda_adv``).
Parameter names follow the flax module's: ``dense_{i}``, ``out``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.functional import silu

from pcfm_torch.nn.common import dense, kaiming_normal_, linear


class GradReverse(torch.autograd.Function):
    """y = x; dL/dx = -lambd * dL/dy."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, lambd: float) -> torch.Tensor:
        ctx.lambd = lambd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.lambd * g, None


def grad_reverse(x: torch.Tensor, lambd: float) -> torch.Tensor:
    return GradReverse.apply(x, lambd)


class CondAdversary(nn.Module):
    """MLP z (B, latent) -> predicted condition (B, cond_dim) fp32:
    ``depth - 1`` Dense + SiLU of ``width``, then a Dense; Kaiming-normal
    weights, zero biases, compute in ``dtype`` (fp32, as the JAX bundle
    builds it)."""

    def __init__(self, latent_dim: int, cond_dim: int, width: int = 256,
                 depth: int = 3, dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        for i in range(depth - 1):
            self.add_module(f"dense_{i}", linear(
                latent_dim if i == 0 else width, width, kaiming_normal_,
                generator, device))
        self.out = linear(width if depth > 1 else latent_dim, cond_dim,
                          kaiming_normal_, generator, device)
        self.depth = depth

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z.to(self.dtype)
        for i in range(self.depth - 1):
            h = silu(dense(h, getattr(self, f"dense_{i}"), self.dtype))
        return dense(h, self.out, self.dtype).to(torch.float32)
