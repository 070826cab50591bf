"""FiLM conditioning blocks — port of pcfm/nn/film.py ``FiLMBlock`` and
``FiLM1d``.

Channel-last: h is (B, N, C) or (B, C), emb is (B, E).  Parameter names
follow the reference state_dict: ``norm.{weight,bias}``,
``affine.{weight,bias}``.
"""
from __future__ import annotations

import torch
from torch import nn

from pcfm_torch.nn.common import dense, lecun_normal_, linear, make_norm

LN_EPS = 1e-5


def layer_norm(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=dtype)``: fp32 statistics
    with flax's fast variance (E[x^2] - E[x]^2, clipped at 0),
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32, then cast
    to ``dtype``."""
    x = h.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var.clamp_min(0.0) + LN_EPS) * weight
    return ((x - mean) * mul + bias).to(dtype)


class FiLMBlock(nn.Module):
    """LayerNorm + FiLM from a per-cloud embedding:
    ``LN(h) * (1 + gamma) + beta`` with (gamma, beta) = affine(emb)."""

    def __init__(self, width: int, emb_dim: int, *, generator,
                 device=None):
        super().__init__()
        self.norm = nn.LayerNorm(width, eps=LN_EPS, device=device)
        self.affine = linear(emb_dim, 2 * width, lecun_normal_, generator,
                             device)

    def modulation(self, emb: torch.Tensor, dtype: torch.dtype):
        """(gamma, beta), each (B, C) in ``dtype``."""
        return dense(emb, self.affine, dtype).chunk(2, dim=-1)

    def forward(self, h: torch.Tensor, emb: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        h = layer_norm(h, self.norm.weight, self.norm.bias, dtype)
        gamma, beta = self.modulation(emb, dtype)
        if h.dim() == 3:
            gamma, beta = gamma[:, None, :], beta[:, None, :]
        return h * (1.0 + gamma) + beta


class FiLM1d(nn.Module):
    """Norm + zero-init FiLM on (B, N, C) point features — port of
    pcfm/nn/film.py ``FiLM1d`` (reference _FiLM1d, models.py:322-346):
    ``norm(x) * (1 + gamma) + beta`` with (gamma, beta) = affine(emb), the
    affine fully zero-initialised (identity start).  The norm is
    ``make_norm(norm_type)`` (GroupNorm by default, fp32 statistics and
    output); the affine runs in fp32.  Names: ``norm.*``, ``affine``."""

    def __init__(self, channels: int, emb_dim: int,
                 norm_type: str = "group", gn_groups: int = 32, *,
                 device=None):
        super().__init__()
        self.norm = make_norm(norm_type, channels, gn_groups, device=device)
        self.affine = nn.Linear(emb_dim, 2 * channels, device=device)
        with torch.no_grad():
            self.affine.weight.zero_()
            self.affine.bias.zero_()

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        y = self.norm(x)
        gamma, beta = nn.functional.linear(
            emb.to(torch.float32), self.affine.weight,
            self.affine.bias).chunk(2, dim=-1)
        return y * (1.0 + gamma[:, None, :]) + beta[:, None, :]
