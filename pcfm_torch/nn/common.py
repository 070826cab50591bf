"""Initializers matching pcfm/nn/common.py (and flax's lecun_normal).

Every draw comes from an explicit ``torch.Generator``.  Weights are torch
``Linear`` layout (out, in), so fan_in is ``weight.shape[1]``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# flax variance_scaling(..., "truncated_normal") divides the std by the std
# of a unit normal truncated at +-2 so the result has the asked variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def kaiming_normal_(lin: nn.Linear, generator: torch.Generator) -> None:
    """Untruncated normal, std sqrt(2 / fan_in); zero bias."""
    std = math.sqrt(2.0 / lin.weight.shape[1])
    lin.weight.normal_(0.0, std, generator=generator)
    lin.bias.zero_()


@torch.no_grad()
def normal02_(lin: nn.Linear, generator: torch.Generator) -> None:
    """N(0, 0.02) weight (t_proj / c_proj); zero bias."""
    lin.weight.normal_(0.0, 0.02, generator=generator)
    lin.bias.zero_()


@torch.no_grad()
def lecun_normal_(lin: nn.Linear, generator: torch.Generator) -> None:
    """flax lecun_normal: normal truncated at +-2 sigma with
    sigma = sqrt(1 / fan_in) / 0.8796; zero bias (FiLM affine)."""
    std = math.sqrt(1.0 / lin.weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    lin.bias.zero_()


def linear(in_features: int, out_features: int, init, generator,
           device=None) -> nn.Linear:
    """An fp32 ``nn.Linear`` initialised on the CPU from ``generator`` and
    moved to ``device`` (so one CPU generator seeds any device alike)."""
    lin = nn.Linear(in_features, out_features)
    init(lin, generator)
    return lin.to(device)


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``Dense(dtype=...)`` with fp32 params: input, weight and bias
    are cast to the compute dtype and the result stays in it."""
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype),
                                lin.bias.to(dtype))
