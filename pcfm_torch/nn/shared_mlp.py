"""SharedMLP — port of pcfm/nn/shared_mlp.py (reference pvcnn
modules/shared_mlp.py): a 1x1 convolution over points, then BatchNorm
(eps 1e-5) and ReLU, on channel-last (B, ..., C) tensors.

Parameter names are the reference's: ``layers.0`` is the Conv1d (weight
(out, in, 1), bias; a Conv2d's (out, in, 1, 1) at ``dim=2``, as the
reference's PointNet++ set abstraction has it), ``layers.1`` the
BatchNorm, ``layers.2`` the ReLU, and for a list of out channels the next
layer at ``layers.3`` to ``layers.5``, and so on.  The
JAX package's Dense has no bias (it is dead through the BatchNorm) and folds
a reference checkpoint's conv bias into the running mean; the port keeps
the bias parameter, initialised to 0, so that reference checkpoints load,
and folds it the same way (``BatchNorm(shift=bias)``).  In training mode
the BatchNorm normalises the bias-free product with its batch statistics.
"""
from __future__ import annotations

import torch
from torch import nn

from pcfm_torch.nn.common import BatchNorm, lecun_normal_tensor_


class Conv1x1(nn.Module):
    """A reference Conv1d(kernel 1): ``weight`` (out, in, 1), ``bias`` 0
    (``dim=2``: a Conv2d's (out, in, 1, 1)).  ``init(weight, fan_in,
    generator)`` draws the weight; None: zeros."""

    def __init__(self, in_channels: int, out_channels: int, init, *,
                 generator: torch.Generator, device=None, dim: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels, *(1,) * dim))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if init is not None:
            init(self.weight, in_channels, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                bias: bool = True) -> torch.Tensor:
        """flax Dense(dtype=dtype) over the channel axis: input and weight
        (and the bias, when ``bias``) cast to ``dtype``."""
        w = self.weight.flatten(1).to(dtype)
        return nn.functional.linear(x.to(dtype), w,
                                    self.bias.to(dtype) if bias else None)


class SharedMLP(nn.Module):
    """Conv1x1 (in ``dtype``, lecun-normal, bias folded) -> BatchNorm
    (fp32 arithmetic and output) -> ReLU, once for each of
    ``out_channels`` (an int or a list)."""

    def __init__(self, in_channels: int, out_channels,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, device=None, dim: int = 1):
        super().__init__()
        self.dtype = dtype
        layers = []
        for oc in ([out_channels] if isinstance(out_channels, int)
                   else out_channels):
            layers += [Conv1x1(in_channels, oc, lecun_normal_tensor_,
                               generator=generator, device=device, dim=dim),
                       BatchNorm(oc, eps=1e-5, device=device), nn.ReLU()]
            in_channels = oc
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(0, len(self.layers), 3):
            conv, bn = self.layers[i], self.layers[i + 1]
            x = torch.relu(bn(conv(x, self.dtype, bias=False),
                              shift=conv.bias))
        return x
