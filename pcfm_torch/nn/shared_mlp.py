"""SharedMLP — port of pcfm/nn/shared_mlp.py (reference pvcnn
modules/shared_mlp.py): a 1x1 convolution over points, then BatchNorm
(eps 1e-5) and ReLU, on channel-last (B, ..., C) tensors.

Parameter names are the reference's: ``layers.0`` is the Conv1d (weight
(out, in, 1), bias), ``layers.1`` the BatchNorm, ``layers.2`` the ReLU.  The
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
    """A reference Conv1d(kernel 1): ``weight`` (out, in, 1), ``bias`` 0.
    ``init(weight, fan_in, generator)`` draws the weight; None: zeros."""

    def __init__(self, in_channels: int, out_channels: int, init, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if init is not None:
            init(self.weight, in_channels, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                bias: bool = True) -> torch.Tensor:
        """flax Dense(dtype=dtype) over the channel axis: input and weight
        (and the bias, when ``bias``) cast to ``dtype``."""
        w = self.weight[:, :, 0].to(dtype)
        return nn.functional.linear(x.to(dtype), w,
                                    self.bias.to(dtype) if bias else None)


class SharedMLP(nn.Module):
    """Conv1x1 (in ``dtype``, lecun-normal, bias folded) -> BatchNorm
    (fp32 arithmetic and output) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList([
            Conv1x1(in_channels, out_channels, lecun_normal_tensor_,
                    generator=generator, device=device),
            BatchNorm(out_channels, eps=1e-5, device=device),
            nn.ReLU()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn, _ = self.layers
        h = conv(x, self.dtype, bias=False)
        return torch.relu(bn(h, shift=conv.bias))
