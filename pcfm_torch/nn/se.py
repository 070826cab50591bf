"""SE3d — port of pcfm/nn/se.py (reference pvcnn modules/se.py):
squeeze-and-excitation over a channel-last (B, R, R, R, C) voxel grid.
Mean over the grid, then fc1 -> ReLU -> fc2 -> sigmoid, no biases, in the
module's dtype; the grid is scaled per channel.  Parameter names are the
reference's: ``fc.0`` and ``fc.2`` (torch Linear, out x in)."""
from __future__ import annotations

import torch
from torch import nn

from pcfm_torch.nn.common import lecun_normal_tensor_


class SE3d(nn.Module):

    def __init__(self, channel: int, reduction: int = 8,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        hidden = channel // reduction
        fc1 = nn.Linear(channel, hidden, bias=False)
        fc2 = nn.Linear(hidden, channel, bias=False)
        lecun_normal_tensor_(fc1.weight, channel, generator)
        lecun_normal_tensor_(fc2.weight, hidden, generator)
        self.fc = nn.ModuleList([fc1, nn.ReLU(), fc2, nn.Sigmoid()]).to(
            device)

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        # the mean accumulates in fp32 (jnp.mean upcasts) in the grid dtype
        g = grid.to(torch.float32).mean(dim=(1, 2, 3)).to(grid.dtype)
        g = nn.functional.linear(g.to(self.dtype),
                                 self.fc[0].weight.to(self.dtype))
        g = nn.functional.linear(torch.relu(g),
                                 self.fc[2].weight.to(self.dtype))
        return grid * torch.sigmoid(g)[:, None, None, None, :]
