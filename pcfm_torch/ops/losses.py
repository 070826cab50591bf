"""Loss primitives: port of pcfm/ops/losses.py (the reference's
third_party/pvcnn/modules/functional/loss.py), plain torch."""
from __future__ import annotations

import torch


def kl_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """KL(softmax(x) || softmax(y)) over the class axis (the last: the
    reference's dim 1 of channel-first tensors), no gradient to ``x``,
    meaned over the rest."""
    p = torch.softmax(x.detach(), dim=-1)
    log_q = torch.log_softmax(y, dim=-1)
    return torch.mean(torch.sum(p * (torch.log(p) - log_q), dim=-1))


def huber_loss(error: torch.Tensor, delta: float) -> torch.Tensor:
    """Mean Huber loss of ``error`` with threshold ``delta``."""
    abs_error = error.abs()
    quadratic = torch.clamp(abs_error, max=delta)
    losses = 0.5 * quadratic ** 2 + delta * (abs_error - quadratic)
    return torch.mean(losses)
