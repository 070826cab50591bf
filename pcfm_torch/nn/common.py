"""Initializers and norm layers matching pcfm/nn/common.py (and flax's
lecun_normal, GroupNorm and BatchNorm).

Every draw comes from an explicit ``torch.Generator``.  Weights are torch
``Linear`` layout (out, in), so fan_in is ``weight.shape[1]``.  Norm layers
are channel-last, with fp32 statistics, and carry torch's parameter names.

Under data or point-axis parallelism (pcfm_torch/parallel) the statistics
are the global batch's, as GSPMD computes them for the JAX package
(PARITY.md deviation 2): the sums and sums of squares are all-reduced over
the axis the rows are cut over (``sp_context.stats_axis``, ``sp_axis``),
and their gradients summed back (``all_reduce_sum``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from pcfm_torch.parallel import sp_context
from pcfm_torch.parallel.collectives import all_reduce_sum

# flax variance_scaling(..., "truncated_normal") divides the std by the std
# of a unit normal truncated at +-2 so the result has the asked variance
_TRUNC_STD = 0.87962566103423978
# flax BatchNorm's momentum (pcfm/nn/pvconv.py:176,181, shared_mlp.py:39):
# ra <- BN_MOMENTUM * ra + (1 - BN_MOMENTUM) * batch
BN_MOMENTUM = 0.9


@torch.no_grad()
def kaiming_normal_tensor_(w: torch.Tensor, fan_in: int,
                           generator: torch.Generator) -> None:
    """Untruncated normal, std sqrt(2 / fan_in), on any weight."""
    w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


@torch.no_grad()
def trunc_normal_tensor_(w: torch.Tensor, std: float,
                         generator: torch.Generator) -> None:
    """Normal(0, std) truncated at +-2 std, by the inverse CDF: one
    uniform draw an element, mapped through erfinv (as
    ``jax.random.truncated_normal`` draws).  Not ``nn.init.trunc_normal_``,
    whose method, and so whose values from one generator, changes with
    the installed torch (the inverse CDF in 2.11, rejection sampling in
    2.13): the same seed must give the same weights on every host."""
    cdf = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0
    w.uniform_(2.0 * cdf - 1.0, 1.0 - 2.0 * cdf, generator=generator)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def lecun_normal_tensor_(w: torch.Tensor, fan_in: int,
                         generator: torch.Generator) -> None:
    """flax lecun_normal on any weight: normal truncated at +-2 sigma with
    sigma = sqrt(1 / fan_in) / 0.8796 (fan_in = in x receptive field)."""
    trunc_normal_tensor_(w, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


@torch.no_grad()
def kaiming_normal_(lin: nn.Linear, generator: torch.Generator) -> None:
    """Untruncated normal, std sqrt(2 / fan_in); zero bias."""
    kaiming_normal_tensor_(lin.weight, lin.weight.shape[1], generator)
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
    lecun_normal_tensor_(lin.weight, lin.weight.shape[1], generator)
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


# ------------------------------------------------------------ norms

def moments(x: torch.Tensor, dims, axis) -> tuple:
    """fp32 (E[x], E[x^2]) over ``dims`` (kept), and over the ranks of
    ``axis`` when the rows are cut over them (equal parts on every rank:
    one all-reduce of the sums)."""
    x = x.to(torch.float32)
    if axis is None:
        return x.mean(dim=dims, keepdim=True), \
            (x * x).mean(dim=dims, keepdim=True)
    rows = math.prod(x.shape[d] for d in dims) * axis.size
    sums = all_reduce_sum(torch.stack([x.sum(dim=dims, keepdim=True),
                                       (x * x).sum(dim=dims, keepdim=True)]),
                          axis) / rows
    return sums[0], sums[1]


def choose_gn_groups(channels: int, prefer: int = 32) -> int:
    """GroupNorm group count (pcfm/nn/common.py:29, reference
    models.py:303-310): gcd(channels, prefer), or the largest of 32..2
    that divides ``channels`` when the gcd is 1."""
    prefer = min(prefer, channels)
    g = max(math.gcd(channels, prefer), 1)
    if g == 1 and channels >= 16:
        for cand in (32, 16, 8, 4, 2):
            if channels % cand == 0 and cand <= channels:
                return cand
    return g


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` on channel-last (B, N, C)
    point features: per (cloud, group) statistics over every point and the
    group's C / G channels, in fp32 with flax's fast variance (E[x^2] -
    E[x]^2, clipped at 0); ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``; fp32 out.  With the points cut over the points axis, over
    every rank's points.  Parameters ``weight`` / ``bias`` as torch's
    GroupNorm."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5,
                 device=None):
        super().__init__()
        if channels % groups:
            raise ValueError(f"GroupNorm: {groups} groups do not divide "
                             f"{channels} channels")
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.groups
        xg = x.to(torch.float32).reshape(b, -1, g, c // g)
        mean, ex2 = moments(xg, (1, 3), sp_context.sp_axis())
        var = (ex2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
        y = (xg - mean) * mul + self.bias.reshape(g, c // g)
        return y.reshape(x.shape)


class BatchNorm(nn.Module):
    """BatchNorm over the channel-last axis with torch's state_dict names
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), so reference checkpoints load as they are.

    The arithmetic of flax BatchNorm / pcfm's FlatBatchNorm
    (pcfm/nn/common.py:78-119): ``(x - mean) * (scale * rsqrt(var + eps))
    + bias``, the multiplier computed in fp32 and everything cast to
    ``dtype`` (the normalize dtype; fp32 unless the caller asks for the
    island's bf16).  In eval mode (mean, var) are the running statistics.
    In training mode they are the batch's, over every non-channel row in
    fp32 with the fast biased variance ``mean(x^2) - mean^2`` (clipped at
    0 as flax's BatchNorm does when ``clamp_var``; FlatBatchNorm does not
    clip), and gradients flow through both; the running statistics then
    move by flax's momentum, ``ra <- 0.9 ra + 0.1 batch``, with the biased
    variance (not torch's 0.1 and unbiased variance: PARITY.md deviation
    2), and ``num_batches_tracked`` counts the update.  ``shift`` is the
    bias of the layer before it (a reference Conv1d / Conv3d bias), kept
    out of the arithmetic: the JAX package has no such bias and folds a
    reference checkpoint's into the running mean, so eval subtracts it
    (``running_mean - shift``), and training normalises the bias-free
    product and adds ``shift`` to the batch mean of the running update.

    ``over``: what the rows are.  "points": point features, cut over the
    batch and the points, so the training statistics reduce over every
    rank of the process grid; "grid": a voxel grid, cut over the batch and
    replicated over the points axis, so they reduce over the data axis."""

    def __init__(self, channels: int, eps: float, clamp_var: bool = True,
                 device=None, over: str = "points"):
        super().__init__()
        if over not in ("points", "grid"):
            raise ValueError(f"BatchNorm over must be 'points' or 'grid', "
                             f"got {over!r}")
        self.eps, self.clamp_var, self.over = eps, clamp_var, over
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long,
                                          device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # reference EMA shadows keep only float entries: no counter
        state_dict.setdefault(prefix + "num_batches_tracked",
                              self.num_batches_tracked)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, shift: torch.Tensor | None = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean if shift is None else mean + shift,
                    alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1.0 - BN_MOMENTUM)
                self.num_batches_tracked.add_(1)
        else:
            # the folded bias is a statistic, as in the JAX package: no
            # gradient reaches it (frozen-statistics training, distillation)
            mean = self.running_mean if shift is None \
                else self.running_mean - shift.detach()
            var = self.running_var
        mul = (self.weight * torch.rsqrt(var + self.eps)).to(dtype)
        return (x.to(dtype) - mean.to(dtype)) * mul + self.bias.to(dtype)

    def _batch_stats(self, x: torch.Tensor) -> tuple:
        """fp32 (mean, biased fast variance) over every non-channel row
        (of every rank's rows, ``sp_context.stats_axis``)."""
        mean, ex2 = moments(x.reshape(-1, x.shape[-1]), (0,),
                            sp_context.stats_axis(self.over))
        mean, var = mean[0], ex2[0] - mean[0] * mean[0]
        return mean, (var.clamp_min(0.0) if self.clamp_var else var)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def make_norm(norm_type: str, channels: int, gn_groups: int = 32,
              device=None) -> nn.Module:
    """pcfm/nn/common.py:make_norm for (B, N, C): GroupNorm (eps 1e-5),
    BatchNorm1d semantics (flax BatchNorm, eps 1e-5, momentum 0.9) for
    "batch" / "syncbn", else identity."""
    if norm_type == "group":
        return GroupNorm(choose_gn_groups(channels, gn_groups), channels,
                         device=device)
    if norm_type in ("batch", "syncbn"):
        return BatchNorm(channels, eps=1e-5, device=device)
    return Identity()
