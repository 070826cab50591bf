"""Model-FLOP counting for MFU — port of pcfm/utils/flops.py.

``count_matmul_flops(fn, *args, **kwargs)`` runs one call of ``fn`` and
counts the FLOPs of every matmul and convolution in it, forward and
backward: torch's ``FlopCounterMode`` over ``aten.mm``, ``addmm``,
``bmm``, ``convolution`` and ``convolution_backward`` (2·M·N·K a
product; a convolution 2 x output elements x input channels x kernel
volume), the ops the JAX counter reads as ``dot_general`` and
``conv_general_dilated``.  Unlike the JAX counter, this one executes
``fn``: the count is of the call that ran.

The hand-written kernels are C entry points called through ``ctypes``
(pcfm_torch/ops/build.py), which no dispatch mode sees: a kernel counts
0 unless its launch is wrapped in ``kernel_flops(formula)``, which, while
a count is open, runs it with the dispatch modes off and adds its
formula, the model math of the function it computes, so a count reads
the same work whether a kernel or its plain version ran.  The FiLM block
is wrapped: forward 2·B·N·C² (``silu(f) @ W``), backward 4·B·N·C²
(``dy @ W``, ``silu(f)ᵀ @ dy``).  The voxel gather and scatter and
chamfer are not, and count 0 as their plain versions do (no product):
gathers and scatters are no model math, as the JAX counter reads its
sorted voxel kernels (pcfm/utils/flops.py:11-13), and chamfer is a
metric.  The JAX counter skips every ``pallas_call``, so its count of a
``fused_trunk on`` model lacks the trunk; this one does not.

``mfu(flops, seconds)`` divides by the H100's dense bf16 tensor-core peak.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch

H100_BF16_DENSE_PEAK = 989e12      # FLOP/s, H100 SXM data sheet (dense)

# the counts in progress (nested counts each see every kernel's formula)
_ACTIVE: list = []


def _counted_ops() -> dict:
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    return {op: flop_registry[op] for op in (
        aten.mm, aten.addmm, aten.bmm, aten.convolution,
        aten.convolution_backward)}


class FlopCount:
    """A context in which every matmul and convolution (and every kernel's
    formula) is counted; ``total`` after it closes."""

    def __init__(self):
        self.kernel_flops = 0
        self._mode = None

    def __enter__(self) -> "FlopCount":
        from torch.utils.flop_counter import FlopCounterMode
        self._mode = FlopCounterMode(display=False)
        self._mode.flop_registry = _counted_ops()
        self._mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return self._mode.__exit__(*exc)

    @property
    def by_op(self) -> dict:
        """{op name: FLOPs} of the dispatched ops, plus ``kernels``."""
        ops = {str(k): v for k, v in
               self._mode.get_flop_counts().get("Global", {}).items()}
        return {**ops, "kernels": self.kernel_flops}

    @property
    def total(self) -> int:
        return int(self._mode.get_total_flops()) + int(self.kernel_flops)


def count_matmul_flops(fn: Callable, *args, **kwargs) -> int:
    """Total matmul / convolution FLOPs of one call of ``fn(*args,
    **kwargs)``, the kernels' formulas included."""
    with FlopCount() as count:
        fn(*args, **kwargs)
    return count.total


def kernel_flops(formula: Callable[..., int]) -> Callable:
    """Decorator for a kernel's launch function: outside a count it is
    the launch itself; inside one, the launch runs unseen by the dispatch
    modes and ``formula(*args, **kwargs)`` FLOPs are added to every open
    count.  The launch stays reachable as ``.launch``."""
    def wrap(launch: Callable) -> Callable:
        @functools.wraps(launch)
        def counted(*args, **kwargs):
            if not _ACTIVE:
                return counted.launch(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes
            with _disable_current_modes():
                out = counted.launch(*args, **kwargs)
            flops = int(formula(*args, **kwargs))
            for count in _ACTIVE:
                count.kernel_flops += flops
            return out
        counted.launch = launch
        return counted
    return wrap


def mfu(flops_per_step: int, step_seconds: float,
        peak: float = H100_BF16_DENSE_PEAK) -> float:
    """Model FLOP utilization in [0, 1]."""
    if step_seconds <= 0 or not math.isfinite(step_seconds):
        return float("nan")
    return flops_per_step / step_seconds / peak
