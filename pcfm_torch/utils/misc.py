"""Misc runtime helpers — a copy of pcfm/utils/misc.py (reference
util.py:27-120 equivalents)."""
from __future__ import annotations

import random
import time

import numpy as np


def seed_all(seed: int):
    """Seed python + numpy (util.py:27-32).  The port's torch draws come
    from explicit ``torch.Generator``s seeded from the Config."""
    random.seed(seed)
    np.random.seed(seed % (2**32))


class MetricEMA:
    """Exponential moving average of a scalar metric (util.py:93-105)."""

    def __init__(self, alpha: float = 0.98):
        self.a = float(alpha)
        self.value = None

    def update(self, x: float):
        self.value = x if self.value is None \
            else self.a * self.value + (1 - self.a) * x

    def get(self) -> float:
        return float(self.value if self.value is not None else 0.0)


class Timer:
    """Simple step timer with EMA smoothing for points/sec reporting."""

    def __init__(self, alpha: float = 0.9):
        self.ema = None
        self.alpha = alpha
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t
        self.ema = dt if self.ema is None \
            else self.alpha * self.ema + (1 - self.alpha) * dt
        return dt
