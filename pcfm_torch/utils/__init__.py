"""Runtime helpers of the port: copies of ``pcfm.utils.misc`` and
``pcfm.utils.tb``.  Exports what the training loop uses."""
from pcfm_torch.utils.misc import MetricEMA, seed_all

__all__ = ["MetricEMA", "seed_all"]
