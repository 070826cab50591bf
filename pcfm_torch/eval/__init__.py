"""Evaluation of the port: CD / EMD / F-score over datasets, the MMD / COV
/ 1-NNA suite, and the evaluation CLI."""
from pcfm_torch.eval.metrics import aggregate, cloud_metrics

__all__ = ["aggregate", "cloud_metrics"]
