"""The port's data layer: a copy of the framework-free ``pcfm.data``
(H5 shard datasets, the synthetic set, the host loader, condition encoders,
PLY IO), so the port imports nothing of the JAX package.  Exports what the
training loop uses."""
from pcfm_torch.data.h5_dataset import get_datasets
from pcfm_torch.data.loader import DataLoader, to_model_batch

__all__ = ["DataLoader", "get_datasets", "to_model_batch"]
