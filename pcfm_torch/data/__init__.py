"""The port's data layer: a copy of the framework-free ``pcfm.data``
(H5 shard datasets, the synthetic set, the host loader, condition encoders,
PLY IO, the PLY -> H5 packer), so the port imports nothing of the JAX
package.  Exports what the training loop uses, and the packer."""
from pcfm_torch.data.h5_dataset import get_datasets
from pcfm_torch.data.loader import DataLoader, to_model_batch

__all__ = ["DataLoader", "get_datasets", "pack_ply_to_h5", "to_model_batch"]


def __getattr__(name):
    # imported at first use, so that ``python -m pcfm_torch.data.pack_h5``
    # does not find its module imported already by this package
    if name == "pack_ply_to_h5":
        from pcfm_torch.data.pack_h5 import pack_ply_to_h5
        return pack_ply_to_h5
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
