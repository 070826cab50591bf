"""Data and point-axis parallel training — the port of pcfm/parallel.

One process per rank (torchrun's environment), a (data, points) process
grid (``mesh``), differentiable collectives (``collectives``), the voxel
ops and the max pool over clouds cut along the points (``sp_ops``), and
the process-level grid the modules consult (``sp_context``)."""
from pcfm_torch.parallel.distributed import (cleanup_distributed,
                                             init_distributed)
from pcfm_torch.parallel.mesh import (ProcessGrid, auto_mesh_sizes,
                                      data_axis_shard, make_grid,
                                      shard_batch)

__all__ = ["ProcessGrid", "auto_mesh_sizes", "cleanup_distributed",
           "data_axis_shard", "init_distributed", "make_grid", "shard_batch"]
