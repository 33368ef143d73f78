"""Device-mesh parallelism for EC math (port of seaweedfs_tpu/parallel/).

`mesh` builds the meshes both planes share; `distributed` runs the
bulk plane's encode, rebuild and degraded read over a (shard, batch)
mesh: every lane runs K1 on its own block, and the packed partials fold
by XOR, within a process or across a torch.distributed group.
"""
from .distributed import (
    distributed_apply_matrix,
    distributed_degraded_read,
    distributed_encode_blockdiag,
    make_mesh,
    shard_parallel_apply,
    staged_apply_matrix,
)

__all__ = [
    "make_mesh",
    "distributed_apply_matrix",
    "distributed_encode_blockdiag",
    "distributed_degraded_read",
    "staged_apply_matrix",
    "shard_parallel_apply",
]
