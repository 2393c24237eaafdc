"""Multi-process solves on torch.distributed (port of
mesh_navigation_tpu/parallel): the all_gather field solve over a
('mesh', 'batch') grid of ranks (sharded.py), the halo-ring partition
(partition.py), the banded pass kernel on row shards (sharded_banded.py),
the process set-up (distributed.py), the transport rule (comm.py) and the
multi-device dry run (dryrun.py)."""

from mesh_navigation_torch.parallel.sharded import (
    ShardedMeshWeights,
    make_device_mesh,
    shard_weights,
    sharded_field_solve,
)
from mesh_navigation_torch.parallel.partition import (
    MeshPartition,
    build_partition,
    partitioned_field_solve,
)
from mesh_navigation_torch.parallel.sharded_banded import (
    ShardedBandedPlan,
    build_sharded_banded_plan,
    sharded_banded_solve,
)
from mesh_navigation_torch.parallel import distributed

__all__ = [
    "ShardedMeshWeights",
    "make_device_mesh",
    "shard_weights",
    "sharded_field_solve",
    "MeshPartition",
    "build_partition",
    "partitioned_field_solve",
    "ShardedBandedPlan",
    "build_sharded_banded_plan",
    "sharded_banded_solve",
    "distributed",
]
