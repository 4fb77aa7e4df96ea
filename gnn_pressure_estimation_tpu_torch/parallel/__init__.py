"""Data × graph parallelism over ``torch.distributed``: the counterpart of
``gnn_pressure_estimation_tpu/parallel``, exporting what it exports (and
the ``Mesh`` a rank holds). ``parallel.launch`` starts the ranks on one
host."""

from gnn_pressure_estimation_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from gnn_pressure_estimation_tpu_torch.parallel.edgepart import partition_graph
from gnn_pressure_estimation_tpu_torch.parallel.distributed import (
    DistributedTrainer,
    make_distributed_train_step,
)
from gnn_pressure_estimation_tpu_torch.parallel.halo import build_halo_partition, halo_exchange
from gnn_pressure_estimation_tpu_torch.parallel.trainer import MeshTrainer

__all__ = [
    "make_mesh",
    "partition_graph",
    "DistributedTrainer",
    "make_distributed_train_step",
    "MeshTrainer",
    "init_distributed",
    "build_halo_partition",
    "halo_exchange",
    "Mesh",
]
