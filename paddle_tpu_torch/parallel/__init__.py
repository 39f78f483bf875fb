"""Parallelism: device meshes, sharding annotation, multi-device execution
(counterpart of paddle_tpu/parallel).

Where the reference builds an SSA graph with explicit AllReduce/Broadcast/
Reduce op handles over NCCL (paddle/fluid/framework/details/
multi_devices_graph_pass.cc) and the JAX package lets GSPMD derive the
collectives from `dist_attr` annotations, the port keeps the JAX
package's annotations bit for bit and realises them with DTensor, one
process per rank over torch.distributed (NCCL when every rank has a card
of its own, gloo otherwise): `spmd.py` is the Executor's mesh mode,
`comm.py` the backend rule and the ring's exchange, `ring_attention.py`
the sequence-parallel attention.

Not ported yet (ROADMAP.md A item 7): `pipeline.py`/`scan_pipeline.py`,
`apply_expert_parallel`, `discovery.py` and `elastic.py`.
"""

from .mesh import DeviceMesh, make_mesh, get_current_mesh, mesh_guard
from .sharding import (
    REPLICATED,
    shard,
    sharding_for_var,
    resolve_mesh_axis,
    apply_data_parallel,
    apply_zero_sharding,
    apply_tensor_parallel,
    apply_embedding_parallel,
)
from .zero import apply_zero, zero_topology
from . import memory
from .parallel_executor import (
    BuildStrategy,
    ExecutionStrategy,
    ParallelExecutor,
)
from .environment import (
    init_distributed,
    available_cpus,
    partition_cpus,
    apply_affinity,
    affinity_report,
    global_device_count,
    local_device_count,
    process_count,
    process_index,
)

__all__ = [
    "DeviceMesh",
    "make_mesh",
    "get_current_mesh",
    "mesh_guard",
    "REPLICATED",
    "shard",
    "sharding_for_var",
    "resolve_mesh_axis",
    "apply_data_parallel",
    "apply_zero",
    "zero_topology",
    "memory",
    "apply_zero_sharding",
    "apply_tensor_parallel",
    "apply_embedding_parallel",
    "BuildStrategy",
    "ExecutionStrategy",
    "ParallelExecutor",
    "init_distributed",
    "available_cpus",
    "partition_cpus",
    "apply_affinity",
    "affinity_report",
    "global_device_count",
    "local_device_count",
    "process_count",
    "process_index",
]
