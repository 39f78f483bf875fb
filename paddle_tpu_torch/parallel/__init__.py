"""Parallel runtime (counterpart of paddle_tpu/parallel): only the host's
CPU placement helpers so far (`environment`), which the serving fleet
uses to pin replica processes to disjoint cpusets.

Meshes, sharding, the ParallelExecutor, ZeRO, pipelines, ring attention
and the multi-process bootstrap are ROADMAP.md A item 7.
"""

from .environment import (
    affinity_report,
    apply_affinity,
    available_cpus,
    partition_cpus,
)

__all__ = ["affinity_report", "apply_affinity", "available_cpus",
           "partition_cpus"]
