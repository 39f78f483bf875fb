"""Host CPU placement for worker processes (counterpart of the CPU half of
paddle_tpu/parallel/environment.py: `available_cpus`, `partition_cpus`,
`apply_affinity` and `affinity_report`, as the JAX file has them).

A serving fleet on one host pins each replica process to a disjoint
cpuset, because replicas that share every core measure contention, not
scaling.  The module's multi-process bootstrap (`init_distributed`) and
the device counts belong to the multi-device slice (ROADMAP.md A item 7).
"""

from __future__ import annotations

import os

__all__ = ["available_cpus", "partition_cpus", "apply_affinity",
           "affinity_report"]


def available_cpus(pid=0):
    """CPU ids the given process may run on (its current affinity mask),
    or range(os.cpu_count()) where affinity is unsupported (macOS)."""
    getter = getattr(os, "sched_getaffinity", None)
    if getter is not None:
        try:
            return sorted(getter(pid))
        except OSError:
            pass
    return list(range(os.cpu_count() or 1))


def partition_cpus(num_workers, cpus=None):
    """Split `cpus` (default: this process's affinity set) into
    `num_workers` DISJOINT contiguous cpusets, one per worker —
    the decontamination step for single-host scale-out measurements
    (replicas sharing every core measure contention, not the design).
    With fewer CPUs than workers, workers
    share round-robin (never an empty set).  Returns a list of sorted
    cpu-id lists."""
    cpus = list(cpus) if cpus is not None else available_cpus()
    num_workers = max(1, int(num_workers))
    if len(cpus) < num_workers:
        return [[cpus[w % len(cpus)]] for w in range(num_workers)]
    base, rem = divmod(len(cpus), num_workers)
    sets, at = [], 0
    for w in range(num_workers):
        n = base + (1 if w < rem else 0)
        sets.append(sorted(cpus[at:at + n]))
        at += n
    return sets


def apply_affinity(pid, cpus):
    """Pin `pid` to `cpus` (os.sched_setaffinity).  Returns True when the
    pin took, False where unsupported (macOS) or the pid is gone — the
    caller's worker keeps running unpinned either way."""
    setter = getattr(os, "sched_setaffinity", None)
    if setter is None or not cpus:
        return False
    try:
        setter(pid, set(int(c) for c in cpus))
        return True
    except (OSError, ValueError):
        return False


def affinity_report(pid=0):
    """{"cpus": [...], "loadavg": [1m, 5m, 15m]} for bench/soak detail —
    records WHAT the measurement ran on next to WHAT it measured."""
    try:
        load = list(os.getloadavg())
    except (OSError, AttributeError):
        load = None
    return {"cpus": available_cpus(pid), "loadavg": load}
