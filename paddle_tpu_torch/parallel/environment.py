"""Multi-process runtime initialization and host CPU placement
(counterpart of paddle_tpu/parallel/environment.py).

The port runs one process per rank.  `init_distributed` brings up the
torch.distributed process group from the JAX package's env protocol
(PADDLE_TPU_COORD, PADDLE_TPU_NUM_PROCS, PADDLE_TPU_PROC_ID) or its
arguments, with the backend `comm.backend_for` picks (NCCL when every
rank has a card of its own, gloo otherwise); the four counts read the
process group.  Nothing on a machine tells a program of a cluster: the
coordinator address, the world size and the rank are given.

The CPU half (`available_cpus`, `partition_cpus`, `apply_affinity`,
`affinity_report`) pins worker processes to disjoint cpusets: a serving
fleet on one host, where replicas that share every core measure
contention, not scaling.
"""

from __future__ import annotations

import os

__all__ = ["init_distributed", "available_cpus", "partition_cpus",
           "apply_affinity", "affinity_report", "global_device_count",
           "local_device_count", "process_count", "process_index"]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device_type: str | None = None,
    timeout=None,
):
    """Initialize the multi-process runtime.  No-op on single-process, and
    when the process group is already up.

    `coordinator_address` is an init method torch.distributed takes
    ("tcp://host:port" or "file:///path"; a bare "host:port" means tcp).
    `device_type` ("cuda" or "cpu", default: "cuda" when this process
    sees a card) and the world size pick the backend
    (`comm.backend_for`); `timeout` (a datetime.timedelta) bounds each
    collective."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "PADDLE_TPU_COORD")
    if num_processes is None and "PADDLE_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["PADDLE_TPU_NUM_PROCS"])
    if process_id is None and "PADDLE_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["PADDLE_TPU_PROC_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process: nothing to do
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's id (arguments or PADDLE_TPU_COORD, "
            "PADDLE_TPU_NUM_PROCS, PADDLE_TPU_PROC_ID)")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    from .comm import backend_for

    backend = backend_for(num_processes, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)


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


def _initialized():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def global_device_count():
    """Devices over all processes: one a rank."""
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def local_device_count():
    """Devices this process drives: one (the port runs a process a rank)."""
    return 1


def process_count():
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def process_index():
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0
