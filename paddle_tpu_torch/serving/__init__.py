"""Multi-tenant serving tier: continuous batching over a paged KV pool
(counterpart of paddle_tpu/serving).

    from paddle_tpu_torch import serving
    sched = serving.Scheduler(spec).start()
    req = sched.submit(feed, max_new_tokens=32)
    tokens = req.result()

`Scheduler` runs on the card unless given `place=CPUPlace()`.  The RPC
front end (`serve`, `ServingClient`) and the overload control plane wait
for a later slice (ROADMAP.md A).
"""

from .scheduler import (
    Scheduler,
    SchedulerDraining,
    ServedRequest,
    prompt_key,
)

__all__ = [
    "Scheduler",
    "SchedulerDraining",
    "ServedRequest",
    "prompt_key",
]
