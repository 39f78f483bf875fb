"""Multi-tenant serving tier: continuous batching over a paged KV pool
(counterpart of paddle_tpu/serving).

    from paddle_tpu_torch import serving
    sched = serving.Scheduler(spec).start()
    req = sched.submit(feed, max_new_tokens=32)
    tokens = req.result()

`Scheduler` runs on the card unless given `place=CPUPlace()`.  Over the
device pool (`paged_kv=True`) it also serves speculative decoding
(`spec_decode=True` with a `build_draft` spec), chunked prefill
(`prefill_chunk=`) and the two-tier handoff (`submit(prefill_only=True)`
on a prefill-tier Scheduler, `submit(kv_payload=...)` on a decode-tier
one; `decode_feed` unpacks the record's feed).  The RPC front end
(`serve`, `ServingClient`) and the overload control plane (`admission`)
wait for a later slice (ROADMAP.md A).
"""

from .scheduler import (
    Scheduler,
    SchedulerDraining,
    ServedRequest,
    decode_feed,
    encode_feed,
    prompt_key,
)

__all__ = [
    "Scheduler",
    "SchedulerDraining",
    "ServedRequest",
    "decode_feed",
    "encode_feed",
    "prompt_key",
]
