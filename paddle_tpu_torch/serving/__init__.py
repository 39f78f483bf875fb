"""Multi-tenant serving tier: continuous batching over a paged KV pool,
its RPC front end and its overload control plane (counterpart of
paddle_tpu/serving).

    from paddle_tpu_torch import serving
    sched = serving.Scheduler(spec).start()
    req = sched.submit(feed, max_new_tokens=32)
    tokens = req.result()

or over the wire (the JAX package's protocol, byte for byte):

    srv, sched = serving.serve(spec, scope)
    cli = serving.ServingClient(srv.endpoint)
    tokens, status = cli.generate(feed, max_new_tokens=32)

`Scheduler` (and so `serve`) runs on the card unless given
`place=CPUPlace()`.  Over the device pool (`paged_kv=True`) it also
serves speculative decoding (`spec_decode=True` with a `build_draft`
spec), chunked prefill (`prefill_chunk=`) and the two-tier handoff
(`submit(prefill_only=True)` on a prefill-tier Scheduler,
`submit(kv_payload=...)` on a decode-tier one; `decode_feed` unpacks the
record's feed).  `admission=True` turns on the overload control plane
(`OverloadControl`: the admission gate and the brownout ladder; a refused
submit raises `AdmissionRejected`); `CircuitBreaker` is the per-replica
breaker a router wraps around each backend.
"""

from .overload import AdmissionRejected, CircuitBreaker, OverloadControl
from .rpc import ReplicaDraining, ServingClient, ServingServer, serve
from .scheduler import (
    Scheduler,
    SchedulerDraining,
    ServedRequest,
    decode_feed,
    encode_feed,
    prompt_key,
)

__all__ = [
    "AdmissionRejected",
    "CircuitBreaker",
    "OverloadControl",
    "ReplicaDraining",
    "Scheduler",
    "SchedulerDraining",
    "ServedRequest",
    "ServingClient",
    "ServingServer",
    "decode_feed",
    "encode_feed",
    "prompt_key",
    "serve",
]
