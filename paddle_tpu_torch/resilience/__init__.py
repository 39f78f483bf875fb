"""Distributed resilience layer: failure is normal (counterpart of
paddle_tpu/resilience).

  * channel — RpcPolicy + ResilientChannel: deadlines, bounded retries
    with backoff+jitter, retryable-error classification (server-side
    RemoteOpError never retries), invalidate-socket-on-timeout so a late
    reply can never desync the stream, and the process-wide RetryBudget.
    serving.ServingClient rides on it.
  * chaos — ChaosProxy: deterministic TCP fault injection (stalls, drops,
    resets, blackhole, refuse, and a seeded random schedule) in front of
    any endpoint; the fleet's failure drills run through it.

The JAX package's `ShardSupervisor` (supervisor.py), which watches the
sparse shard servers, is not ported yet (ROADMAP.md A item 8).
"""

from .channel import (
    ChannelError,
    EpochMismatch,
    RemoteOpError,
    ResilientChannel,
    RetryBudget,
    RpcPolicy,
    reset_retry_budget,
    retry_budget,
)
from .chaos import ChaosProxy

__all__ = [
    "ChaosProxy",
    "RpcPolicy",
    "ResilientChannel",
    "ChannelError",
    "RemoteOpError",
    "EpochMismatch",
    "RetryBudget",
    "retry_budget",
    "reset_retry_budget",
]
