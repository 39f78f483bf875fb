"""Distributed resilience layer: failure is normal (counterpart of
paddle_tpu/resilience).

  * channel — RpcPolicy + ResilientChannel: deadlines, bounded retries
    with backoff+jitter, retryable-error classification (server-side
    RemoteOpError never retries), invalidate-socket-on-timeout so a late
    reply can never desync the stream, and the process-wide RetryBudget.
    serving.ServingClient rides on it.

The JAX package's `ShardSupervisor` (supervisor.py) and `ChaosProxy`
(chaos.py) are not ported yet (ROADMAP.md A8).
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

__all__ = [
    "RpcPolicy",
    "ResilientChannel",
    "ChannelError",
    "RemoteOpError",
    "EpochMismatch",
    "RetryBudget",
    "retry_budget",
    "reset_retry_budget",
]
