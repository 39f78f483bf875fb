"""Distributed resilience layer: failure is normal (counterpart of
paddle_tpu/resilience).

  * channel — RpcPolicy + ResilientChannel: deadlines, bounded retries
    with backoff+jitter, retryable-error classification (server-side
    RemoteOpError never retries), invalidate-socket-on-timeout so a late
    reply can never desync the stream, and the process-wide RetryBudget.
    serving.ServingClient and sparse.RemoteShard ride on it.
  * supervisor — ShardSupervisor: ping-based health monitoring over the
    remote sparse service, standby adoption / process respawn on shard
    death, restore from the newest committed shard checkpoint, and
    in-order replay of journaled gradient pushes — sync-mode recovery is
    bitwise-identical to an uninterrupted run.  Optional degradation
    mode serves deterministic virgin rows while a shard is down.  It
    also coordinates a live reshard.
  * chaos — ChaosProxy: deterministic TCP fault injection (stalls, drops,
    resets, blackhole, refuse, and a seeded random schedule) in front of
    any endpoint; the fleet's failure drills run through it.
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
from .supervisor import ShardDownError, ShardSupervisor

__all__ = [
    "ChaosProxy",
    "ShardSupervisor",
    "ShardDownError",
    "RpcPolicy",
    "ResilientChannel",
    "ChannelError",
    "RemoteOpError",
    "EpochMismatch",
    "RetryBudget",
    "retry_budget",
    "reset_retry_budget",
]
