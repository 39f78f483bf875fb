"""Retrying, reconnecting RPC channel — the resilience core a host-side
client rides (counterpart of paddle_tpu/resilience/channel.py; the port's
serving.ServingClient is its user).

reference: the Go pserver client retried RPCs and re-resolved endpoints
on every failure (go/pserver/client/client.go: selector + connError
retry loop against etcd-registered pservers) and the gRPC client carried
per-op deadlines (grpc_client.h).  This module gives every client one
shared policy:

  * per-op deadlines (connect_timeout / call_timeout),
  * bounded retries with exponential backoff + deterministic jitter,
  * retryable-error classification: connection refused/reset/closed and
    timeouts retry; a server-side failure delivered as a well-formed
    reply (`RemoteOpError` — the OP_ERROR traceback frame, or a JSON
    {"ok": false} line) NEVER retries — re-running a handler that ran
    and failed cannot succeed, and the traceback must reach the caller,
  * invalidate-socket-on-error: any exception of unknown wire state
    (timeout mid-reply, reset mid-frame) closes the socket, so a LATE
    reply can never sit in the buffer and desync the frame stream —
    the next call starts on a fresh connection.

Endpoints may be a callable resolver, re-evaluated on every (re)connect:
the etcd re-resolution idiom, and how a supervisor re-points a client at
a respawned or standby server.
"""

from __future__ import annotations

import random
import socket
import threading
import time

from ..telemetry import registry as _telem
from ..telemetry import tracing as _tracing

__all__ = ["RpcPolicy", "ResilientChannel", "ChannelError", "RemoteOpError",
           "EpochMismatch", "RetryBudget", "retry_budget",
           "reset_retry_budget"]

_C_ATTEMPTS = _telem.counter("rpc.attempts")
_C_RETRIES = _telem.counter("rpc.retries")
_C_RECONNECTS = _telem.counter("rpc.reconnects")
_C_GAVE_UP = _telem.counter("rpc.gave_up")
_H_BACKOFF = _telem.histogram("rpc.backoff_ms")
_C_BUDGET_EXHAUSTED = _telem.counter("channel.retry_budget_exhausted")


class RemoteOpError(RuntimeError):
    """A server-side failure delivered as a complete, well-formed reply
    (transport OP_ERROR frame / master-protocol error line): the request
    was received, dispatched, and raised in the handler.  The stream is
    still in sync and the failure is deterministic — never retried."""


class EpochMismatch(RuntimeError):
    """The shard answered a data op with an OP_EPOCH reply: its routing
    epoch differs from the one the client stamped on the request.  Like
    RemoteOpError this is a complete, well-formed reply — the stream is
    in sync and the socket stays open — and retrying the SAME request
    cannot succeed, so the channel never retries it.  It is retryable
    one level up: the router refreshes its RoutingTable (adopting
    ``table`` when the server is newer, re-installing its own when the
    server is stale) and re-issues the op under the reconciled epoch."""

    def __init__(self, endpoint, epoch, table=None, sent_epoch=None):
        super().__init__(
            f"routing epoch mismatch at {endpoint}: server epoch {epoch}, "
            f"request stamped {sent_epoch}")
        self.endpoint = endpoint
        self.epoch = int(epoch)
        self.table = table  # server's routing meta dict (may be None)
        self.sent_epoch = sent_epoch


class ChannelError(ConnectionError):
    """Retries exhausted: every attempt failed with a retryable transport
    error.  The last underlying error is the __cause__."""


class RetryBudget:
    """Process-wide token-bucket retry budget (the gRPC retry-throttling
    idiom) — storm protection ORTHOGONAL to per-call attempts.

    `rpc_max_attempts` bounds how hard ONE call hammers a server;
    nothing bounds how hard the PROCESS does when a replica dies and a
    thousand in-flight calls all start retrying at once.  The budget
    does: every first attempt deposits ratio/100 tokens (capped at
    `cap`), every retry withdraws one.  Healthy traffic (rare, isolated
    faults) never notices — the bucket sits at the cap.  A mass-failure
    event drains it in ~cap retries, after which further retries fail
    fast (ChannelError, without the backoff sleep) until fresh calls
    earn the budget back — fleet-wide retry amplification is bounded at
    ~ratio% of offered load no matter how many channels share the
    process.

    ratio=0 disables enforcement (every retry allowed — the
    pre-overload-control behavior).  One process-wide instance is
    shared by every channel (`retry_budget()`); tests inject their own
    via ResilientChannel(budget=...) or swap the global with
    `reset_retry_budget()`."""

    def __init__(self, ratio=None, cap=50.0):
        from .. import flags

        self.ratio = (flags.get("retry_budget_ratio")
                      if ratio is None else ratio) / 100.0
        self.cap = float(cap)
        self._tokens = self.cap
        self._lock = threading.Lock()
        self.exhausted = 0  # fail-fast decisions served

    def on_call(self):
        """Deposit for one fresh call (attempt 0)."""
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_retry(self):
        """Withdraw for one retry; False = budget exhausted, fail fast."""
        if self.ratio <= 0:
            return True
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self.exhausted += 1
        _C_BUDGET_EXHAUSTED.inc()
        return False

    def tokens(self):
        with self._lock:
            return self._tokens


_BUDGET_LOCK = threading.Lock()
_PROCESS_BUDGET = None


def retry_budget():
    """The process-wide RetryBudget (lazily built so the flag is read
    after CLI/env overrides land)."""
    global _PROCESS_BUDGET
    with _BUDGET_LOCK:
        if _PROCESS_BUDGET is None:
            _PROCESS_BUDGET = RetryBudget()
        return _PROCESS_BUDGET


def reset_retry_budget(budget=None):
    """Swap (or rebuild on next use, budget=None) the process-wide
    budget — test isolation, or re-reading a changed flag."""
    global _PROCESS_BUDGET
    with _BUDGET_LOCK:
        _PROCESS_BUDGET = budget


class RpcPolicy:
    """Deadline/retry/backoff policy for one channel.

    ``None`` for max_attempts / backoff_base / call_timeout reads the
    corresponding flag (rpc_max_attempts, rpc_backoff_ms,
    rpc_call_timeout_ms) so fleet-wide tuning needs no code change.
    Backoff for attempt k is ``min(backoff_max, backoff_base * 2**k)``
    scaled by a jitter factor drawn from a seeded Random — deterministic
    under test, decorrelated across real clients (seed=None)."""

    __slots__ = ("connect_timeout", "call_timeout", "max_attempts",
                 "backoff_base", "backoff_max", "jitter", "_rng")

    def __init__(self, connect_timeout=5.0, call_timeout=None,
                 max_attempts=None, backoff_base=None, backoff_max=2.0,
                 jitter=0.5, seed=None):
        from .. import flags

        self.connect_timeout = float(connect_timeout)
        self.call_timeout = float(
            flags.get("rpc_call_timeout_ms") / 1e3 if call_timeout is None
            else call_timeout)
        self.max_attempts = max(1, int(
            flags.get("rpc_max_attempts") if max_attempts is None
            else max_attempts))
        self.backoff_base = float(
            flags.get("rpc_backoff_ms") / 1e3 if backoff_base is None
            else backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def is_retryable(self, exc):
        """Transport-level faults retry; replies (RemoteOpError) and
        protocol/logic errors fail fast."""
        if isinstance(exc, (RemoteOpError, EpochMismatch)):
            return False
        return isinstance(exc, (OSError, EOFError))

    def backoff(self, attempt):
        base = min(self.backoff_max, self.backoff_base * (2.0 ** attempt))
        return base * (1.0 + self.jitter * self._rng.random())


class ResilientChannel:
    """One serialized request/response stream with reconnect + retry.

        chan = ResilientChannel("127.0.0.1:6174", policy)
        data = chan.call(lambda sock: transact_one_request(sock))

    ``transact(conn)`` runs exactly one request/reply exchange against the
    live connection and returns the decoded reply.  On any exception the
    socket is invalidated (except RemoteOpError, whose reply was fully
    consumed); retryable errors are retried per policy on a fresh
    connection.  ``wrap`` adapts the raw socket once per connection (e.g.
    ``lambda s: s.makefile("rwb")`` for line-oriented protocols) — the
    wrapped object is what transact receives.

    The channel lock serializes calls: both wire protocols here are
    strict request/reply streams, so interleaving would itself desync."""

    def __init__(self, endpoint, policy=None, wrap=None, name="rpc",
                 budget=None):
        self._endpoint = endpoint  # str or callable -> "host:port"
        self.policy = policy if policy is not None else RpcPolicy()
        self._wrap = wrap
        self._budget = budget  # None -> the process-wide retry_budget()
        self.name = name
        self._lock = threading.RLock()
        self._sock = None
        self._conn = None
        self._ever_connected = False
        self.reconnects = 0  # connections made after the first

    # -- connection management -------------------------------------------
    def endpoint(self):
        ep = self._endpoint
        return ep() if callable(ep) else ep

    def set_endpoint(self, endpoint):
        """Re-point at a new server (failover); drops the live socket."""
        with self._lock:
            self._endpoint = endpoint
            self._invalidate_locked()

    @property
    def connected(self):
        return self._conn is not None

    def _connect_locked(self):
        ep = self.endpoint()
        host, port = ep.rsplit(":", 1)
        sock = socket.create_connection(
            (host, int(port)), self.policy.connect_timeout)
        sock.settimeout(self.policy.call_timeout)
        self._sock = sock
        self._conn = self._wrap(sock) if self._wrap is not None else sock

    def _invalidate_locked(self):
        for obj in (self._conn, self._sock):
            if obj is not None:
                try:
                    obj.close()
                except OSError:
                    pass
        self._conn = None
        self._sock = None

    def invalidate(self):
        """Drop the live connection; the next call reconnects.  This is
        the desync guard: after a timeout the reply may still arrive, and
        only a closed socket guarantees it can never be read as the
        answer to a LATER request."""
        with self._lock:
            self._invalidate_locked()

    def close(self):
        self.invalidate()

    # -- the call loop ----------------------------------------------------
    def call(self, transact, retryable=True):
        """Run transact(conn) with reconnect + bounded retries.

        retryable=False limits to a single attempt (still with
        invalidate-on-error) — for non-idempotent ops whose duplicate
        the caller cannot tolerate (e.g. SHUTDOWN).

        Retries additionally spend the process-wide RetryBudget: when a
        mass-failure event has drained it, the retry fails FAST (no
        backoff sleep, ChannelError immediately) — the storm-damping
        half of the overload control plane."""
        policy = self.policy
        attempts = policy.max_attempts if retryable else 1
        budget = self._budget if self._budget is not None \
            else retry_budget()
        budget.on_call()
        with self._lock:
            last = None
            for attempt in range(attempts):
                if attempt:
                    if not budget.try_retry():
                        _C_GAVE_UP.inc()
                        raise ChannelError(
                            f"{self.name} to {self.endpoint()}: retry "
                            f"budget exhausted after {attempt} "
                            f"attempt(s): {last!r}") from last
                    delay = policy.backoff(attempt - 1)
                    if _telem._ENABLED:
                        _C_RETRIES.inc()
                        _H_BACKOFF.observe(delay * 1e3)
                    time.sleep(delay)
                _C_ATTEMPTS.inc()
                try:
                    # one child span per attempt: frames sent inside it
                    # carry its context, so the server-side handler span
                    # parents under THIS attempt — a retried RPC shows
                    # every attempt in the stitched trace
                    with _tracing.span(f"rpc.{self.name}.attempt",
                                       attempt=attempt):
                        if self._conn is None:
                            self._connect_locked()
                            if self._ever_connected:
                                self.reconnects += 1
                                _C_RECONNECTS.inc()
                            self._ever_connected = True
                        return transact(self._conn)
                except (RemoteOpError, EpochMismatch):
                    # complete reply consumed — stream in sync, keep the
                    # socket, and NEVER retry at this level (epoch
                    # mismatches retry one level up, after a refresh)
                    raise
                except Exception as e:  # noqa: BLE001 — classified below
                    self._invalidate_locked()
                    if not policy.is_retryable(e):
                        raise
                    last = e
            _C_GAVE_UP.inc()
            raise ChannelError(
                f"{self.name} to {self.endpoint()}: gave up after "
                f"{attempts} attempt(s): {last!r}"
            ) from last
