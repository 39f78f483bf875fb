"""Span tracing with explicit trace-id/span-id context that crosses
process boundaries on the RPC wire (counterpart of
paddle_tpu/telemetry/tracing.py).

A *span* is a named, timed interval with a 64-bit trace id (shared by
every span of one logical request) and a 64-bit span id; `span()` nests
via a thread-local current-context stack, so child spans parent
automatically.  The context also rides the RPC frame headers (serving/rpc.py
carries two i64 fields, 0 meaning "no trace"): `wire_context()` is what
senders stamp, `attach()` is how a server handler adopts the caller's
context before opening its own spans.  That is the whole cross-process
story — a serving request's spans stitch client -> handler -> scheduler,
and `resilience.ResilientChannel` opens one child span per retry
attempt, so a retried RPC shows every attempt under the caller's span.

Recording goes to a bounded in-process ring (``telemetry_max_spans``
newest spans win); `export.chrome_trace` renders it, and
`write_spans_jsonl`/`read_spans_jsonl` round-trip buffers across
processes (a soak pulls a server's spans and merges one timeline).

Disabled mode: `span()` returns a shared null context manager and
`wire_context()` returns (0, 0) — no allocation, no id draw, no clock
read.  Timestamps are wall-clock epoch seconds (durations from
perf_counter), so spans from different processes share one timeline.
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time

from . import registry as _reg

__all__ = ["span", "start_span", "attach", "current_context",
           "wire_context", "spans", "take_spans", "reset_spans",
           "SpanContext", "NO_TRACE"]

NO_TRACE = (0, 0)  # wire sentinel: header fields for "no active trace"

_tls = threading.local()
_ids = random.Random()  # process-seeded; ids need uniqueness, not crypto
_ids.seed(os.urandom(16))
_ID_LOCK = threading.Lock()


def _new_id():
    with _ID_LOCK:
        return _ids.getrandbits(63) | 1  # never 0 (0 = "absent" on the wire)


def _default_max_spans():
    try:
        from .. import flags

        return int(flags.get("telemetry_max_spans"))
    except Exception:
        return 50000


_SPANS = collections.deque(maxlen=_default_max_spans())
_SPANS_LOCK = threading.Lock()


class SpanContext:
    """(trace_id, span_id) pair — what propagates, in memory and on the
    wire."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)

    def __iter__(self):  # tuple-compatible: trace, span = ctx
        yield self.trace_id
        yield self.span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id:#x}, {self.span_id:#x})"


def current_context():
    """The innermost active SpanContext on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def wire_context():
    """(trace_id, span_id) ints for an RPC frame header; (0, 0) when
    tracing is disabled or no span is active.  This is the sender half
    of cross-process propagation."""
    if not _reg._ENABLED:
        return NO_TRACE
    stack = getattr(_tls, "stack", None)
    if not stack:
        return NO_TRACE
    ctx = stack[-1]
    return (ctx.trace_id, ctx.span_id)


def _push(ctx):
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)


def _pop():
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


def _record(name, trace_id, span_id, parent_id, t0_epoch, dur_s, status,
            attrs):
    rec = {
        "name": name,
        "trace": trace_id,
        "span": span_id,
        "parent": parent_id or None,
        "ts": t0_epoch,
        "dur": dur_s,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "status": status,
    }
    if attrs:
        rec["attrs"] = attrs
    with _SPANS_LOCK:
        _SPANS.append(rec)


class _NullSpan:
    """Shared do-nothing span for disabled mode (also returned by
    start_span): supports with-statement, end(), and set()."""

    __slots__ = ()
    context = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def end(self, status="ok", **attrs):
        pass

    def set(self, **attrs):
        pass


_NULL = _NullSpan()


def _resolve_parent(parent):
    """parent may be a SpanContext, a (trace_id, span_id) pair, or None
    (inherit the thread's current context / start a fresh trace)."""
    if parent is None:
        return current_context()
    if isinstance(parent, SpanContext):
        return parent
    trace_id, span_id = parent
    if not trace_id:
        return current_context()
    return SpanContext(trace_id, span_id)


class _LiveSpan:
    __slots__ = ("name", "context", "parent_id", "attrs", "_t0_epoch",
                 "_t0", "_done", "_pushed")

    def __init__(self, name, parent, attrs, push):
        parent = _resolve_parent(parent)
        trace_id = parent.trace_id if parent is not None else _new_id()
        self.name = name
        self.context = SpanContext(trace_id, _new_id())
        self.parent_id = parent.span_id if parent is not None else 0
        self.attrs = dict(attrs) if attrs else None
        self._t0_epoch = time.time()
        self._t0 = time.perf_counter()
        self._done = False
        self._pushed = False
        if push:
            _push(self.context)
            self._pushed = True

    def set(self, **attrs):
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)

    def end(self, status="ok", **attrs):
        if self._done:
            return
        self._done = True
        if self._pushed:
            _pop()
            self._pushed = False
        if attrs:
            self.set(**attrs)
        _record(self.name, self.context.trace_id, self.context.span_id,
                self.parent_id, self._t0_epoch,
                time.perf_counter() - self._t0, status, self.attrs)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.end("ok")
        else:
            self.end("error", error=f"{exc_type.__name__}: {exc}")
        return False


def span(name, parent=None, **attrs):
    """Context manager for a lexical span.  Children opened on this
    thread inside the with-block parent to it automatically; RPC frames
    sent inside it carry its context.  No-op (shared null object) when
    telemetry is disabled."""
    if not _reg._ENABLED:
        return _NULL
    return _LiveSpan(name, parent, attrs, push=True)


def start_span(name, parent=None, **attrs):
    """Non-lexical span for cross-thread lifecycles (e.g. a scheduler
    request admitted on one thread and retired on another): does NOT
    install itself as the thread's current context — call `.end()` when
    the interval closes."""
    if not _reg._ENABLED:
        return _NULL
    return _LiveSpan(name, parent, attrs, push=False)


class _Attach:
    __slots__ = ("_ctx",)

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        _push(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        _pop()
        return False


def attach(trace_id, span_id=None):
    """Adopt a remote caller's context on this thread (the receiver half
    of wire propagation): spans opened inside the with-block become
    children of the caller's span.  Accepts (trace_id, span_id) ints or
    a SpanContext; a zero/absent trace id is a no-op."""
    if isinstance(trace_id, SpanContext):
        ctx = trace_id
    else:
        if not trace_id or not _reg._ENABLED:
            return _NULL
        ctx = SpanContext(trace_id, span_id or 0)
    return _Attach(ctx)


def spans():
    """List copy of the recorded span dicts (oldest first)."""
    with _SPANS_LOCK:
        return list(_SPANS)


def take_spans():
    """Drain: return the buffer and clear it (what a STATUS RPC serves
    so a remote collector sees each span once)."""
    with _SPANS_LOCK:
        out = list(_SPANS)
        _SPANS.clear()
    return out


def reset_spans():
    with _SPANS_LOCK:
        _SPANS.clear()
