"""RPC front end for the serving scheduler — streamed token responses
over the resilience tier's framing (counterpart of
paddle_tpu/serving/rpc.py, and the same wire byte for byte: a client of
either package talks to a server of the other).

reference: the deployable PaddlePredictor service of PAPER.md §10 (a
C++ server answering Run() over RPC) over a length-prefixed framed
protocol.  The client rides `resilience.ResilientChannel`, so
connect/call deadlines, socket invalidation on desync, and the
OP_ERROR-never-retried discipline are inherited rather than
reimplemented:

    frame    := u8 op | u32 payload_len | i64 trace_id | i64 span_id
                | payload
                header: 21 bytes (<BIqq) — the JAX package's _HDR; keep
                the two in lockstep
    SUBMIT   := json meta | npz feeds     -> TOKEN* (i64 each), then DONE
    DONE     := json {status, tokens, latency_ms}
    STATS    := -                         -> json scheduler stats
    STATUS   := -                         -> telemetry json
                ({"metrics": snapshot, "spans": drained span ring})
    PING     := -                         -> json {ok, max_batch,
                draining, version, loadavg}
    SHUTDOWN := -                         -> u8 ok, server exits
    DRAIN    := json {draining}?          -> json {ok, draining}
    EXPORT   := json {cancel}?            -> json [request records]
    QUIESCE  := json {timeout_s}?         -> json {ok, used_blocks} after
                the pool proves no block leaked (a soak's postcondition)
    REJECT   := reply op: json {reason, retry_after_ms?} — submit
                refused: "draining" (rolling deploy — a router
                re-routes it), "expired" (deadline_ms <= 0 on arrival,
                refused synchronously before the scheduler sees it),
                "infeasible" / "shed_batch" (overload admission gate;
                retry_after_ms hints when the backlog should have
                drained).  Always a complete reply the channel never
                retries
    HANDOFF  := reply op: json meta | npz KV payload (SUBMIT's framing)
                — a prefill_only submit's handoff record, streamed
                after the TOKEN frames and before DONE; feed it to
                another replica's generate(handoff=...) to resume the
                decode there without recomputing the prefill
    ERROR    := reply op: utf8 traceback (server-side failure — a
                complete reply; the channel never retries it)

The two trace words are the telemetry span context (0 = no trace): a
traced client's SUBMIT carries its span ids, the handler attaches them
and opens "serving.submit", and the scheduler's "serving.request" span
becomes its child — one stitched client -> handler -> scheduler trace
per generation.

Deadlines: a request's `deadline_ms` rides the SUBMIT meta — the
scheduler expires the request server-side — AND maps onto the client's
`RpcPolicy.call_timeout` (the per-read socket deadline), so a dead
server and a blown SLO surface through the same policy machinery.

SUBMIT is IDEMPOTENT: every submit carries a client-generated
`request_id` in its meta, and the scheduler dedupes on it — a duplicate
attaches to the original generation and streams its tokens from index 0.
That makes mid-stream transport faults safely retryable: the client
resubmits on a fresh connection, verifies the replayed token prefix is
bitwise-identical to what it already delivered, and resumes the stream
where it left off (`on_token` fires once per token, never twice).  A
router can lean on the same contract to resubmit in-flight requests to a
DIFFERENT replica when one dies — `recorded_tokens` in the meta
pre-loads the history and the new replica teacher-forces it (the
scheduler's evict-and-replay path), so the continuation stays identical.

A client that disconnects mid-stream cancels its request: the handler's
next token write fails, the scheduler drops the request at the step
boundary, and its KV blocks return to the pool.

Threads: the server is a ThreadingTCPServer, one handler thread per
connection beside the Scheduler's loop thread.  A handler only unpacks
frames, calls `Scheduler.submit` (numpy and Python only) and streams the
request's tokens; every program run, CUDA-graph capture and replay stays
on the loop thread, and the handoff record a handler packs holds host
arrays the loop thread copied off the card.
"""

from __future__ import annotations

import io
import json
import os
import socketserver
import struct
import threading
import time
import uuid

import numpy as np

from ..ops.io_ops import _BF16_PREFIX, _bf16_tensor, _to_numpy
from ..resilience.channel import RemoteOpError
from ..telemetry import registry as _telem
from ..telemetry import tracing as _tracing
from .overload import AdmissionRejected
from .scheduler import SchedulerDraining

__all__ = ["ServingServer", "ServingClient", "ReplicaDraining", "serve"]

OP_SUBMIT = 1
OP_TOKEN = 2
OP_DONE = 3
OP_STATS = 4
OP_PING = 5
OP_SHUTDOWN = 6
OP_STATUS = 7   # pull telemetry: metrics snapshot + drained span ring
OP_DRAIN = 8    # flip the scheduler's drain mode (rolling deploys)
OP_EXPORT = 9   # export live requests for cross-replica replay
OP_QUIESCE = 10  # assert the KV pool leaked nothing (soak postcondition)
OP_REJECT = 11  # reply: submit refused (draining) — re-route, don't retry
OP_HANDOFF = 12  # reply: prefill-tier handoff record (json meta + npz
#                  KV payload, SUBMIT's framing) — precedes DONE on a
#                  prefill_only submit that retired "prefilled"
OP_ERROR = 255


class ReplicaDraining(RemoteOpError):
    """The replica refused a SUBMIT because its scheduler is draining
    (rolling deploy).  A complete, well-formed reply — the channel never
    retries it; a router catches it and re-routes."""

# op, payload_len, telemetry trace id, telemetry span id (0, 0 = untraced)
_HDR = struct.Struct("<BIqq")


def _send_frame(sock, op, payload=b"", trace=None):
    if trace is None:
        trace = _tracing.wire_context()
    sock.sendall(
        _HDR.pack(op, len(payload), trace[0], trace[1]) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock):
    op, _trace, payload = _recv_frame_traced(sock)
    return op, payload


def _recv_frame_traced(sock):
    """(op, (trace_id, span_id), payload) — the server reads this so a
    traced caller's context can be attached."""
    op, n, trace_id, span_id = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return op, (trace_id, span_id), _recv_exact(sock, n)


def _pack_submit(feed, meta):
    bio = io.BytesIO()
    np.savez(bio, **{k: np.asarray(v) for k, v in feed.items()})
    blob = bio.getvalue()
    head = json.dumps(meta).encode("utf-8")
    return struct.pack("<I", len(head)) + head + blob


def _unpack_submit(payload):
    (n,) = struct.unpack_from("<I", payload)
    meta = json.loads(payload[4:4 + n].decode("utf-8"))
    with np.load(io.BytesIO(payload[4 + n:])) as z:
        feed = {k: z[k] for k in z.files}
    return meta, feed


# two-tier handoff wire record: SUBMIT's <I>len | json | npz framing.
# The json half is the scheduler's handoff record minus the arrays; the
# npz half carries the KV block payload ("kv:<stream>") and the constant
# per-request states ("st:<feed>") — bitwise, like every npz hop here.
# The port's records hold host arrays (the loop thread copied them off the
# card).  numpy has no bfloat16 without ml_dtypes, so a bfloat16 array
# moves as its int16 bits under "__bf16__" + its name, as ops/io_ops.py
# stores it (the JAX package's records carry no such key: its serving
# tier is float32 here, and so is this slice's).

def _to_wire(name, v):
    """(npz key, numpy array) for one payload array."""
    arr, bf16 = _to_numpy(v)
    return (_BF16_PREFIX + name if bf16 else name), arr


def _from_wire(key, arr):
    """(name, array) for one npz entry: a bfloat16 one as a CPU tensor."""
    if key.startswith(_BF16_PREFIX):
        return key[len(_BF16_PREFIX):], _bf16_tensor(arr)
    return key, arr


def _pack_handoff(rec):
    meta = {k: v for k, v in rec.items() if k not in ("kv", "states")}
    arrays = {}
    for prefix, part in (("kv:", "kv"), ("st:", "states")):
        for name, v in rec.get(part, {}).items():
            key, arr = _to_wire(name, v)
            arrays[prefix + key] = arr
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    head = json.dumps(meta).encode("utf-8")
    return struct.pack("<I", len(head)) + head + bio.getvalue()


def _unpack_handoff(payload):
    (n,) = struct.unpack_from("<I", payload)
    rec = json.loads(payload[4:4 + n].decode("utf-8"))
    rec["kv"], rec["states"] = {}, {}
    with np.load(io.BytesIO(payload[4 + n:])) as z:
        for k in z.files:
            for prefix, part in (("kv:", "kv"), ("st:", "states")):
                if k.startswith(prefix):
                    name, v = _from_wire(k[3:], z[k])
                    rec[part][name] = v
    return rec


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _ServingHandler(socketserver.BaseRequestHandler):
    def handle(self):
        sched = self.server.scheduler  # type: ignore[attr-defined]
        sock = self.request
        try:
            while True:
                op, trace, payload = _recv_frame_traced(sock)
                try:
                    if op == OP_SUBMIT:
                        if _telem._ENABLED:
                            # adopt the caller's context: the handler span
                            # (and the scheduler request span under it)
                            # joins the client's trace
                            with _tracing.attach(*trace), \
                                    _tracing.span("serving.submit"):
                                self._submit(sock, sched, payload)
                        else:
                            self._submit(sock, sched, payload)
                    elif op == OP_STATS:
                        _send_frame(sock, op,
                                    json.dumps(sched.stats()).encode())
                    elif op == OP_STATUS:
                        _send_frame(sock, op, json.dumps({
                            "metrics": _telem.snapshot(),
                            "spans": _tracing.take_spans(),
                        }).encode("utf-8"))
                    elif op == OP_PING:
                        # loadavg rides every ping so a bench can
                        # attribute per-replica throughput to host load
                        _send_frame(sock, op, json.dumps(
                            {"ok": True,
                             "max_batch": sched.max_batch,
                             "draining": sched.draining,
                             "version": getattr(self.server, "version",
                                                None),
                             "pid": os.getpid(),
                             "loadavg": list(os.getloadavg())}).encode())
                    elif op == OP_DRAIN:
                        want = json.loads(payload.decode("utf-8")) \
                            if payload else {}
                        sched.drain(want.get("draining", True))
                        _send_frame(sock, op, json.dumps(
                            {"ok": True,
                             "draining": sched.draining}).encode())
                    elif op == OP_EXPORT:
                        want = json.loads(payload.decode("utf-8")) \
                            if payload else {}
                        recs = sched.export_requests(
                            cancel=want.get("cancel", False))
                        _send_frame(sock, op, json.dumps(recs).encode())
                    elif op == OP_QUIESCE:
                        want = json.loads(payload.decode("utf-8")) \
                            if payload else {}
                        self._quiesce(sock, sched,
                                      want.get("timeout_s", 10.0))
                    elif op == OP_SHUTDOWN:
                        _send_frame(sock, op, b"\x01")
                        threading.Thread(target=self.server.shutdown,
                                         daemon=True).start()
                        return
                    else:
                        raise ValueError(f"bad op {op}")
                except (ConnectionError, ConnectionResetError, OSError):
                    raise
                except Exception:
                    import traceback

                    _send_frame(sock, OP_ERROR,
                                traceback.format_exc().encode("utf-8"))
        except (ConnectionError, ConnectionResetError, OSError):
            return

    def _quiesce(self, sock, sched, timeout_s):
        """Wait for the scheduler to go idle, then prove the pool leaked
        nothing (assert_quiesced raises -> OP_ERROR carries the leak)."""
        import time as _time

        deadline = _time.monotonic() + float(timeout_s)
        while not sched.idle() and _time.monotonic() < deadline:
            _time.sleep(0.02)
        sched.pool.assert_quiesced()
        _send_frame(sock, OP_QUIESCE, json.dumps(
            {"ok": True, "idle": sched.idle(),
             "used_blocks": sched.pool.used_blocks()}).encode())

    def _submit(self, sock, sched, payload):
        meta, feed = _unpack_submit(payload)
        deadline_ms = meta.get("deadline_ms")
        if deadline_ms is not None and deadline_ms <= 0 \
                and not meta.get("recorded_tokens"):
            # the budget was spent in transit/queueing upstream: refuse
            # synchronously at the wire, before the scheduler (and any
            # KV accounting) ever sees the request
            _send_frame(sock, OP_REJECT, json.dumps(
                {"reason": "expired", "retry_after_ms": None,
                 "detail": "deadline spent before arrival"}).encode())
            return
        kv_payload = None
        if meta.get("kv_cursor") is not None:
            # decode-tier resume: the prefill tier's KV rows ride the
            # npz under reserved prefixes — strip them from the feed
            # BEFORE the scheduler hashes/validates it
            rows, states = {}, {}
            for k in list(feed):
                for prefix, part in (("__kv__", rows), ("__st__", states)):
                    if k.startswith(prefix):
                        name, v = _from_wire(k[6:], feed.pop(k))
                        part[name] = v
            kv_payload = {"cursor": int(meta["kv_cursor"]),
                          "rows": rows, "states": states,
                          "last_tok": int(meta["kv_last_tok"]),
                          "n_tokens": int(meta.get("kv_n_tokens", 0))}
        try:
            req = sched.submit(
                feed, meta["max_new_tokens"],
                deadline_ms=deadline_ms,
                eos_id=meta.get("eos_id"), bos_id=meta.get("bos_id"),
                request_id=meta.get("request_id"),
                recorded_tokens=meta.get("recorded_tokens"),
                priority=meta.get("priority") or "interactive",
                prefill_only=bool(meta.get("prefill_only")),
                kv_payload=kv_payload)
        except SchedulerDraining as e:
            _send_frame(sock, OP_REJECT, json.dumps(
                {"reason": "draining", "detail": str(e)}).encode())
            return
        except AdmissionRejected as e:
            _send_frame(sock, OP_REJECT, json.dumps(
                {"reason": e.reason,
                 "retry_after_ms": e.retry_after_ms,
                 "detail": str(e)}).encode())
            return
        with req._cond:
            req._stream_gen += 1
            my_gen = req._stream_gen
        try:
            for tok in req.stream():
                _send_frame(sock, OP_TOKEN, struct.pack("<q", int(tok)))
            if req.status == "prefilled" and req.handoff is not None:
                # the handoff record precedes DONE so a prefill caller
                # gets tokens -> payload -> status in stream order
                _send_frame(sock, OP_HANDOFF, _pack_handoff(req.handoff))
            lat = req.latency()
            _send_frame(sock, OP_DONE, json.dumps({
                "status": req.status,
                "tokens": [int(t) for t in req.tokens],
                "latency_ms": None if lat is None
                else round(lat * 1e3, 3),
            }).encode("utf-8"))
        except (ConnectionError, ConnectionResetError, OSError):
            # mid-stream disconnect: drop the generation, free its blocks
            # — unless a resubmit already re-attached to this request
            # (idempotent retry), in which case it is no longer ours
            with req._cond:
                stale = req._stream_gen != my_gen
            if not stale:
                req.cancel()
            raise


class ServingServer(socketserver.ThreadingTCPServer):
    """TCP front end over one Scheduler (thread-per-connection; the
    scheduler loop itself stays single)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, scheduler, host="127.0.0.1", port=0, version=None):
        super().__init__((host, port), _ServingHandler)
        self.scheduler = scheduler
        # deployed model-version label: rides every PING reply so a
        # rolling deploy can assert the cutover actually flipped it
        self.version = version

    @property
    def endpoint(self):
        h, p = self.server_address[:2]
        return f"{h}:{p}"

    def start(self):
        threading.Thread(target=self.serve_forever, daemon=True,
                         name="serving-rpc").start()
        return self


def serve(spec, scope=None, host="127.0.0.1", port=0, version=None,
          **sched_kwargs):
    """Build a Scheduler for `spec`, start its loop and a server around
    it; returns (server, scheduler).  `sched_kwargs` go to the Scheduler:
    it runs on the card unless given `place=CPUPlace()`."""
    from .scheduler import Scheduler

    sched = Scheduler(spec, scope=scope, **sched_kwargs).start()
    srv = ServingServer(sched, host=host, port=port,
                        version=version).start()
    return srv, sched


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class ServingClient:
    """Streaming generation client on a ResilientChannel.

        cli = ServingClient(endpoint)
        toks, status = cli.generate(feed, max_new_tokens=32,
                                    deadline_ms=500,
                                    on_token=lambda t: ...)

    The channel policy supplies connect deadlines and transport-fault
    classification; `deadline_ms` tightens the per-read socket timeout
    for that one call (RpcPolicy.call_timeout mapped per request) and
    rides the SUBMIT meta so the server expires the request too."""

    def __init__(self, endpoint, policy=None, name="serving"):
        from ..resilience.channel import (
            RemoteOpError,
            ResilientChannel,
            RpcPolicy,
        )

        self.policy = policy if policy is not None else RpcPolicy()
        self._remote_op_error = RemoteOpError
        self._chan = ResilientChannel(endpoint, self.policy, name=name)

    def _reply(self, sock, want):
        op, payload = _recv_frame(sock)
        if op == OP_ERROR:
            raise self._remote_op_error(
                "serving server failed:\n"
                + payload.decode("utf-8", "replace"))
        if op != want:
            raise RuntimeError(f"protocol mismatch: sent {want}, got {op}")
        return payload

    def generate(self, feed, max_new_tokens, deadline_ms=None,
                 on_token=None, eos_id=None, bos_id=None,
                 request_id=None, recorded_tokens=None, retryable=True,
                 priority=None, handoff=None):
        """Returns (tokens int64 [T], status str).  Streaming: on_token
        fires per decoded token as frames arrive.

        Safely resumable: every submit carries a `request_id` (generated
        here unless given), the server dedupes on it, and a transport
        fault mid-stream retries on a fresh connection — the replayed
        token prefix is verified bitwise against what was already
        delivered and `on_token` fires exactly once per token.
        retryable=False restores single-attempt semantics for callers
        that run their own retry loop (a router fails over to a
        DIFFERENT replica instead).  Raises ReplicaDraining when the
        server refuses new work (rolling deploy) — re-route, don't
        retry — and AdmissionRejected (carrying reason +
        retry_after_ms) when the overload gate refuses it.

        deadline_ms is a TOTAL budget, anchored when this call starts:
        every attempt re-packs the SUBMIT meta with the REMAINING
        budget, so time burned on a failed attempt (and its backoff) is
        deducted, never reset — the server-side expiry clock and the
        admission gate see the truth.  A retry whose budget is already
        spent fails fast locally with AdmissionRejected("expired")
        instead of shipping a doomed submit.  priority rides the meta
        ("interactive" default; "batch" marks the request sheddable).

        handoff=<record from prefill()> resumes a prefill-tier request
        on this (decode-tier) replica: the record's KV rows ride the
        npz under reserved "__kv__"/"__st__" feed keys, the server
        adopts them instead of prefilling, and the record's tokens seed
        recorded_tokens — the continuation is bitwise-identical to
        decoding where the prefill ran."""
        return self._generate(
            feed, max_new_tokens, deadline_ms=deadline_ms,
            on_token=on_token, eos_id=eos_id, bos_id=bos_id,
            request_id=request_id, recorded_tokens=recorded_tokens,
            retryable=retryable, priority=priority, handoff=handoff)[:2]

    def prefill(self, feed, max_new_tokens, deadline_ms=None,
                on_token=None, eos_id=None, bos_id=None,
                request_id=None, retryable=True, priority=None):
        """Prefill-tier submit: returns (tokens, status, handoff_record).
        status "prefilled" carries the record (pass it to another
        replica's generate(handoff=...)); "done" means the generation
        finished at its first token and record is None — nothing left
        to decode."""
        return self._generate(
            feed, max_new_tokens, deadline_ms=deadline_ms,
            on_token=on_token, eos_id=eos_id, bos_id=bos_id,
            request_id=request_id, retryable=retryable,
            priority=priority, prefill_only=True)

    def _generate(self, feed, max_new_tokens, deadline_ms=None,
                  on_token=None, eos_id=None, bos_id=None,
                  request_id=None, recorded_tokens=None, retryable=True,
                  priority=None, prefill_only=False, handoff=None):
        rid = request_id if request_id is not None else uuid.uuid4().hex
        t0 = time.monotonic()
        toks = []  # delivered tokens, stable across retry attempts
        rec_cell = [None]  # OP_HANDOFF record, when one arrives
        if handoff is not None:
            from .scheduler import decode_feed

            feed = dict(decode_feed(handoff["feed"]))
            for prefix, part in (("__kv__", "kv"), ("__st__", "states")):
                for name, v in handoff.get(part, {}).items():
                    key, arr = _to_wire(name, v)
                    feed[prefix + key] = arr
            if recorded_tokens is None:
                recorded_tokens = [int(t) for t in handoff["tokens"]]

        def transact(sock):
            remaining = None
            if deadline_ms is not None:
                remaining = deadline_ms - (time.monotonic() - t0) * 1e3
                if remaining <= 0:
                    raise AdmissionRejected(
                        "expired", None,
                        f"deadline budget ({deadline_ms}ms) spent "
                        "client-side")
                # per-request deadline -> this call's socket read budget
                # (plus slack for the final DONE after expiry server-side)
                sock.settimeout(remaining / 1e3
                                + self.policy.call_timeout)
            meta = {"max_new_tokens": int(max_new_tokens),
                    "deadline_ms": remaining, "eos_id": eos_id,
                    "bos_id": bos_id, "request_id": rid}
            if priority is not None:
                meta["priority"] = priority
            if prefill_only:
                meta["prefill_only"] = True
            if handoff is not None:
                meta["kv_cursor"] = int(handoff["cursor"])
                meta["kv_last_tok"] = int(handoff["last_tok"])
                meta["kv_n_tokens"] = int(handoff.get("n_tokens", 0))
            if recorded_tokens is not None or toks:
                # resubmit attempts carry everything delivered so far —
                # a failover target teacher-forces the full history
                meta["recorded_tokens"] = [
                    int(t) for t in (recorded_tokens
                                     if recorded_tokens is not None
                                     and len(recorded_tokens) >= len(toks)
                                     else toks)]
            _send_frame(sock, OP_SUBMIT, _pack_submit(feed, meta))
            cursor = 0  # position in the server's replayed stream
            while True:
                op, data = _recv_frame(sock)
                if op == OP_TOKEN:
                    (t,) = struct.unpack("<q", data)
                    if cursor < len(toks):
                        if toks[cursor] != t:
                            raise self._remote_op_error(
                                f"resubmit diverged at token {cursor}: "
                                f"delivered {toks[cursor]}, replay {t} "
                                "(parity contract violated)")
                    else:
                        toks.append(t)
                        if on_token is not None:
                            on_token(t)
                    cursor += 1
                elif op == OP_HANDOFF:
                    rec_cell[0] = _unpack_handoff(data)
                elif op == OP_DONE:
                    done = json.loads(data.decode("utf-8"))
                    return (np.asarray(toks, np.int64), done["status"],
                            rec_cell[0])
                elif op == OP_REJECT:
                    info = json.loads(data.decode("utf-8"))
                    reason = info.get("reason")
                    if reason == "draining":
                        raise ReplicaDraining(
                            f"submit refused: {reason}")
                    raise AdmissionRejected(
                        reason, info.get("retry_after_ms"),
                        info.get("detail", ""))
                elif op == OP_ERROR:
                    raise self._remote_op_error(
                        "serving server failed:\n"
                        + data.decode("utf-8", "replace"))
                else:
                    raise RuntimeError(f"unexpected op {op} mid-stream")

        return self._chan.call(transact, retryable=retryable)

    def stats(self):
        return json.loads(self._chan.call(
            lambda s: (_send_frame(s, OP_STATS),
                       self._reply(s, OP_STATS))[1]).decode("utf-8"))

    def ping(self):
        return json.loads(self._chan.call(
            lambda s: (_send_frame(s, OP_PING),
                       self._reply(s, OP_PING))[1]).decode("utf-8"))

    def status(self):
        """Pull the server's telemetry: {"metrics": snapshot, "spans":
        [...]}.  Draining — the server's span ring is cleared."""
        return json.loads(self._chan.call(
            lambda s: (_send_frame(s, OP_STATUS),
                       self._reply(s, OP_STATUS))[1]).decode("utf-8"))

    def drain(self, draining=True):
        """Flip the replica's drain mode (deploy ANNOUNCE/abort)."""
        body = json.dumps({"draining": bool(draining)}).encode("utf-8")
        return json.loads(self._chan.call(
            lambda s: (_send_frame(s, OP_DRAIN, body),
                       self._reply(s, OP_DRAIN))[1]).decode("utf-8"))

    def export_requests(self, cancel=False):
        """Pull the replica's live requests as replayable records (see
        Scheduler.export_requests); cancel=True retires them there."""
        body = json.dumps({"cancel": bool(cancel)}).encode("utf-8")
        return json.loads(self._chan.call(
            lambda s: (_send_frame(s, OP_EXPORT, body),
                       self._reply(s, OP_EXPORT))[1]).decode("utf-8"))

    def quiesce(self, timeout_s=10.0):
        """Ask the replica to prove its pool leaked nothing once idle;
        raises RemoteOpError (carrying the server assert) on a leak."""
        body = json.dumps({"timeout_s": float(timeout_s)}).encode("utf-8")
        return json.loads(self._chan.call(
            lambda s: (_send_frame(s, OP_QUIESCE, body),
                       self._reply(s, OP_QUIESCE))[1]).decode("utf-8"))

    def shutdown_server(self):
        try:
            self._chan.call(
                lambda s: (_send_frame(s, OP_SHUTDOWN),
                           self._reply(s, OP_SHUTDOWN))[1],
                retryable=False)
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._chan.close()
