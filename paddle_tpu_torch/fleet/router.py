"""FleetRouter — prefix-affine request routing over N serving replicas
(counterpart of paddle_tpu/fleet/router.py: the same routing order,
membership epochs, relay failover and two-tier detour, and the same
wire, so either package's router fronts either package's replicas).

Wire-compatible with `serving.rpc`: a `ServingClient` pointed at the
router cannot tell it from a single replica.  Each SUBMIT is routed by
the prompt's prefix key — the module-level `serving.prompt_key`, the
SAME function the scheduler's prefix cache keys on, and process-stable
(blake2b) precisely so router and replica agree across process
boundaries — hashed onto an epoch-stamped `RoutingTable` slot.  Shared
prompts therefore land on the replica whose BlockPool already holds
the prefix chain, and the single-replica prefix hit rate survives
scale-out.

Load spill: the supervisor scrapes each replica's `serving.queue_depth`
gauge (STATUS op; STATS `waiting` when telemetry is dark) into the
membership table; a request whose affine replica is deeper than the
least-loaded UP replica by `fleet_spill_queue_depth` diverts there
instead — affinity is a preference, never a hot spot.

Failover: the relay records every token it forwards.  A transport
fault (or a cancel the downstream client didn't ask for — the fast
deploy cutover) ejects the replica from membership (epoch+1, its slots
dealt round-robin across survivors via `RoutingTable.redistributed`)
and resubmits the generation to another replica with the recorded
tokens in the SUBMIT meta; the scheduler teacher-forces them (its
evict-and-replay path), the relay verifies the replayed prefix is
bitwise-identical to what it already forwarded, and the stream resumes
— the client sees one uninterrupted generation.

Two-tier topology (disaggregated prefill/decode): pass
`prefill_endpoints=` and prompts whose widest feed spans at least
`fleet_prefill_min_tokens` columns run their prefill on a PREFILL-tier
replica first (`ServingClient.prefill` — prefill_only submit).  The
first token streams downstream the moment that replica emits it, then
the handoff record (KV block payload included) rides the decode-tier
submit via `generate(handoff=...)` — which stays prefix-affine on the
ORIGINAL feed, so shared-prompt locality survives the split.  A dead
prefill replica is ejected from its tier and the next one tried;
losing the whole tier just falls back to single-tier routing (the
decode replica prefills for itself): slower TTFT, zero drops.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
import uuid

import numpy as np

from ..resilience.channel import ChannelError, RemoteOpError, RpcPolicy
from ..serving.overload import AdmissionRejected, CircuitBreaker
from ..serving.rpc import (
    OP_DONE,
    OP_ERROR,
    OP_PING,
    OP_REJECT,
    OP_SHUTDOWN,
    OP_STATS,
    OP_STATUS,
    OP_SUBMIT,
    OP_TOKEN,
    ReplicaDraining,
    ServingClient,
    _recv_frame_traced,
    _send_frame,
    _unpack_submit,
)
from ..serving.scheduler import prompt_key
from ..sparse.routing import RoutingTable
from ..telemetry import registry as _telem
from ..telemetry import tracing as _tracing

__all__ = ["FleetRouter", "NoReplicaAvailable", "probe", "scrape_load"]

_C_ROUTED = _telem.counter("fleet.routed")
_C_SPILLED = _telem.counter("fleet.spilled")
_C_RESUBMITTED = _telem.counter("fleet.resubmitted")
_C_EJECTIONS = _telem.counter("fleet.ejections")
_C_BREAKER_OPEN = _telem.counter("fleet.breaker_open")
_G_REPLICAS_UP = _telem.gauge("fleet.replicas_up")

UP, DRAINING, DOWN = "up", "draining", "down"


class NoReplicaAvailable(ConnectionError):
    """Every replica is ejected or draining — nothing can take the
    request.  Surfaces to the client as an OP_ERROR reply."""


class _ClientGone(Exception):
    """The DOWNSTREAM client vanished mid-relay — cancel upstream, do
    not eject the replica (it did nothing wrong)."""


def probe(endpoint, timeout=2.0):
    """One PING round-trip against a replica (side connection, no
    channel) -> the ping reply dict {ok, max_batch, draining, version,
    pid, loadavg}.  Raises OSError/ConnectionError when dead."""
    host, port = endpoint.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout) as sock:
        sock.settimeout(timeout)
        _send_frame(sock, OP_PING)
        op, _trace, payload = _recv_frame_traced(sock)
        if op != OP_PING:
            raise ConnectionError(f"bad PING reply op {op} from {endpoint}")
        return json.loads(payload.decode("utf-8"))


def scrape_load(endpoint, timeout=2.0):
    """Scrape one replica's load signal: the `serving.queue_depth`
    gauge from its STATUS op, falling back to STATS `waiting` when the
    telemetry registry is dark (gauges only move while enabled).
    Returns (queue_depth, stats_or_none)."""
    host, port = endpoint.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout) as sock:
        sock.settimeout(timeout)
        _send_frame(sock, OP_STATUS)
        op, _trace, payload = _recv_frame_traced(sock)
        if op != OP_STATUS:
            raise ConnectionError(f"bad STATUS reply op {op}")
        snap = json.loads(payload.decode("utf-8")).get("metrics", {})
        depth = snap.get("gauges", {}).get("serving.queue_depth")
        if snap.get("enabled") and depth is not None:
            return float(depth), None
        _send_frame(sock, OP_STATS)
        op, _trace, payload = _recv_frame_traced(sock)
        if op != OP_STATS:
            raise ConnectionError(f"bad STATS reply op {op}")
        stats = json.loads(payload.decode("utf-8"))
        return float(stats["waiting"] + stats["active"]
                     + stats["preempted"]), stats


class _Replica:
    __slots__ = ("index", "endpoint", "state", "queue_depth", "version",
                 "inflight", "failures", "loadavg", "breaker")

    def __init__(self, index, endpoint, breaker=None):
        self.index = index
        self.endpoint = endpoint
        self.state = UP
        self.queue_depth = 0.0   # last scraped load signal
        self.version = None
        self.inflight = 0        # relays currently pinned here
        self.failures = 0        # consecutive probe failures
        self.loadavg = None      # host 1/5/15-min loadavg from last PING
        # per-replica circuit breaker: consecutive relay failures or
        # admission rejects stop traffic here without waiting for the
        # supervisor's down_after PING debounce (sick-but-alive)
        self.breaker = breaker if breaker is not None else CircuitBreaker()

    def view(self):
        return {"index": self.index, "endpoint": self.endpoint,
                "state": self.state, "queue_depth": self.queue_depth,
                "inflight": self.inflight, "version": self.version,
                "loadavg": self.loadavg,
                "breaker": self.breaker.state,
                "breaker_failures": self.breaker.failures}


class _RouterHandler(socketserver.BaseRequestHandler):
    def handle(self):
        router = self.server.router  # type: ignore[attr-defined]
        sock = self.request
        try:
            while True:
                op, trace, payload = _recv_frame_traced(sock)
                try:
                    if op == OP_SUBMIT:
                        if _telem._ENABLED:
                            with _tracing.attach(*trace), \
                                    _tracing.span("fleet.relay"):
                                router._relay(sock, payload)
                        else:
                            router._relay(sock, payload)
                    elif op == OP_STATS:
                        _send_frame(sock, op, json.dumps(
                            router.fleet_view()).encode("utf-8"))
                    elif op == OP_STATUS:
                        _send_frame(sock, op, json.dumps({
                            "metrics": _telem.snapshot(),
                            "spans": _tracing.take_spans(),
                            "fleet": router.fleet_view(),
                        }).encode("utf-8"))
                    elif op == OP_PING:
                        _send_frame(sock, op, json.dumps(
                            {"ok": True, "fleet": True,
                             "epoch": router.table.epoch,
                             "replicas_up": len(router.up_indices()),
                             "num_replicas": router.num_replicas}
                        ).encode("utf-8"))
                    elif op == OP_SHUTDOWN:
                        _send_frame(sock, op, b"\x01")
                        threading.Thread(target=self.server.shutdown,
                                         daemon=True).start()
                        return
                    else:
                        raise ValueError(f"bad op {op}")
                except _ClientGone:
                    return
                except NoReplicaAvailable as e:
                    # a ConnectionError subclass, but the DOWNSTREAM
                    # socket is fine — answer with a proper error reply
                    _send_frame(sock, OP_ERROR, str(e).encode("utf-8"))
                except (ConnectionError, ConnectionResetError, OSError):
                    raise
                except Exception:
                    import traceback

                    _send_frame(sock, OP_ERROR,
                                traceback.format_exc().encode("utf-8"))
        except (ConnectionError, ConnectionResetError, OSError):
            return


class _FleetServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, router, host, port):
        super().__init__((host, port), _RouterHandler)
        self.router = router


class FleetRouter:
    """Front end owning the replica membership table (see module
    docstring).  `start()` serves the wire protocol; the object is also
    directly usable in-process (tests drive `pick`/`eject` without a
    socket in sight)."""

    def __init__(self, endpoints, host="127.0.0.1", port=0, policy=None,
                 num_slots=None, spill_threshold=None, name="fleet",
                 prefill_endpoints=None, prefill_min_tokens=None):
        from .. import flags

        if not endpoints:
            raise ValueError("fleet needs at least one replica endpoint")
        self.name = name
        # -- two-tier topology (disaggregated prefill/decode) --------------
        # prefill replicas live OUTSIDE the routing table: they never own
        # a slot, never take a decode stream.  A long-prompt submit runs
        # its prompt there first (prefill_only), the first token streams
        # back immediately, and the handoff record (KV payload included)
        # rides the decode-tier submit — which stays PREFIX-AFFINE on
        # the original feed, so shared-prompt locality survives the
        # split.  An empty tier (or its total loss) degrades to plain
        # single-tier routing: the prompt prefills on the decode
        # replica — slower TTFT, zero drops.
        self.prefill_replicas = [
            _Replica(i, ep) for i, ep in enumerate(prefill_endpoints or ())]
        self.prefill_min_tokens = int(
            flags.get("fleet_prefill_min_tokens")
            if prefill_min_tokens is None else prefill_min_tokens)
        self.num_replicas = len(endpoints)
        self.breaker_open_after = int(flags.get("breaker_open_after"))
        self.breaker_cooldown_s = flags.get("breaker_cooldown_ms") / 1e3
        self.replicas = [
            _Replica(i, ep, breaker=CircuitBreaker(
                open_after=self.breaker_open_after,
                cooldown_s=self.breaker_cooldown_s,
                on_open=self._on_breaker_open(i)))
            for i, ep in enumerate(endpoints)]
        self.table = RoutingTable.modulo(
            self.num_replicas, num_slots=num_slots,
            endpoints=list(endpoints))
        self.spill_threshold = float(
            flags.get("fleet_spill_queue_depth")
            if spill_threshold is None else spill_threshold)
        self.policy = policy if policy is not None else RpcPolicy(
            connect_timeout=2.0)
        self._num_slots = self.table.num_slots
        self._lock = threading.RLock()   # membership + counters
        self._tls = threading.local()    # per-relay-thread replica clients
        self.counters = {"routed": 0, "spilled": 0, "rerouted": 0,
                         "resubmitted": 0, "ejections": 0,
                         "readmissions": 0, "relay_errors": 0,
                         "rejected": 0, "breaker_opens": 0,
                         "prefill_routed": 0, "prefill_failovers": 0,
                         "prefill_fallbacks": 0, "handoffs": 0}
        self.events = []                 # (ts, kind, index, detail)
        self._srv = None
        if _telem._ENABLED:
            _G_REPLICAS_UP.set(self.num_replicas)

    # -- wire front end -----------------------------------------------------

    def start(self, host="127.0.0.1", port=0):
        if self._srv is not None:
            raise RuntimeError("router already started")
        self._srv = _FleetServer(self, host, port)
        threading.Thread(target=self._srv.serve_forever, daemon=True,
                         name="fleet-router").start()
        return self

    @property
    def endpoint(self):
        if self._srv is None:
            raise RuntimeError("router not started")
        h, p = self._srv.server_address[:2]
        return f"{h}:{p}"

    def shutdown(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    # -- membership ----------------------------------------------------------

    def _log(self, kind, index, detail=""):
        self.events.append((time.monotonic(), kind, index, detail))

    def _on_breaker_open(self, index):
        """Breaker-trip hook for replica `index` (counter + event log;
        deferred via closure so _Replica stays lock-free)."""
        def fired():
            with self._lock:
                self.counters["breaker_opens"] += 1
            _C_BREAKER_OPEN.inc()
            self._log("breaker_open", index)
        return fired

    def up_indices(self):
        with self._lock:
            return [r.index for r in self.replicas if r.state == UP]

    def _rebuild_table(self):
        """Recompute slot ownership from replica states: canonical
        modulo placement, then every non-UP replica's slots dealt
        round-robin across UP survivors (RoutingTable.redistributed) —
        deterministic, so any observer derives the same table.  One
        visible epoch bump per membership change."""
        eps = [r.endpoint for r in self.replicas]
        up = [r.index for r in self.replicas if r.state == UP]
        t = RoutingTable.modulo(self.num_replicas,
                                num_slots=self._num_slots, endpoints=eps)
        if up and len(up) < self.num_replicas:
            for r in self.replicas:
                if r.state != UP:
                    t = t.redistributed(r.index, survivors=up)
        self.table = RoutingTable(t.slots, self.num_replicas,
                                  epoch=self.table.epoch + 1,
                                  endpoints=eps)
        if _telem._ENABLED:
            _G_REPLICAS_UP.set(len(up))

    def _tier_replicas(self, tier):
        if tier == "prefill":
            return self.prefill_replicas
        if tier != "decode":
            raise ValueError(f"unknown tier {tier!r}")
        return self.replicas

    def eject(self, index, reason="probe", tier="decode"):
        """Take a replica out of membership (dead or unreachable): its
        slots redistribute across survivors, epoch bumps.  Idempotent.
        tier="prefill" ejects from the prefill tier instead — no table
        rebuild (prefill replicas own no slots); the tier just shrinks,
        and at zero the router falls back to single-tier routing."""
        with self._lock:
            rep = self._tier_replicas(tier)[index]
            if rep.state == DOWN:
                return False
            rep.state = DOWN
            if tier == "decode":
                self._rebuild_table()
            self.counters["ejections"] += 1
            _C_EJECTIONS.inc()
            self._log("eject", index, f"{tier}: {reason}"
                      if tier != "decode" else reason)
            return True

    def set_draining(self, index, draining=True, tier="decode"):
        """Deploy ANNOUNCE: mark a replica DRAINING so new traffic
        routes away while its in-flight work finishes (or undo it)."""
        with self._lock:
            rep = self._tier_replicas(tier)[index]
            want = DRAINING if draining else UP
            if rep.state == want:
                return
            rep.state = want
            if tier == "decode":
                self._rebuild_table()
            self._log("drain" if draining else "undrain", index)

    def readmit(self, index, endpoint=None, version=None, tier="decode"):
        """Bring a replica back into membership (recovered, or the new
        process after a deploy cutover), optionally at a new endpoint."""
        with self._lock:
            rep = self._tier_replicas(tier)[index]
            if endpoint is not None:
                rep.endpoint = endpoint
            if version is not None:
                rep.version = version
            rep.state = UP
            rep.failures = 0
            rep.queue_depth = 0.0
            rep.breaker.reset()  # the new process inherits no grudges
            if tier == "decode":
                self._rebuild_table()
            self.counters["readmissions"] += 1
            self._log("readmit", index, rep.endpoint)

    def scrape(self, index, timeout=2.0):
        """Refresh one replica's load signal (queue depth).  Returns the
        depth; raises on transport failure (caller decides ejection)."""
        rep = self.replicas[index]
        depth, _stats = scrape_load(rep.endpoint, timeout=timeout)
        rep.queue_depth = depth
        return depth

    def scrape_all(self, timeout=2.0):
        """Best-effort scrape of every non-DOWN replica (tests and
        supervisor-less setups; FleetSupervisor does this on a loop)."""
        for rep in self.replicas:
            if rep.state != DOWN:
                try:
                    self.scrape(rep.index, timeout=timeout)
                except (OSError, ConnectionError):
                    pass

    def fleet_view(self):
        """The aggregate STATUS/STATS payload: membership epoch, router
        counters, and one row per replica — what telemetry_dump renders
        and the bench scrapes."""
        with self._lock:
            return {
                "fleet": True,
                "epoch": self.table.epoch,
                "num_replicas": self.num_replicas,
                "num_slots": self._num_slots,
                "spill_threshold": self.spill_threshold,
                "counters": dict(self.counters),
                "replicas": [r.view() for r in self.replicas],
                "prefill_min_tokens": self.prefill_min_tokens,
                "prefill_replicas": [r.view()
                                     for r in self.prefill_replicas],
            }

    # -- routing -------------------------------------------------------------

    def affine_index(self, feed, eos_id=None, bos_id=None):
        """The replica the prompt's prefix key hashes to under the
        CURRENT table (already excludes non-UP replicas)."""
        key = prompt_key(feed, eos_id, bos_id)
        return int(self.table.slots[key % self._num_slots])

    def pick(self, feed, eos_id=None, bos_id=None, exclude=()):
        """(replica_index, verdict) for one submit: the affine replica
        unless it is out of membership ("rerouted") or its scraped queue
        depth exceeds the least-loaded candidate's by the spill
        threshold ("spilled"); verdict "affine" otherwise.

        An OPEN circuit breaker excludes its replica exactly like
        membership does; a cooled-down breaker lets the request through
        as its HALF_OPEN probe (acquire() under the router lock, so one
        probe flows at a time)."""
        with self._lock:
            cands = [r for r in self.replicas
                     if r.state == UP and r.index not in exclude
                     and r.breaker.available()]
            if not cands:
                raise NoReplicaAvailable(
                    f"no UP replica (of {self.num_replicas}) can take "
                    f"the request (excluded: {sorted(exclude)}, "
                    f"breakers: "
                    f"{[r.breaker.state for r in self.replicas]})")
            affine = self.affine_index(feed, eos_id, bos_id)
            by_load = min(cands, key=lambda r: (r.queue_depth, r.inflight,
                                                r.index))
            for r in cands:
                if r.index == affine:
                    if r.queue_depth > by_load.queue_depth \
                            + self.spill_threshold:
                        self.counters["spilled"] += 1
                        _C_SPILLED.inc()
                        by_load.breaker.acquire()
                        return by_load.index, "spilled"
                    r.breaker.acquire()
                    return affine, "affine"
            self.counters["rerouted"] += 1
            by_load.breaker.acquire()
            return by_load.index, "rerouted"

    # -- relay ---------------------------------------------------------------

    def _client_for(self, index, tier="decode"):
        """Per-relay-thread ServingClient per replica (the channel
        serializes calls, so sharing one across relay threads would
        serialize whole generations)."""
        cache = getattr(self._tls, "clients", None)
        if cache is None:
            cache = self._tls.clients = {}
        rep = self._tier_replicas(tier)[index]
        key = (tier, index)
        ent = cache.get(key)
        if ent is None or ent[0] != rep.endpoint:
            if ent is not None:
                ent[1].close()
            cli = ServingClient(
                rep.endpoint, policy=self.policy,
                name=f"{self.name}.{'p' if tier == 'prefill' else 'r'}"
                     f"{index}")
            cache[key] = (rep.endpoint, cli)
            return cli
        return ent[1]

    def _prompt_width(self, feed):
        """Widest feed's axis-1 extent — the spec-agnostic proxy for
        prompt length the prefill-tier threshold gates on (the router
        never knows which feed name carries the prompt ids)."""
        w = 0
        for v in feed.values():
            a = np.asarray(v)
            if a.ndim >= 2:
                w = max(w, int(a.shape[1]))
        return w

    def _prefill_leg(self, meta, feed, rid, remaining):
        """Run the prompt on the prefill tier: (tokens, status,
        handoff_record_or_None) from the first prefill replica that
        takes it, or None when the whole tier is unavailable — the
        caller falls back to a direct decode-tier submit (slower TTFT,
        zero drops).  A dead prefill replica is ejected from its tier
        and the NEXT one tried; nothing is lost because no decode state
        exists yet."""
        with self._lock:
            cands = sorted(
                (r for r in self.prefill_replicas if r.state == UP),
                key=lambda r: (r.inflight, r.index))
        for rep in cands:
            cli = self._client_for(rep.index, tier="prefill")
            with self._lock:
                rep.inflight += 1
                self.counters["prefill_routed"] += 1
            try:
                toks, status, rec = cli.prefill(
                    feed, meta["max_new_tokens"],
                    deadline_ms=remaining,
                    eos_id=meta.get("eos_id"),
                    bos_id=meta.get("bos_id"),
                    request_id=f"{rid}:prefill",
                    retryable=False,
                    priority=meta.get("priority"))
            except (ReplicaDraining, AdmissionRejected):
                continue
            except (ChannelError, ConnectionError, OSError) as e:
                self.eject(rep.index,
                           reason=f"prefill relay: {type(e).__name__}",
                           tier="prefill")
                with self._lock:
                    self.counters["prefill_failovers"] += 1
                continue
            finally:
                with self._lock:
                    rep.inflight -= 1
            return [int(t) for t in toks], status, rec
        return None

    def _relay(self, sock, payload):
        """Forward one SUBMIT to a replica and stream its tokens back,
        failing over (with the delivered-token record) as needed."""
        meta, feed = _unpack_submit(payload)
        rid = meta.get("request_id") or uuid.uuid4().hex
        eos_id, bos_id = meta.get("eos_id"), meta.get("bos_id")
        delivered = list(meta.get("recorded_tokens") or ())
        # tokens the DOWNSTREAM client already holds (its own resubmit
        # history) are not re-sent; everything past them streams live
        sent = {"n": 0}
        skip = len(delivered)

        def forward(tok, i):
            if i < skip:
                return
            try:
                _send_frame(sock, OP_TOKEN, struct.pack("<q", int(tok)))
            except (ConnectionError, ConnectionResetError, OSError) as e:
                raise _ClientGone() from e
            sent["n"] += 1

        def send_reject(reason, retry_after_ms, detail=""):
            with self._lock:
                self.counters["rejected"] += 1
            try:
                _send_frame(sock, OP_REJECT, json.dumps(
                    {"reason": reason, "retry_after_ms": retry_after_ms,
                     "detail": detail}).encode("utf-8"))
            except (ConnectionError, ConnectionResetError, OSError) as e:
                raise _ClientGone() from e

        # remaining-budget deadline semantics: the caller's deadline_ms
        # is anchored HERE, and every failover attempt ships only what
        # is left — time burned streaming from a replica that then died
        # is deducted, never reset
        deadline_ms = meta.get("deadline_ms")
        t_start = time.monotonic()
        # -- prefill tier (two-tier fleet) ---------------------------------
        # fresh long-prompt submits detour through the prefill tier: the
        # first token forwards downstream the moment the prefill replica
        # emits it (the TTFT win), and the handoff record rides the
        # decode submit below.  Continuations (delivered history) and
        # tier loss skip the detour — the decode tier can always prefill
        # for itself.
        handoff = None
        if self.prefill_replicas and not delivered \
                and self._prompt_width(feed) >= self.prefill_min_tokens:
            remaining = None
            if deadline_ms is not None:
                remaining = deadline_ms \
                    - (time.monotonic() - t_start) * 1e3
            leg = self._prefill_leg(meta, feed, rid, remaining)
            if leg is None:
                with self._lock:
                    self.counters["prefill_fallbacks"] += 1
            else:
                ptoks, pstatus, rec = leg
                for t in ptoks:
                    delivered.append(int(t))
                    forward(t, len(delivered) - 1)
                if pstatus == "prefilled" and rec is not None:
                    handoff = rec
                    with self._lock:
                        self.counters["handoffs"] += 1
                elif pstatus in ("done", "expired"):
                    # the generation finished (or died) entirely at the
                    # prefill tier — nothing left for the decode tier
                    _send_frame(sock, OP_DONE, json.dumps({
                        "status": pstatus,
                        "tokens": [int(t) for t in delivered],
                        "latency_ms": None,
                        "replica": None,
                        "verdict": "prefill_tier",
                    }).encode("utf-8"))
                    return
                # any other status: fall through to the decode tier,
                # replaying whatever was already forwarded
        exclude = set()
        last_reject = None
        for _attempt in range(self.num_replicas + 2):
            remaining = None
            if deadline_ms is not None:
                remaining = deadline_ms \
                    - (time.monotonic() - t_start) * 1e3
                if remaining <= 0:
                    send_reject("expired", None,
                                "deadline spent relaying")
                    return
            try:
                idx, verdict = self.pick(feed, eos_id, bos_id,
                                         exclude=exclude)
            except NoReplicaAvailable:
                if last_reject is not None:
                    # every live replica refused admission — forward the
                    # reject (with its backlog hint) instead of erroring
                    send_reject(last_reject.reason,
                                last_reject.retry_after_ms,
                                str(last_reject))
                    return
                raise
            rep = self.replicas[idx]
            cli = self._client_for(idx)
            cursor = {"i": 0}

            def on_token(tok):
                i = cursor["i"]
                cursor["i"] += 1
                if i < len(delivered):
                    if delivered[i] != tok:
                        raise RemoteOpError(
                            f"failover replay diverged at token {i}: "
                            f"relayed {delivered[i]}, got {tok}")
                    return
                delivered.append(int(tok))
                forward(tok, i)

            with self._lock:
                rep.inflight += 1
                self.counters["routed"] += 1
            _C_ROUTED.inc()
            try:
                _toks, status = cli.generate(
                    feed, meta["max_new_tokens"],
                    deadline_ms=remaining,
                    on_token=on_token, eos_id=eos_id, bos_id=bos_id,
                    request_id=rid,
                    recorded_tokens=delivered or None,
                    retryable=False,  # the fleet IS the retry loop
                    priority=meta.get("priority"),
                    handoff=handoff)
            except ReplicaDraining:
                # alive and answering protocol — success for the breaker
                rep.breaker.record_success()
                exclude.add(idx)
                continue
            except AdmissionRejected as e:
                # overloaded-but-alive: another replica may admit it —
                # but a consistent reject RATE trips the breaker, so a
                # replica stuck rejecting stops eating routing attempts
                rep.breaker.record_failure()
                if e.reason == "expired":
                    # no other replica can un-expire a spent deadline
                    send_reject(e.reason, e.retry_after_ms, str(e))
                    return
                last_reject = e
                exclude.add(idx)
                continue
            except RemoteOpError:
                raise  # deterministic server failure -> OP_ERROR reply
            except (ChannelError, ConnectionError, OSError) as e:
                # replica died mid-stream: eject, resubmit elsewhere
                # with the recorded tokens (bitwise continuation)
                rep.breaker.record_failure()
                self.eject(idx, reason=f"relay: {type(e).__name__}")
                exclude.add(idx)
                with self._lock:
                    self.counters["resubmitted"] += 1
                _C_RESUBMITTED.inc()
                continue
            finally:
                with self._lock:
                    rep.inflight -= 1
            rep.breaker.record_success()
            if status == "cancelled":
                # nobody downstream asked for this cancel — the replica
                # was force-drained under us (fast deploy cutover).
                # Resubmit elsewhere like a death, without ejecting.
                exclude.add(idx)
                with self._lock:
                    self.counters["resubmitted"] += 1
                _C_RESUBMITTED.inc()
                continue
            _send_frame(sock, OP_DONE, json.dumps({
                "status": status,
                "tokens": [int(t) for t in delivered],
                "latency_ms": None,
                "replica": idx,
                "verdict": verdict,
            }).encode("utf-8"))
            return
        if last_reject is not None:
            send_reject(last_reject.reason, last_reject.retry_after_ms,
                        str(last_reject))
            return
        with self._lock:
            self.counters["relay_errors"] += 1
        raise NoReplicaAvailable(
            f"request {rid} exhausted the fleet "
            f"(tried {sorted(exclude)})")
