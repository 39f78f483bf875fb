"""TCP transport for the sharded embedding service (counterpart of
paddle_tpu/sparse/transport.py): the JAX package's wire byte for byte —
op codes, the 29-byte header with its routing epoch and the two
telemetry words, the row and slot packing, the STATUS reply — so each
package's client is served by the other's server.  A shard server is a
host process: this module uses numpy and sockets only, never the card.

reference contract: the gRPC parameter-server channel
(paddle/fluid/operators/distributed/grpc_client.h:175-223 — AsyncSendVar /
AsyncGetVar / AsyncPrefetchVar against listen_and_serv) and the Go pserver
RPC service (go/pserver/service.go:134-346 — SendGrad/GetParam over
net/rpc).  Here the wire is a dependency-free length-prefixed binary
protocol over TCP sockets.  Every frame header carries the sender's
ROUTING EPOCH (the RoutingTable version, see routing.py) so a stale
client and a resharded server detect each other on the first data op,
plus the sender's TELEMETRY TRACE CONTEXT (trace id + span id, 0 when
absent — same always-present-with-sentinel pattern as the epoch) so a
caller's spans stitch across the process boundary:

    frame   := u8 op | u32 payload_len | i64 epoch
               | i64 trace_id | i64 span_id | payload
               header: 29 bytes (<BIqqq), the JAX package's _HDR
    LOOKUP  := u32 n | n*i64 ids                 -> n*dim f32 rows
    PUSH    := u32 n | n*i64 ids | n*dim f32     -> u8 ok
    STATE   := -                                 -> u32 n | ids | rows
    SAVE    := utf8 dirname                      -> u8 ok
    PING    := -                                 -> u8 ok (+meta json incl epoch)
    SHUTDOWN:= -                                 -> u8 ok, server exits
    ROUTE   := -                                 -> routing-table json ("" if none)
    INSTALL := routing-table json                -> u8 ok (adopts epoch)
    EXPORT  := u32 num_slots | u32 k | k*u32     -> row blob (slot snapshot)
    IMPORT  := row blob                          -> u8 ok (bulk adopt)
    DROP    := u32 num_slots | u32 k | k*u32     -> u8 ok (forget slots)
    STATUS  := -                                 -> telemetry json
               ({"metrics": registry snapshot, "spans": drained span ring})

    row blob := u32 n | n*i64 ids | n*dim f32 vals | n*f32 accum

Epoch semantics: LOOKUP/PUSH with epoch >= 0 are checked against the
shard's installed epoch; on mismatch the server answers OP_EPOCH (its
epoch + full table json) instead of serving — the client refreshes its
RoutingTable and retries (resilience.channel.EpochMismatch), so a stale
trainer fails FAST and converges rather than silently reading rows from
a shard that no longer owns them.  EPOCH_NONE (-1) skips the check
(control ops, and the migration coordinator's pre-cutover traffic).

One process serves one shard (`serve_shard`, the `go/pserver` role);
`RemoteEmbeddingService` gives trainers the exact EmbeddingService API over
a set of endpoints, so `DistributedEmbedding`/`SparseTrainStep` (api.py)
work unchanged against remote shards.
"""

from __future__ import annotations

import json
import os

import socketserver
import struct
import threading
import time

import numpy as np

from ..telemetry import registry as _telem
from ..telemetry import tracing as _tracing
from .embedding_service import SelectedRows, Shard, ShardRouter
from .routing import RoutingTable

OP_LOOKUP = 1
OP_PUSH = 2
OP_STATE = 3
OP_SAVE = 4
OP_PING = 5
OP_SHUTDOWN = 6
OP_LOAD = 7
OP_ROUTE = 8     # fetch the shard's installed routing table
OP_INSTALL = 9   # install a routing table (cutover / recovery)
OP_EXPORT = 10   # snapshot rows for a slot set (migration source)
OP_IMPORT = 11   # bulk-adopt rows (migration destination)
OP_DROP = 12     # forget rows for a slot set (post-cutover source)
OP_STATUS = 13   # pull telemetry: metrics snapshot + drained span ring
OP_EPOCH = 254  # reply op: epoch mismatch; payload = {"epoch", "table"} json
OP_ERROR = 255  # reply op: utf8 traceback of a server-side failure

EPOCH_NONE = -1  # header epoch meaning "do not check"

# op, payload_len, routing epoch, telemetry trace id, telemetry span id
# (trace/span are 0 when the sender has no active trace — receivers that
# ignore telemetry just never look at the two extra words)
_HDR = struct.Struct("<BIqqq")

_OP_NAMES = {
    OP_LOOKUP: "lookup", OP_PUSH: "push", OP_STATE: "state",
    OP_SAVE: "save", OP_PING: "ping", OP_SHUTDOWN: "shutdown",
    OP_LOAD: "load", OP_ROUTE: "route", OP_INSTALL: "install",
    OP_EXPORT: "export", OP_IMPORT: "import", OP_DROP: "drop",
    OP_STATUS: "status",
}
_OP_HISTS: dict = {}  # op -> Histogram (server-side per-op latency, ms)
_C_EPOCH_REJ = _telem.counter("sparse.epoch_rejections")


def _op_hist(op):
    h = _OP_HISTS.get(op)
    if h is None:
        h = _OP_HISTS[op] = _telem.histogram(
            "sparse.op_ms." + _OP_NAMES.get(op, str(op)))
    return h

class MultiShardError(RuntimeError):
    """Two or more shard RPCs of one fan-out failed.  ``failures`` is
    [(endpoint, method, exception)] — every failed shard, not just the
    first future to raise."""

    def __init__(self, failures):
        self.failures = list(failures)
        parts = ", ".join(
            f"{ep} ({meth}: {type(e).__name__}: {e})"
            for ep, meth, e in self.failures
        )
        super().__init__(
            f"{len(self.failures)} shard RPCs failed: {parts}")

def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)

def _send_frame(sock, op, payload=b"", epoch=EPOCH_NONE, trace=None):
    """trace=None stamps the caller's current telemetry span context
    ((0, 0) when tracing is off/idle) — propagation is automatic for
    every sender inside a span."""
    if trace is None:
        trace = _tracing.wire_context()
    sock.sendall(
        _HDR.pack(op, len(payload), epoch, trace[0], trace[1]) + payload)

def _recv_frame(sock):
    """(op, payload) — epoch-agnostic receive for callers that only
    care about the reply body (probes, tests)."""
    op, _epoch, payload = _recv_frame_epoch(sock)
    return op, payload

def _recv_frame_epoch(sock):
    op, epoch, _trace, payload = _recv_frame_full(sock)
    return op, epoch, payload

def _recv_frame_full(sock):
    """(op, epoch, (trace_id, span_id), payload) — what servers read."""
    op, n, epoch, trace_id, span_id = _HDR.unpack(
        _recv_exact(sock, _HDR.size))
    return op, epoch, (trace_id, span_id), _recv_exact(sock, n)

def _pack_slots(slot_list, num_slots):
    slot_list = np.ascontiguousarray(slot_list, dtype=np.uint32).reshape(-1)
    return struct.pack("<II", int(num_slots), len(slot_list)) \
        + slot_list.tobytes()

def _unpack_slots(payload):
    num_slots, k = struct.unpack_from("<II", payload)
    slots = np.frombuffer(payload, np.uint32, k, offset=8).astype(np.int64)
    return slots, num_slots

def _pack_rows(ids, vals, accum, dim):
    ids = np.ascontiguousarray(ids, dtype=np.int64).reshape(-1)
    vals = np.ascontiguousarray(vals, dtype=np.float32).reshape(len(ids), dim)
    accum = np.ascontiguousarray(accum, dtype=np.float32).reshape(-1)
    return struct.pack("<I", len(ids)) + ids.tobytes() + vals.tobytes() \
        + accum.tobytes()

def _unpack_rows(payload, dim):
    (n,) = struct.unpack_from("<I", payload)
    off = 4
    ids = np.frombuffer(payload, np.int64, n, offset=off).copy()
    off += 8 * n
    vals = np.frombuffer(payload, np.float32, n * dim, offset=off)
    vals = vals.reshape(n, dim).copy()
    off += 4 * n * dim
    accum = np.frombuffer(payload, np.float32, n, offset=off).copy()
    return ids, vals, accum

# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _ShardHandler(socketserver.BaseRequestHandler):
    def handle(self):
        shard: Shard = self.server.shard  # type: ignore[attr-defined]
        dim = shard.dim
        sock = self.request
        try:
            while True:
                op, epoch, trace, payload = _recv_frame_full(sock)
                try:
                    if _telem._ENABLED:
                        t0 = time.perf_counter()
                        # adopt the caller's trace so this handler span is
                        # a child of the client-side RPC attempt span
                        with _tracing.attach(*trace), _tracing.span(
                                "sparse." + _OP_NAMES.get(op, str(op))):
                            self._dispatch(
                                sock, shard, dim, op, epoch, payload)
                        _op_hist(op).observe(
                            (time.perf_counter() - t0) * 1e3)
                    else:
                        self._dispatch(sock, shard, dim, op, epoch, payload)
                except (ConnectionError, ConnectionResetError):
                    raise
                except SystemExit:
                    return
                except Exception:
                    # reply with an error frame instead of dropping the
                    # connection — the client gets the server traceback
                    # immediately rather than a 30s opaque socket timeout
                    import traceback

                    _send_frame(
                        sock, OP_ERROR, traceback.format_exc().encode("utf-8")
                    )
        except (ConnectionError, ConnectionResetError):
            return

    def _refuse_epoch(self, sock, shard):
        # stale client (or stale server): answer with our epoch and
        # installed table — a dedicated reply op, NEVER the OP_ERROR
        # path, so the client classifies it retryable-after-refresh
        _C_EPOCH_REJ.inc()
        _send_frame(sock, OP_EPOCH, json.dumps({
            "epoch": shard.epoch, "table": shard.route_meta,
        }).encode("utf-8"), epoch=shard.epoch)

    def _dispatch(self, sock, shard, dim, op, epoch, payload):
        if op in (OP_LOOKUP, OP_PUSH) and epoch != EPOCH_NONE \
                and epoch != shard.epoch:
            self._refuse_epoch(sock, shard)
            return
        if op == OP_LOOKUP:
            (n,) = struct.unpack_from("<I", payload)
            ids = np.frombuffer(payload, np.int64, n, offset=4)
            # ownership check: a routing decision that predates a cutover
            # can carry the NEW epoch but route by the OLD table (mask
            # computed, then the table flipped, then the RPC stamped) —
            # serving it would resurrect dropped rows as virgin inits.
            # Refuse so the client re-routes under the current table.
            if epoch != EPOCH_NONE and not shard.owns(ids).all():
                self._refuse_epoch(sock, shard)
                return
            rows = shard.lookup(ids)
            _send_frame(sock, op, rows.astype(np.float32).tobytes(),
                        epoch=shard.epoch)
        elif op == OP_PUSH:
            (n,) = struct.unpack_from("<I", payload)
            ids = np.frombuffer(payload, np.int64, n, offset=4)
            if epoch != EPOCH_NONE and not shard.owns(ids).all():
                self._refuse_epoch(sock, shard)
                return
            grads = np.frombuffer(
                payload, np.float32, n * dim, offset=4 + 8 * n
            ).reshape(n, dim)
            shard.push(ids, grads)
            _send_frame(sock, op, b"\x01", epoch=shard.epoch)
        elif op == OP_ROUTE:
            meta = shard.route_meta
            _send_frame(sock, op,
                        b"" if meta is None else json.dumps(meta).encode(),
                        epoch=shard.epoch)
        elif op == OP_INSTALL:
            shard.install_route(json.loads(payload.decode("utf-8")))
            _send_frame(sock, op, b"\x01", epoch=shard.epoch)
        elif op == OP_EXPORT:
            slots, num_slots = _unpack_slots(payload)
            blob = shard.export_slots(slots, num_slots)
            _send_frame(sock, op, _pack_rows(
                blob["ids"], blob["vals"], blob["accum"], dim))
        elif op == OP_IMPORT:
            ids, vals, accum = _unpack_rows(payload, dim)
            shard.import_rows(ids, vals, accum)
            _send_frame(sock, op, b"\x01")
        elif op == OP_DROP:
            slots, num_slots = _unpack_slots(payload)
            shard.drop_slots(slots, num_slots)
            _send_frame(sock, op, b"\x01")
        elif op == OP_STATE:
            ids, rows = shard.state()
            out = struct.pack("<I", len(ids)) + ids.tobytes() + \
                rows.astype(np.float32).tobytes()
            _send_frame(sock, op, out)
        elif op == OP_SAVE:
            shard.save(payload.decode("utf-8"))
            _send_frame(sock, op, b"\x01")
        elif op == OP_LOAD:
            shard.load(payload.decode("utf-8"))
            _send_frame(sock, op, b"\x01")
        elif op == OP_STATUS:
            # pull-style telemetry: metrics snapshot + drained span ring
            # (each span is served exactly once, so a periodic scraper
            # sees the full stream without duplicates)
            _send_frame(sock, op, json.dumps({
                "metrics": _telem.snapshot(),
                "spans": _tracing.take_spans(),
            }).encode("utf-8"), epoch=shard.epoch)
        elif op == OP_PING:
            # seed/init_scale ride along so a supervisor in degraded mode
            # can synthesize this shard's exact virgin rows client-side
            meta = json.dumps({
                "index": shard.index, "num_shards": shard.num_shards,
                "dim": shard.dim, "seed": shard._seed,
                "init_scale": shard._scale, "epoch": shard.epoch,
            }).encode()
            _send_frame(sock, op, meta, epoch=shard.epoch)
        elif op == OP_SHUTDOWN:
            _send_frame(sock, op, b"\x01")
            threading.Thread(
                target=self.server.shutdown, daemon=True
            ).start()
            raise SystemExit
        else:
            raise ValueError(f"bad op {op}")

class ShardServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, shard: Shard, host="127.0.0.1", port=0):
        super().__init__((host, port), _ShardHandler)
        self.shard = shard

    @property
    def endpoint(self):
        h, p = self.server_address[:2]
        return f"{h}:{p}"

def serve_shard(shard_index, num_shards, dim, port, optimizer="adagrad",
                learning_rate=0.01, seed=0, init_scale=0.01,
                host="127.0.0.1", ready_file=None, checkpoint_dir=None):
    """Blocking single-shard server process (the go/pserver main).
    checkpoint_dir, when given and populated, restores the shard before
    serving (go/pserver/service.go:346 LoadCheckpoint-on-start)."""
    shard = Shard(shard_index, num_shards, dim, optimizer=optimizer,
                  learning_rate=learning_rate, seed=seed,
                  init_scale=init_scale)
    if checkpoint_dir is not None:
        ckpt = os.path.join(checkpoint_dir, f"shard_{shard_index}.npz")
        if os.path.exists(ckpt):
            shard.load(checkpoint_dir)
    srv = ShardServer(shard, host=host, port=port)
    if ready_file:
        # spawners poll for this file and read the endpoint the moment
        # it appears — write-then-rename so they never see it half-written
        with open(ready_file + ".tmp", "w") as f:
            f.write(srv.endpoint)
        os.replace(ready_file + ".tmp", ready_file)
    srv.serve_forever()

# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RemoteShard:
    """Socket client for one shard server (grpc_client.h:175 role), on a
    ResilientChannel: per-op deadlines, bounded retries with backoff on
    transport faults, reconnect on a fresh socket after any timeout or
    reset (a late reply can never desync the frame stream), and NO retry
    of OP_ERROR replies — a handler that ran and failed must surface its
    traceback, not run again.

    PUSH retries are at-least-once: if the connection dies between the
    server applying a push and the client reading the ack, the retry
    re-applies it.  ShardSupervisor's restore+replay recovery is exempt
    (a restored shard discards the ambiguous tail), and the lease-based
    master/discovery protocols tolerate duplicates by design."""

    def __init__(self, endpoint, dim, timeout=None, policy=None,
                 epoch_source=None):
        from ..resilience.channel import (
            EpochMismatch,
            RemoteOpError,
            ResilientChannel,
            RpcPolicy,
        )

        self.endpoint = endpoint
        self.dim = dim
        if policy is None:
            policy = RpcPolicy(call_timeout=timeout)
        self._remote_op_error = RemoteOpError
        self._epoch_mismatch = EpochMismatch
        # callable -> the client's current routing epoch, stamped on data
        # ops; None sends EPOCH_NONE (unversioned / pre-elastic callers)
        self.epoch_source = epoch_source
        # the resolver indirection lets a supervisor re-point this client
        # at a respawned/standby server via set_endpoint
        self._chan = ResilientChannel(
            lambda: self.endpoint, policy, name="shard")

    def set_endpoint(self, endpoint):
        """Fail over to a replacement server (drops the live socket)."""
        self.endpoint = endpoint
        self._chan.invalidate()

    def _epoch(self):
        return EPOCH_NONE if self.epoch_source is None \
            else int(self.epoch_source())

    def _call(self, op, payload=b"", retryable=True, epoch=EPOCH_NONE):
        def transact(sock):
            _send_frame(sock, op, payload, epoch=epoch)
            rop, data = _recv_frame(sock)
            if rop == OP_ERROR:
                raise self._remote_op_error(
                    f"shard server {self.endpoint} failed:\n"
                    + data.decode("utf-8", "replace")
                )
            if rop == OP_EPOCH:
                info = json.loads(data.decode("utf-8"))
                raise self._epoch_mismatch(
                    self.endpoint, int(info["epoch"]), info.get("table"),
                    sent_epoch=epoch)
            if rop != op:
                raise RuntimeError(
                    f"protocol mismatch: sent {op}, got {rop}")
            return data

        return self._chan.call(transact, retryable=retryable)

    def ping(self):
        return json.loads(self._call(OP_PING).decode())

    def status(self):
        """Pull the server's telemetry: {"metrics": snapshot, "spans":
        [...]}.  Draining — the server's span ring is cleared."""
        return json.loads(self._call(OP_STATUS).decode())

    def lookup(self, ids):
        ids = np.ascontiguousarray(ids, dtype=np.int64).reshape(-1)
        payload = struct.pack("<I", len(ids)) + ids.tobytes()
        data = self._call(OP_LOOKUP, payload, epoch=self._epoch())
        return np.frombuffer(data, np.float32).reshape(len(ids), self.dim).copy()

    def push(self, ids, grads, epoch=None):
        """epoch=None stamps the client's current routing epoch;
        EPOCH_NONE bypasses the server's epoch/ownership checks — the
        supervisor's journal/migration-tail replay uses that (replay is
        authoritative and may legitimately predate the shard's table)."""
        ids = np.ascontiguousarray(ids, dtype=np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        payload = struct.pack("<I", len(ids)) + ids.tobytes() + grads.tobytes()
        self._call(OP_PUSH, payload,
                   epoch=self._epoch() if epoch is None else epoch)

    # -- routing / migration RPCs (epoch-unchecked control plane) ---------
    def get_route(self):
        """The shard's installed RoutingTable meta, or None."""
        data = self._call(OP_ROUTE)
        return json.loads(data.decode("utf-8")) if data else None

    def install_route(self, meta):
        self._call(OP_INSTALL, json.dumps(meta).encode("utf-8"))

    def export_slots(self, slot_list, num_slots):
        data = self._call(OP_EXPORT, _pack_slots(slot_list, num_slots))
        ids, vals, accum = _unpack_rows(data, self.dim)
        return {"ids": ids, "vals": vals, "accum": accum}

    def import_rows(self, ids, vals, accum=None):
        if accum is None:
            accum = np.zeros(len(np.asarray(ids).reshape(-1)), np.float32)
        self._call(OP_IMPORT, _pack_rows(ids, vals, accum, self.dim))

    def drop_slots(self, slot_list, num_slots):
        self._call(OP_DROP, _pack_slots(slot_list, num_slots))

    def state(self):
        data = self._call(OP_STATE)
        (n,) = struct.unpack_from("<I", data)
        ids = np.frombuffer(data, np.int64, n, offset=4)
        rows = np.frombuffer(data, np.float32, n * self.dim, offset=4 + 8 * n)
        return ids.copy(), rows.reshape(n, self.dim).copy()

    def save(self, dirname):
        self._call(OP_SAVE, dirname.encode("utf-8"))

    def load(self, dirname):
        """Restore this shard (rows + adagrad accumulator) from a
        checkpoint dir written by save() — the recovery half of
        go/pserver/service.go LoadCheckpoint (:346)."""
        self._call(OP_LOAD, dirname.encode("utf-8"))

    def shutdown_server(self):
        try:
            # single attempt: retrying SHUTDOWN could kill a respawned
            # replacement that reused the endpoint
            self._call(OP_SHUTDOWN, retryable=False)
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._chan.close()

class RemoteEmbeddingService(ShardRouter):
    """EmbeddingService API over remote shard endpoints: a drop-in for
    DistributedEmbedding/SparseTrainStep (api.py) against real pserver
    processes.  Endpoint order fixes INITIAL shard ownership: endpoints[i]
    must serve shard i of len(endpoints); topology may change afterwards
    (add_shard/remove_shard/install_routing — driven by ShardSupervisor's
    online reshard).  Per-shard RPCs dispatch concurrently (the
    grpc_client.h:175 Async* contract) — a step pays one RTT, not
    num_shards of them.

    Staleness: data RPCs carry self.routing.epoch; a shard at a different
    epoch answers EpochMismatch and prefetch/push transparently reconcile
    (adopt the newer table — growing the client's shard set from the
    table's endpoints if needed — or re-install ours on a stale server)
    and retry.  A client that cannot reconcile raises the mismatch."""

    def __init__(self, endpoints, height, dim, timeout=None, policy=None,
                 routing=None):
        self.height = height
        self.dim = dim
        self.num_shards = len(endpoints)
        self._timeout = timeout
        self._policy = policy
        self.routing = (RoutingTable.modulo(
            self.num_shards, endpoints=list(endpoints))
            if routing is None else routing)
        self._route_lock = threading.RLock()
        self.shards = []
        self._pool = None
        try:
            for ep in endpoints:
                self.shards.append(RemoteShard(
                    ep, dim, timeout, policy,
                    epoch_source=lambda: self.routing.epoch))
            for i, sh in enumerate(self.shards):
                meta = sh.ping()
                if meta["index"] != i or meta["dim"] != dim:
                    raise ValueError(
                        f"endpoint {sh.endpoint} serves shard {meta}, expected "
                        f"index={i}/{self.num_shards} dim={dim}"
                    )
        except Exception:
            for sh in self.shards:
                sh.close()
            raise
        self._resize_pool()

    def _resize_pool(self):
        from concurrent.futures import ThreadPoolExecutor

        old = self._pool
        self._pool = None if self.num_shards <= 1 else ThreadPoolExecutor(
            max_workers=self.num_shards, thread_name_prefix="sparse-rpc")
        if old is not None:
            old.shutdown(wait=False)

    # -- elastic membership ------------------------------------------------
    def add_shard(self, endpoint):
        """Attach a new (initially slot-less) shard server as index
        len(shards).  Routing is unchanged until install_routing bumps
        the epoch — the new shard serves nothing yet."""
        index = len(self.shards)
        sh = RemoteShard(endpoint, self.dim, self._timeout, self._policy,
                         epoch_source=lambda: self.routing.epoch)
        try:
            meta = sh.ping()
            if meta["index"] != index or meta["dim"] != self.dim:
                raise ValueError(
                    f"endpoint {endpoint} serves shard {meta}, expected "
                    f"index={index} dim={self.dim}")
        except Exception:
            sh.close()
            raise
        self.shards.append(sh)
        self.num_shards = len(self.shards)
        self._resize_pool()
        return sh

    def remove_shard(self, index):
        """Detach the TAIL shard (scale-down retires from the end so
        indices stay dense).  The shard must no longer own slots."""
        if index != len(self.shards) - 1:
            raise ValueError(
                f"only the tail shard can be removed (asked {index}, "
                f"tail {len(self.shards) - 1})")
        if len(self.routing.slots_of_shard(index)):
            raise ValueError(f"shard {index} still owns slots")
        sh = self.shards.pop(index)
        sh.close()
        self.num_shards = len(self.shards)
        self._resize_pool()
        return sh

    def install_routing(self, table):
        """Adopt a routing table (newer epochs only; stale installs are
        no-ops so refresh races converge)."""
        with self._route_lock:
            if table.epoch < self.routing.epoch:
                return self.routing
            if table.num_shards > len(self.shards):
                eps = table.endpoints
                if eps is None or len(eps) < table.num_shards:
                    raise ValueError(
                        f"routing epoch {table.epoch} declares "
                        f"{table.num_shards} shards but carries no "
                        f"endpoints for the new ones")
                for ep in eps[len(self.shards):table.num_shards]:
                    self.add_shard(ep)
            self.routing = table
            while table.num_shards < len(self.shards):
                self.remove_shard(len(self.shards) - 1)
            self.num_shards = table.num_shards
            return table

    def _reconcile_epoch(self, mismatch):
        """Converge after an EpochMismatch: adopt the server's newer
        table, or re-install ours on a server that restarted stale."""
        with self._route_lock:
            if mismatch.epoch > self.routing.epoch:
                if mismatch.table is None:
                    raise mismatch  # newer epoch but no table to adopt
                self.install_routing(RoutingTable.from_meta(mismatch.table))
                return
            # server is behind (fresh respawn): push our table at it; an
            # endpoint that is no longer a member was retired by a
            # scale-down — nothing to fix, the retry re-routes under the
            # current table
            for sh in self.shards:
                if sh.endpoint == mismatch.endpoint:
                    sh.install_route(self.routing.to_meta())
                    return

    def _with_epoch_refresh(self, fn, *args):
        from ..resilience.channel import EpochMismatch

        for _attempt in range(3):
            try:
                return fn(*args)
            except EpochMismatch as e:
                self._reconcile_epoch(e)
            except IndexError:
                # the shard list shrank between the routing decision and
                # dispatch (concurrent scale-down) — recompute the masks
                # from the current table and go again
                continue
            except MultiShardError as e:
                stale = [x for _ep, _m, x in e.failures
                         if isinstance(x, EpochMismatch)]
                if len(stale) != len(e.failures):
                    raise
                for x in stale:
                    self._reconcile_epoch(x)
        return fn(*args)  # last try surfaces whatever still fails

    def prefetch(self, ids):
        return self._with_epoch_refresh(super().prefetch, ids)

    def push_sparse_grad(self, grad):
        """Exactly-once push under live resharding.  The whole-batch
        retry in _with_epoch_refresh is fine for lookups but would
        DOUBLE-APPLY a gradient whose fan-out partially landed before an
        epoch flip (one refused portion -> refresh -> the already-applied
        shards take a second optimizer step).  Pushes therefore track
        per-portion completion: a shard either refuses its whole portion
        before touching state (the server's epoch/ownership check runs
        ahead of apply) or applies it once, and only still-pending ids
        are re-routed under the refreshed table."""
        from ..resilience.channel import EpochMismatch

        merged = SelectedRows.merge([grad])
        ids = np.asarray(merged.rows, dtype=np.int64).reshape(-1)
        vals = np.asarray(merged.value, dtype=np.float32)
        remaining = np.ones(len(ids), dtype=bool)
        last = None
        for _attempt in range(4):
            if not remaining.any():
                return
            sub = np.flatnonzero(remaining)
            try:
                portions = [(self.shards[int(s)], sub[m])
                            for s, m in self.routing.shard_masks(ids[sub])]
            except IndexError as e:
                # shard list shrank between the routing decision and
                # dispatch (concurrent scale-down) — recompute
                last = e
                continue
            outcomes = []  # (shard, absolute row idx, exc or None)
            futs, serial = [], []
            pool = self._pool
            if pool is not None and len(portions) > 1:
                for sh, rows in portions:
                    try:
                        futs.append((sh, rows, pool.submit(
                            sh.push, ids[rows], vals[rows])))
                    except RuntimeError:
                        # a concurrent add/remove_shard swapped the pool
                        # out from under us; already-submitted futures
                        # still run, the rest go inline — never both
                        serial.append((sh, rows))
            else:
                serial = portions
            for sh, rows, fut in futs:
                try:
                    fut.result()
                    outcomes.append((sh, rows, None))
                except Exception as e:  # noqa: BLE001 — sorted below
                    outcomes.append((sh, rows, e))
            for sh, rows in serial:
                try:
                    sh.push(ids[rows], vals[rows])
                    outcomes.append((sh, rows, None))
                except Exception as e:  # noqa: BLE001 — sorted below
                    outcomes.append((sh, rows, e))
            hard = []
            for sh, rows, e in outcomes:
                if e is None:
                    remaining[rows] = False
                elif isinstance(e, EpochMismatch):
                    self._reconcile_epoch(e)
                    last = e
                else:
                    hard.append((sh, e))
            if hard:
                # non-epoch failures surface to the resilience layer;
                # the applied portions are marked done, so a caller-level
                # retry of the remainder cannot double-apply
                if len(hard) == 1:
                    raise hard[0][1]
                raise MultiShardError(
                    [(sh.endpoint, "push", e) for sh, e in hard])
        if remaining.any():
            raise last if last is not None else RuntimeError(
                "push_sparse_grad: undispatched ids after retries")

    def _map_shards(self, calls):
        pool = self._pool
        if pool is None or len(calls) <= 1:
            return super()._map_shards(calls)
        futures = []
        for s, meth, args in calls:
            try:
                futures.append(pool.submit(getattr(self.shards[s], meth),
                                           *args))
            except RuntimeError:
                # pool swapped by a concurrent add/remove_shard; this
                # call runs inline below instead
                futures.append(None)
        # wait for EVERY future: `[f.result() ...]` would propagate only
        # the first failure while later futures were still in flight and
        # their exceptions silently dropped — a multi-shard outage must
        # name every failed endpoint, not just the fastest one
        results, failures = [], []
        for (s, meth, args), fut in zip(calls, futures):
            try:
                results.append(fut.result() if fut is not None
                               else getattr(self.shards[s], meth)(*args))
            except Exception as e:  # noqa: BLE001 — aggregated below
                failures.append((self.shards[s].endpoint, meth, e))
                results.append(None)
        if failures:
            if len(failures) == 1:
                raise failures[0][2]
            raise MultiShardError(failures)
        return results

    def save(self, dirname):
        # server-side snapshots; no local meta.json (servers own the state)
        self._map_shards([
            (s, "save", (dirname,)) for s in range(self.num_shards)
        ])

    def close(self, shutdown_servers=False):
        for sh in self.shards:
            if shutdown_servers:
                sh.shutdown_server()
            sh.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

def main(argv=None):
    """CLI entry: python -m paddle_tpu_torch.sparse.server --shard-index 0
    --num-shards 2 --dim 16 --port 0 --ready-file F"""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--shard-index", type=int, required=True)
    p.add_argument("--num-shards", type=int, required=True)
    p.add_argument("--dim", type=int, required=True)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--optimizer", default="adagrad")
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init-scale", type=float, default=0.01)
    p.add_argument("--ready-file", default=None)
    a = p.parse_args(argv)
    serve_shard(a.shard_index, a.num_shards, a.dim, a.port,
                optimizer=a.optimizer, learning_rate=a.learning_rate,
                seed=a.seed, init_scale=a.init_scale, host=a.host,
                ready_file=a.ready_file)

if __name__ == "__main__":
    main()
