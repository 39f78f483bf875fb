"""ShardSupervisor — health monitoring, failover, and exact recovery for
the remote sparse embedding tier (counterpart of
paddle_tpu/resilience/supervisor.py; host-side Python, the same code).

reference: the Go master re-leased tasks from dead trainers and the
pserver client re-resolved + retried against etcd-registered servers
(SURVEY §2.11); Pathways-style single-controller stacks and the
parameter-server recovery model (Li et al.) both treat worker death as
an expected state transition, not an error.  Shard state is fully
recoverable (per-shard npz + adagrad accumulators); this module closes
the loop so a trainer RIDES THROUGH a shard death:

  1. DETECT — a background monitor pings every shard server on a side
     connection; training-path RPC failures (after the channel's own
     retries) mark the shard down immediately.
  2. FAIL OVER — adopt a discovery-registered standby endpoint if the
     deployment runs warm spares, else respawn the shard process via the
     caller's spawn hook (the go/pserver restart-under-etcd idiom).
  3. RESTORE — OP_LOAD the newest COMMITTED shard checkpoint (manifest
     present + verified), exactly the go/pserver LoadCheckpoint-on-start
     path, but driven remotely by the supervisor.
  4. REPLAY — re-apply every gradient push journaled since that
     checkpoint, in order.  The journal records each successful push
     (and, during an outage in degraded mode, each buffered one), so
     restore + replay reproduces the exact pre-crash row/accumulator
     state: recovery in sync mode is BITWISE-identical to a run that
     never crashed.

Degradation mode (``degraded_lookup=True``, the reference's async
pserver semantics): while a shard is down, lookups serve deterministic
``hash_init_rows`` virgin rows instead of blocking, and pushes buffer
into the journal for replay after recovery — training keeps stepping at
the cost of temporarily stale embeddings.

Journals are truncated only by ``checkpoint()`` (manifest-last atomic
commit); without periodic checkpoints they grow with every push, so
long-running jobs should checkpoint on the same cadence as the dense
state.

LIVE RESHARDING (``reshard(n)``): the supervisor is also the migration
coordinator for the versioned RoutingTable (sparse/routing.py).  A reshard
moves hash slots between shards without pausing the trainer:

  announce — new shards spawn empty and a resized table (epoch+1) is
      installed everywhere; no slot moved yet.
  copy     — per (src, dst) slot group: EXPORT a consistent snapshot of
      the moving rows under src's condition lock (no push interleaves),
      then bulk IMPORT it into dst while trainers keep pushing — every
      push touching a moving slot is TEED into a migration tail (both
      the applied and the degraded-buffered branches).
  cutover  — under src's cond (pushes to src blocked, lookups still
      served): replay the tail onto dst, journal an ("import", blob) +
      tail record on dst (a dst crash after cutover replays to the exact
      migrated state even from a pre-reshard checkpoint), install the
      moved table (epoch+1) on every server and the client, journal a
      ("drop", slots) record on src, release.  Stale in-flight RPCs get
      OP_EPOCH and refresh; nobody ever reads the wrong shard silently.
  cleanup  — DROP the moved rows from src (it served them until the
      epoch flipped — that's the graceful-degradation window).

A migration that fails at any point before its epoch bump unregisters
the tee, discards the tail, best-effort drops the partial dst import,
and leaves the epoch unchanged — the trainer never stops, and src still
owns every row (tail pushes were also applied + journaled to src), so
rollback loses no state and a retry converges (IMPORT replaces
duplicates).  kill -9 of src or dst mid-migration degrades to the
normal recovery path (restore + tagged-journal replay) and the reshard
attempt either completes or rolls back.
"""

from __future__ import annotations

import os
import shutil
import socket
import threading
import time

import numpy as np

from ..telemetry import registry as _telem
from .channel import RemoteOpError

__all__ = ["ShardSupervisor", "ShardDownError"]

_C_FAILOVERS = _telem.counter("supervisor.failovers")
_C_DEGRADED = _telem.counter("supervisor.degraded_lookups")
_C_BUFFERED = _telem.counter("supervisor.pushes_buffered")
_C_RESHARDS = _telem.counter("supervisor.reshards")
_H_MTTR = _telem.histogram("supervisor.mttr_ms")


class ShardDownError(ConnectionError):
    """A shard is down and could not be recovered within the deadline
    (or degradation is off and the wait timed out)."""


class _ShardState:
    __slots__ = ("index", "up", "cond", "journal", "failure", "recovering",
                 "meta", "down_since", "pushed_rows")

    def __init__(self, index):
        self.index = index
        self.up = True
        # cond's lock also guards `journal` and the up/recovering flags;
        # push/replay/checkpoint hold it across their network call so a
        # checkpoint can never interleave between a push and its journal
        # append (which would double-apply the push on replay)
        self.cond = threading.Condition()
        # tagged entries since the last commit, replayed in order:
        #   ("push", ids int64, grads f32)  — an acked/buffered gradient
        #   ("import", blob dict)           — migrated rows adopted at cutover
        #   ("drop", slots, num_slots)      — slots ceded at cutover
        self.journal = []
        self.failure = None
        self.recovering = False
        self.meta = None
        self.down_since = None
        self.pushed_rows = 0  # load signal for autoscale_check


class _Migration:
    """One in-flight slot move: the tee target for pushes that touch the
    moving slots between EXPORT and cutover."""

    __slots__ = ("src", "dst", "slots_arr", "num_slots", "tail")

    def __init__(self, src, dst, slot_list, num_slots):
        self.src = int(src)
        self.dst = int(dst)
        self.slots_arr = np.unique(
            np.asarray(slot_list, dtype=np.int64).reshape(-1))
        self.num_slots = int(num_slots)
        self.tail = []  # [(ids, grads)] in push order


class _SupervisedShard:
    """Proxy installed over ``service.shards[i]``: forwards the
    RemoteShard API, journaling pushes and routing faults to the
    supervisor (block-until-recovered, or degrade)."""

    def __init__(self, sup, index, inner):
        self._sup = sup
        self._index = index
        self.inner = inner
        self.dim = inner.dim

    @property
    def endpoint(self):
        return self.inner.endpoint

    def lookup(self, ids):
        return self._sup._lookup(self._index, ids)

    def push(self, ids, grads):
        return self._sup._push(self._index, ids, grads)

    def save(self, dirname):
        return self._sup._call_up(self._index, "save", dirname)

    def state(self):
        return self._sup._call_up(self._index, "state")

    def load(self, dirname):
        return self.inner.load(dirname)

    def ping(self):
        return self.inner.ping()

    def set_endpoint(self, endpoint):
        return self.inner.set_endpoint(endpoint)

    def shutdown_server(self):
        return self.inner.shutdown_server()

    def close(self):
        return self.inner.close()

    # control-plane passthrough (migration RPCs are journaled explicitly
    # by the supervisor's _migrate, never here)
    def get_route(self):
        return self.inner.get_route()

    def install_route(self, meta):
        return self.inner.install_route(meta)

    def export_slots(self, slot_list, num_slots):
        return self.inner.export_slots(slot_list, num_slots)

    def import_rows(self, ids, vals, accum=None):
        return self.inner.import_rows(ids, vals, accum)

    def drop_slots(self, slot_list, num_slots):
        return self.inner.drop_slots(slot_list, num_slots)


class ShardSupervisor:
    """Supervise a RemoteEmbeddingService: monitor, fail over, restore,
    replay.

        svc = RemoteEmbeddingService(endpoints, height, dim)
        sup = ShardSupervisor(svc, checkpoint_root=ckpt_dir,
                              spawn=respawn_shard).start()
        ...train; sup.checkpoint() on the checkpoint cadence...
        sup.stop()

    ``spawn(shard_index) -> endpoint`` restarts a dead shard process and
    returns its new endpoint; ``standby_resolver(shard_index) ->
    endpoint | None`` adopts a warm spare instead (tried first — e.g. a
    discovery lookup of f"/standby/shard/{i}").  With neither, recovery
    waits for the original endpoint to come back (external restart)."""

    def __init__(self, service, checkpoint_root=None, spawn=None,
                 standby_resolver=None, ping_interval=None,
                 degraded_lookup=None, recovery_timeout=120.0,
                 keep_checkpoints=2):
        from .. import flags

        self.service = service
        self.checkpoint_root = checkpoint_root
        self.spawn = spawn
        self.standby_resolver = standby_resolver
        self.ping_interval = (
            flags.get("shard_ping_interval_ms") / 1e3
            if ping_interval is None else float(ping_interval))
        self.degraded_lookup = (
            bool(flags.get("sparse_degraded_lookup"))
            if degraded_lookup is None else bool(degraded_lookup))
        self.recovery_timeout = float(recovery_timeout)
        self.keep_checkpoints = int(keep_checkpoints)
        self._st = [_ShardState(i) for i in range(service.num_shards)]
        self._committed = []  # committed checkpoint dirs, newest last
        self._ckpt_seq = 0
        self._ckpt_lock = threading.Lock()
        self._monitor = None
        self._stopped = threading.Event()
        self._events_lock = threading.Lock()
        self.events = []  # [(monotonic, kind, shard_index, detail)]
        # live-reshard state: migrations are serialized (one reshard at a
        # time); _migrations[src] lists in-flight slot moves whose tee
        # runs inside _push under src's cond
        self._reshard_lock = threading.Lock()
        self._migrations = {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        if self._monitor is not None:
            return self
        for i, sh in enumerate(self.service.shards):
            if not isinstance(sh, _SupervisedShard):
                self.service.shards[i] = _SupervisedShard(self, i, sh)
            try:
                self._st[i].meta = self.service.shards[i].ping()
            except (ConnectionError, OSError):
                pass  # monitor/guards will handle it
        if self.checkpoint_root:
            os.makedirs(self.checkpoint_root, exist_ok=True)
            self._committed = self._scan_committed()
            if self._committed:
                tail = os.path.basename(self._committed[-1])
                try:
                    self._ckpt_seq = int(tail.rsplit("_", 1)[1]) + 1
                except (IndexError, ValueError):
                    self._ckpt_seq = len(self._committed)
        self._stopped.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="shard-supervisor")
        self._monitor.start()
        return self

    def stop(self):
        self._stopped.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None

    def _log(self, kind, shard, detail=""):
        with self._events_lock:
            self.events.append((time.monotonic(), kind, shard, detail))
            del self.events[:-500]

    def status(self):
        out = {}
        for st in list(self._st):
            with st.cond:
                if st.index >= len(self.service.shards):
                    continue  # retired by a concurrent scale-down
                out[st.index] = {
                    "up": st.up,
                    "recovering": st.recovering,
                    "journal_len": len(st.journal),
                    "endpoint": self.service.shards[st.index].endpoint,
                }
        return out

    @property
    def routing_epoch(self):
        routing = getattr(self.service, "routing", None)
        return None if routing is None else routing.epoch

    # ------------------------------------------------------------------
    # health monitoring
    # ------------------------------------------------------------------
    def _probe(self, index):
        """Side-channel liveness ping: a throwaway connection, so the
        probe never contends the training channel's lock."""
        from ..sparse import transport as tp

        ep = self.service.shards[index].endpoint
        host, port = ep.rsplit(":", 1)
        timeout = max(0.2, min(2.0, self.ping_interval * 4))
        with socket.create_connection((host, int(port)), timeout) as s:
            s.settimeout(timeout)
            tp._send_frame(s, tp.OP_PING)
            rop, _payload = tp._recv_frame(s)
            if rop != tp.OP_PING:
                raise ConnectionError(f"bad ping reply op {rop}")

    def _monitor_loop(self):
        while not self._stopped.wait(self.ping_interval):
            for st in list(self._st):
                with st.cond:
                    skip = (not st.up or st.recovering
                            or st.index >= len(self.service.shards))
                if skip:
                    continue
                try:
                    self._probe(st.index)
                except (ConnectionError, OSError) as e:
                    self._log("ping_failed", st.index, repr(e))
                    self._mark_down(st.index, e)
                except IndexError:
                    continue  # shard retired between the check and probe

    # ------------------------------------------------------------------
    # guarded shard ops (called via _SupervisedShard)
    # ------------------------------------------------------------------
    def _inner(self, index):
        sh = self.service.shards[index]
        return sh.inner if isinstance(sh, _SupervisedShard) else sh

    def _mark_down(self, index, exc):
        st = self._st[index]
        with st.cond:
            self._mark_down_locked(st, exc)

    def _mark_down_locked(self, st, exc):
        if st.up:
            st.up = False
            st.failure = None
            st.down_since = time.monotonic()
            _C_FAILOVERS.inc()
            self._log("shard_down", st.index, repr(exc))
        if not st.recovering:
            st.recovering = True
            threading.Thread(
                target=self._recover_loop, args=(st.index,), daemon=True,
                name=f"shard-recover-{st.index}",
            ).start()

    def _wait_up_locked(self, st):
        """Block (cond held) until the shard is back or recovery fails."""
        deadline = time.monotonic() + self.recovery_timeout
        while not st.up:
            if st.failure is not None:
                raise ShardDownError(
                    f"shard {st.index} unrecoverable"
                ) from st.failure
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ShardDownError(
                    f"shard {st.index} still down after "
                    f"{self.recovery_timeout:.0f}s")
            st.cond.wait(timeout=min(remaining, 0.5))

    def _virgin_rows(self, index, ids):
        from ..sparse.embedding_service import hash_init_rows

        st = self._st[index]
        meta = st.meta or {}
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        return hash_init_rows(ids, self.service.dim,
                              seed=meta.get("seed", 0),
                              scale=meta.get("init_scale", 0.01))

    def _lookup(self, index, ids):
        st = self._st[index]
        while True:
            with st.cond:
                if not st.up:
                    if self.degraded_lookup:
                        _C_DEGRADED.inc()
                        self._log("degraded_lookup", index)
                        return self._virgin_rows(index, ids)
                    self._wait_up_locked(st)
            try:
                return self._inner(index).lookup(ids)
            except RemoteOpError:
                raise
            except (ConnectionError, OSError) as e:
                self._mark_down(index, e)

    def _tee_locked(self, index, ids, grads):
        """Dual-write (cond held): pushes touching a moving slot also land
        in the migration tail, replayed onto dst at cutover."""
        for mig in self._migrations.get(index, ()):
            mask = np.isin(ids % mig.num_slots, mig.slots_arr)
            if mask.any():
                mig.tail.append((ids[mask], grads[mask]))

    def _push(self, index, ids, grads):
        st = self._st[index]
        ids = np.array(ids, dtype=np.int64, copy=True).reshape(-1)
        grads = np.array(grads, dtype=np.float32, copy=True)
        with st.cond:
            st.pushed_rows += len(ids)
            while True:
                if not st.up:
                    if self.degraded_lookup:
                        # buffer-only: applied during recovery replay
                        st.journal.append(("push", ids, grads))
                        self._tee_locked(index, ids, grads)
                        _C_BUFFERED.inc()
                        self._log("push_buffered", index)
                        return
                    self._wait_up_locked(st)
                try:
                    self._inner(index).push(ids, grads)
                    st.journal.append(("push", ids, grads))
                    self._tee_locked(index, ids, grads)
                    return
                except RemoteOpError:
                    raise
                except (ConnectionError, OSError) as e:
                    self._mark_down_locked(st, e)

    def _call_up(self, index, meth, *args):
        """save/state passthrough: wait for a live shard, fail over on
        transport errors like the hot paths."""
        st = self._st[index]
        while True:
            with st.cond:
                if not st.up:
                    self._wait_up_locked(st)
            try:
                return getattr(self._inner(index), meth)(*args)
            except RemoteOpError:
                raise
            except (ConnectionError, OSError) as e:
                self._mark_down(index, e)

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _recover_loop(self, index):
        st = self._st[index]
        t0 = time.monotonic()
        attempt = 0
        while not self._stopped.is_set():
            try:
                self._recover_once(index)
                mttr = time.monotonic() - (st.down_since or t0)
                _H_MTTR.observe(mttr * 1e3)
                self._log("shard_recovered", index, f"mttr={mttr:.3f}s")
                return
            except Exception as e:  # noqa: BLE001 — retried below
                self._log("recovery_attempt_failed", index, repr(e))
                if time.monotonic() - t0 > self.recovery_timeout:
                    with st.cond:
                        st.failure = e
                        st.recovering = False
                        st.cond.notify_all()
                    self._log("recovery_gave_up", index, repr(e))
                    return
                attempt += 1
                time.sleep(min(2.0, 0.05 * (2 ** min(attempt, 5))))
        with st.cond:
            st.recovering = False
            st.cond.notify_all()

    def _recover_once(self, index):
        st = self._st[index]
        inner = self._inner(index)
        # 1. where is the replacement? standby first, then respawn, else
        # wait for the original endpoint to return
        endpoint = None
        if self.standby_resolver is not None:
            endpoint = self.standby_resolver(index)
            if endpoint:
                self._log("standby_adopted", index, endpoint)
        if endpoint is None and self.spawn is not None:
            endpoint = self.spawn(index)
            self._log("shard_respawned", index, endpoint or "")
        if endpoint and endpoint != inner.endpoint:
            inner.set_endpoint(endpoint)
        # 2. verify identity before trusting it with state.  num_shards
        # is deliberately NOT checked: after a live reshard the respawned
        # process carries the shard count it was launched with, and the
        # routing table (installed below) is the topology authority now.
        meta = inner.ping()
        if (meta.get("index") != index
                or meta.get("dim") != self.service.dim):
            raise ConnectionError(
                f"replacement at {inner.endpoint} serves {meta}, expected "
                f"shard {index} dim={self.service.dim}")
        # 3+4. restore newest committed checkpoint, then replay the
        # journal — under the cond so no push can interleave, and so
        # up=True + the replay are one atomic transition.  The committed
        # dir is read BEFORE taking the cond: checkpoint() holds
        # _ckpt_lock while waiting for shards to come up, so taking
        # _ckpt_lock under st.cond would invert the order and deadlock.
        ckpt = self.newest_committed()
        with st.cond:
            st.meta = meta
            if ckpt is not None and os.path.exists(
                    os.path.join(ckpt, f"shard_{index}.npz")):
                # a shard added by reshard AFTER the checkpoint has no
                # npz there — it restores purely from its journal (whose
                # first entry is the migration's "import" record)
                inner.load(ckpt)
                self._log("checkpoint_restored", index, ckpt)
            routing = getattr(self.service, "routing", None)
            if routing is not None:
                inner.install_route(routing.to_meta())
            self._replay_locked(inner, st)
            st.up = True
            st.recovering = False
            st.failure = None
            st.cond.notify_all()

    def _replay_locked(self, inner, st):
        """Re-apply the tagged journal in order (cond held).  Replay
        pushes bypass the wire epoch/ownership check (EPOCH_NONE): the
        journal is the authority on what this shard applied, and its
        tail may straddle epoch bumps."""
        from ..sparse.transport import EPOCH_NONE

        for entry in st.journal:
            kind = entry[0]
            if kind == "push":
                inner.push(entry[1], entry[2], epoch=EPOCH_NONE)
            elif kind == "import":
                blob = entry[1]
                inner.import_rows(blob["ids"], blob["vals"], blob["accum"])
            elif kind == "drop":
                inner.drop_slots(entry[1], entry[2])
            else:
                raise ValueError(f"unknown journal entry {kind!r}")
        if st.journal:
            self._log("journal_replayed", st.index,
                      f"{len(st.journal)} entries")

    # ------------------------------------------------------------------
    # live resharding (the RoutingTable migration coordinator)
    # ------------------------------------------------------------------
    def _install_table(self, table, upto=None):
        """Install a routing table on shard servers [0, upto) (all when
        None) and then on the client.  A server that cannot be reached is
        logged and skipped — the client's epoch-mismatch reconcile (and
        shard recovery, which installs the current table) converge it."""
        meta = table.to_meta()
        n = len(self._st) if upto is None else int(upto)
        for i in range(n):
            try:
                self._call_up(i, "install_route", meta)
            except Exception as e:  # noqa: BLE001 — convergent later
                self._log("install_route_failed", i, repr(e))
        self.service.install_routing(table)

    def _migrate_group(self, src, dst, slot_list):
        """Move one (src, dst) slot group: export → dual-write copy →
        cutover (tail replay + journal + epoch bump) → drop.  Raises on
        failure BEFORE the commit point with the tee unregistered, the
        tail discarded, and the partial dst import dropped — the epoch is
        unchanged and src still owns every row (rollback, no state
        loss)."""
        from ..sparse.transport import EPOCH_NONE

        svc = self.service
        num_slots = svc.routing.num_slots
        mig = _Migration(src, dst, slot_list, num_slots)
        src_st, dst_st = self._st[src], self._st[dst]
        # phase 1 — consistent snapshot + tee registration, atomic vs
        # pushes (every push holds src's cond across apply + journal)
        with src_st.cond:
            self._wait_up_locked(src_st)
            try:
                blob = self._inner(src).export_slots(
                    mig.slots_arr, num_slots)
            except (ConnectionError, OSError) as e:
                self._mark_down_locked(src_st, e)
                raise
            self._migrations.setdefault(src, []).append(mig)
        committed = False
        try:
            # phase 2 — bulk copy; the trainer keeps pushing to src and
            # the tee collects everything that touches a moving slot
            self._call_up(dst, "import_rows",
                          blob["ids"], blob["vals"], blob["accum"])
            # phase 3 — cutover under src's cond (pushes to src block;
            # lookups still serve from src: the degradation window)
            with src_st.cond:
                self._wait_up_locked(src_st)
                with dst_st.cond:
                    self._wait_up_locked(dst_st)
                    dst_inner = self._inner(dst)
                    for t_ids, t_grads in mig.tail:
                        dst_inner.push(t_ids, t_grads, epoch=EPOCH_NONE)
                    # journal import + tail on dst: a dst crash from here
                    # on replays to the exact migrated state, even from a
                    # checkpoint that predates this shard's existence
                    dst_st.journal.append(("import", blob))
                    dst_st.journal.extend(
                        ("push", a, b) for a, b in mig.tail)
                # COMMIT POINT — dst now reproduces src's push history
                # for the moved slots, durably (journal + recovery)
                committed = True
                new_table = svc.routing.moved(mig.slots_arr, dst)
                svc.install_routing(new_table)  # client flips first
                src_st.journal.append(
                    ("drop", mig.slots_arr.copy(), num_slots))
                self._migrations[src].remove(mig)
            # phase 4 — convergence + cleanup, outside the cond: stale
            # servers answer OP_EPOCH until their install lands (either
            # here or via the client's reconcile)
            meta = new_table.to_meta()
            for i in range(len(self._st)):
                try:
                    self._call_up(i, "install_route", meta)
                except Exception as e:  # noqa: BLE001
                    self._log("install_route_failed", i, repr(e))
            try:
                self._call_up(src, "drop_slots", mig.slots_arr, num_slots)
            except Exception as e:  # noqa: BLE001 — replayed on recovery
                self._log("drop_deferred", src, repr(e))
            self._log("slots_moved", src,
                      f"{len(mig.slots_arr)} slots -> shard {dst}, "
                      f"epoch {new_table.epoch}")
        except BaseException:
            if not committed:
                with src_st.cond:
                    migs = self._migrations.get(src, [])
                    if mig in migs:
                        migs.remove(mig)
                    mig.tail.clear()
                try:  # forget the partial bulk copy (replaced on retry
                    # anyway — import_rows replaces duplicates)
                    self._inner(dst).drop_slots(mig.slots_arr, num_slots)
                except Exception:  # noqa: BLE001 — dst may be dead
                    pass
                self._log("migration_rolled_back", src,
                          f"{len(mig.slots_arr)} slots -> shard {dst}")
            raise

    def reshard(self, target_num_shards, endpoints=None, timeout=None):
        """Live topology change to ``target_num_shards`` (canonical
        placement), without pausing trainers.  Scale-up endpoints come
        from ``endpoints`` or the ``spawn`` hook; scale-down retires the
        tail shards after draining their slots.  Each slot group is
        migrated atomically and retried (rollback + re-export) on
        failure until ``timeout`` (default 4x recovery_timeout)."""
        svc = self.service
        target = int(target_num_shards)
        if target < 1:
            raise ValueError("need at least one shard")
        with self._reshard_lock:
            start_n = svc.num_shards
            if target == start_n:
                return svc.routing
            t0 = time.monotonic()
            deadline = t0 + (max(60.0, 4 * self.recovery_timeout)
                             if timeout is None else float(timeout))
            _C_RESHARDS.inc()
            self._log("reshard_started", -1, f"{start_n}->{target}")
            if target > start_n:
                for i in range(start_n, target):
                    ep = None
                    if endpoints:
                        ep = endpoints[i - start_n]
                    elif self.spawn is not None:
                        ep = self.spawn(i)
                    if not ep:
                        raise ValueError(
                            f"scale-up to {target}: no endpoint or spawn "
                            f"hook for new shard {i}")
                    with self._ckpt_lock:
                        inner = svc.add_shard(ep)
                        svc.shards[i] = _SupervisedShard(self, i, inner)
                        st = _ShardState(i)
                        try:
                            st.meta = inner.ping()
                        except (ConnectionError, OSError):
                            pass
                        self._st.append(st)
                    self._log("shard_added", i, ep)
                self._install_table(svc.routing.resized(
                    target, endpoints=[sh.endpoint for sh in svc.shards]))
            for (src, dst), slot_list in sorted(
                    svc.routing.plan_moves(target).items()):
                while True:
                    try:
                        self._migrate_group(src, dst, slot_list)
                        break
                    except Exception as e:  # noqa: BLE001 — retried
                        if time.monotonic() > deadline:
                            self._log("reshard_gave_up", -1, repr(e))
                            raise
                        self._log("migration_retry", src, repr(e))
                        time.sleep(0.2)
            if target < start_n:
                final = svc.routing.resized(target, endpoints=[
                    sh.endpoint for sh in svc.shards[:target]])
                # surviving servers first (stale in-flight RPCs to them
                # start refreshing), then one atomic client flip that
                # also pops + closes the tail stubs, then the retired
                # processes go away
                meta = final.to_meta()
                for i in range(target):
                    try:
                        self._call_up(i, "install_route", meta)
                    except Exception as e:  # noqa: BLE001
                        self._log("install_route_failed", i, repr(e))
                with self._ckpt_lock:
                    retiring = [(i, self._inner(i), svc.shards[i].endpoint)
                                for i in range(target, start_n)]
                    svc.install_routing(final)
                    for i, _inner, ep in reversed(retiring):
                        self._st.pop(i)
                        self._log("shard_retired", i, ep)
                    for _i, inner, _ep in retiring:
                        try:
                            inner.shutdown_server()
                        except Exception:  # noqa: BLE001 — best effort
                            pass
                        inner.close()
            dt = time.monotonic() - t0
            self._log("reshard_complete", -1,
                      f"{start_n}->{target} epoch={svc.routing.epoch} "
                      f"dt={dt:.3f}s")
            return svc.routing

    def autoscale_check(self, hot_rows_per_shard=None, max_shards=8):
        """Load-triggered scale-up: called on the trainer's cadence (e.g.
        each checkpoint interval).  If the mean pushed-row count per
        shard since the last check exceeds the threshold (flag
        sparse_autoscale_hot_rows; 0 disables), double the shard count
        via the spawn hook.  Returns the new RoutingTable or None."""
        from .. import flags

        if hot_rows_per_shard is None:
            hot_rows_per_shard = int(flags.get("sparse_autoscale_hot_rows"))
        if hot_rows_per_shard <= 0 or self.spawn is None:
            return None
        loads = []
        for st in list(self._st):
            with st.cond:
                loads.append(st.pushed_rows)
                st.pushed_rows = 0
        if not loads or sum(loads) / len(loads) <= hot_rows_per_shard:
            return None
        target = min(int(max_shards), self.service.num_shards * 2)
        if target <= self.service.num_shards:
            return None
        self._log("autoscale_triggered", -1,
                  f"mean load {sum(loads) / len(loads):.0f} rows > "
                  f"{hot_rows_per_shard}")
        return self.reshard(target)

    # ------------------------------------------------------------------
    # checkpointing (manifest-last commit; the only journal truncation)
    # ------------------------------------------------------------------
    def _scan_committed(self):
        from ..checkpoint.manifest import verify_checkpoint_dir

        dirs = []
        for name in sorted(os.listdir(self.checkpoint_root)):
            path = os.path.join(self.checkpoint_root, name)
            if not (name.startswith("shards_") and os.path.isdir(path)):
                continue
            ok, _problems = verify_checkpoint_dir(path, deep=False)
            if ok:
                dirs.append(path)
        return dirs

    def newest_committed(self):
        """Newest committed (manifest-verified) shard checkpoint dir, or
        None — what recovery restores from."""
        with self._ckpt_lock:
            return self._committed[-1] if self._committed else None

    def checkpoint(self, dirname=None, step=None):
        """Snapshot every shard + commit (manifest written last), then
        truncate each journal's covered prefix.  Per-shard exactness:
        shard i's npz plus its journal tail reproduces shard i precisely;
        the cut is NOT synchronized across shards (it doesn't need to be
        — recovery is per shard).  Raises without committing if any shard
        save fails, leaving journals intact."""
        import json

        from ..checkpoint.manifest import write_manifest

        with self._ckpt_lock:
            if dirname is None:
                if not self.checkpoint_root:
                    raise ValueError(
                        "checkpoint() needs a dirname or checkpoint_root")
                seq = self._ckpt_seq if step is None else int(step)
                dirname = os.path.join(self.checkpoint_root,
                                       f"shards_{seq:010d}")
                self._ckpt_seq = seq + 1
            os.makedirs(dirname, exist_ok=True)
            # topology mutations (reshard add/retire) also hold
            # _ckpt_lock, so this snapshot of the shard list is stable
            # for the whole commit
            states = list(self._st)
            marks = {}
            for st in states:
                with st.cond:
                    self._wait_up_locked(st)
                    self._inner(st.index).save(dirname)
                    marks[st.index] = len(st.journal)
            meta = {"height": self.service.height,
                    "dim": self.service.dim,
                    "num_shards": self.service.num_shards}
            routing = getattr(self.service, "routing", None)
            if routing is not None:
                meta["routing"] = routing.to_meta()
            with open(os.path.join(dirname, "meta.json"), "w") as f:
                json.dump(meta, f)
            write_manifest(dirname, extra={"kind": "sparse_shards"})
            # committed: truncation may now forget what the npz holds
            for st in states:
                with st.cond:
                    del st.journal[:marks[st.index]]
            self._committed.append(dirname)
            self._log("checkpoint_committed", -1, dirname)
            while (self.keep_checkpoints > 0
                   and len(self._committed) > self.keep_checkpoints):
                old = self._committed.pop(0)
                shutil.rmtree(old, ignore_errors=True)
        return dirname
