"""Host-side sharded embedding service — the pserver role for sparse tables
(counterpart of paddle_tpu/sparse/embedding_service.py, the same numpy
code: virgin rows, optimizer updates and the saved layout are the JAX
package's bit for bit, so either package loads the other's service
directory).  The tables live in host memory by design: they are the ones
too large for the device, and the device only ever sees the rows a batch
prefetches.

reference design being kept (SURVEY §2.11 + transpiler :1033-1276):
- rows sharded by `id % num_shards` across shards (pserver block sharding)
- trainer-side PREFETCH: gather only the rows a batch needs, stage to HBM
- gradients travel sparse (SelectedRows) and are applied host-side with the
  optimizer owned by the shard (Go pserver ran optimizers via cgo,
  go/pserver/optimizer.go:17)
- barrier-free async updates (reference async mode), or sync via the
  caller's step boundary
- checkpoint to disk per shard with meta (go/pserver/service.go:120-227)

Storage is fully vectorized: each shard keeps a sorted id array + row/
accumulator matrices, served by np.searchsorted gathers and in-place
scatter updates — no per-id Python loops anywhere (a CTR batch touches
10^4-10^5 ids).  Row initialization is a deterministic splitmix64-style
hash of (id, column), so any shard — in-process or a remote process started
later — materializes identical virgin rows.

Shards are in-process objects here; transport.py puts a TCP process
boundary in front of the same API for multi-host deployments.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from .routing import RoutingTable
from .selected_rows import SelectedRows


def hash_init_rows(ids, dim, seed=0, scale=0.01):
    """Deterministic vectorized init: uniform[-scale, scale) from a
    splitmix64 hash of (id, column, seed).  The multiplies wrap mod 2^64
    on purpose (numpy warns "overflow encountered" on scalar operands)."""
    ids = np.asarray(ids, dtype=np.uint64).reshape(-1, 1)
    cols = np.arange(dim, dtype=np.uint64).reshape(1, -1)
    x = ids * np.uint64(0x9E3779B97F4A7C15)
    x = x + cols + np.uint64(seed) * np.uint64(0xD1B54A32D192ED03)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    u = (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)  # [0, 1)
    return ((u * 2.0 - 1.0) * scale).astype(np.float32)


class Shard:
    """One pserver-equivalent shard: the rows its RoutingTable slots (or,
    historically, id % num_shards == index) assign to it.  Sorted-array
    storage; every operation is a vectorized gather/scatter.  The shard
    does not enforce placement — the router owns that — so slot migration
    can stage rows here before the epoch that routes traffic to them."""

    def __init__(self, index, num_shards, dim, optimizer="adagrad",
                 learning_rate=0.01, seed=0, init_scale=0.01, epoch=0):
        self.index = index
        self.num_shards = num_shards
        self.dim = dim
        self._ids = np.empty((0,), dtype=np.int64)  # sorted
        self._rows = np.zeros((0, dim), dtype=np.float32)
        self._accum = np.zeros((0,), dtype=np.float32)
        self._opt = optimizer
        self._lr = float(learning_rate)
        self._seed = seed
        self._scale = init_scale
        self._lock = threading.Lock()
        # routing epoch this shard serves (wire checks compare against
        # it) + the full installed table, handed to stale clients so
        # they can refresh without a second authority
        self.epoch = int(epoch)
        self.route_meta = None
        self.route_table = None
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError(f"unknown optimizer {optimizer}")

    # internal: ids must be unique + sorted; returns their positions
    def _ensure(self, uids):
        pos = np.searchsorted(self._ids, uids)
        if len(self._ids):
            safe = np.minimum(pos, len(self._ids) - 1)
            found = self._ids[safe] == uids
        else:
            found = np.zeros(len(uids), dtype=bool)
        new = uids[~found]
        if new.size:
            init = hash_init_rows(new, self.dim, self._seed, self._scale)
            merged_ids = np.concatenate([self._ids, new])
            order = np.argsort(merged_ids, kind="stable")
            self._ids = merged_ids[order]
            self._rows = np.concatenate([self._rows, init])[order]
            self._accum = np.concatenate(
                [self._accum, np.zeros(new.size, np.float32)]
            )[order]
            pos = np.searchsorted(self._ids, uids)
        return pos

    def lookup(self, ids):
        """Gather rows for (possibly duplicated) ids -> [len(ids), dim]."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        with self._lock:
            uids, inv = np.unique(ids, return_inverse=True)
            idx = self._ensure(uids)
            return self._rows[idx][inv]

    def push(self, ids, grads):
        """Scatter-apply a sparse gradient (duplicate ids are pre-merged)."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        grads = np.asarray(grads, dtype=np.float32).reshape(len(ids), self.dim)
        with self._lock:
            uids, inv = np.unique(ids, return_inverse=True)
            g = np.zeros((len(uids), self.dim), dtype=np.float32)
            np.add.at(g, inv, grads)
            idx = self._ensure(uids)
            if self._opt == "sgd":
                self._rows[idx] -= self._lr * g
            else:  # adagrad (go/pserver/optimizer.go parity)
                self._accum[idx] += np.einsum("nd,nd->n", g, g)
                denom = np.sqrt(self._accum[idx]) + 1e-6
                self._rows[idx] -= self._lr * g / denom[:, None]

    def state(self):
        with self._lock:
            return self._ids.copy(), self._rows.copy()

    def snapshot(self):
        """Consistent in-memory copy of the shard's durable state (taken
        under the lock) — the unit a background checkpoint writer
        serializes after the caller thread has moved on."""
        with self._lock:
            return {"ids": self._ids.copy(), "vals": self._rows.copy(),
                    "accum": self._accum.copy()}

    # -- routing / migration primitives --------------------------------
    def install_route(self, meta):
        """Adopt a routing table (epoch + slot map).  Called at cutover
        (and on recovery) so wire-level epoch checks and stale-client
        refreshes have a per-shard source of truth."""
        table = RoutingTable.from_meta(meta)
        with self._lock:
            self.route_meta = dict(meta)
            self.route_table = table
            self.epoch = int(meta["epoch"])

    def owns(self, ids):
        """Per-id ownership against the installed table (all-True when no
        table is installed — pre-elastic deployments route client-side
        only).  The wire layer refuses epoch-stamped data ops for ids the
        table assigns elsewhere: even a client whose epoch matches but
        whose routing decision predates a cutover can never silently
        read or update rows this shard no longer owns."""
        table = self.route_table
        if table is None:
            return np.ones(len(np.asarray(ids).reshape(-1)), dtype=bool)
        return table.owner_of(ids) == self.index

    def export_slots(self, slot_list, num_slots):
        """Consistent copy of every resident row whose slot (id %
        num_slots) is in ``slot_list`` — the snapshot half of a slot
        migration, taken under the shard lock so no push interleaves."""
        slot_list = np.asarray(slot_list, dtype=np.int64).reshape(-1)
        with self._lock:
            mask = np.isin(self._ids % int(num_slots), slot_list)
            return {"ids": self._ids[mask].copy(),
                    "vals": self._rows[mask].copy(),
                    "accum": self._accum[mask].copy()}

    def import_rows(self, ids, vals, accum=None):
        """Bulk-adopt migrated rows (values + adagrad accumulators),
        REPLACING any resident duplicates — re-importing after a failed
        attempt converges instead of double-counting."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        vals = np.asarray(vals, dtype=np.float32).reshape(len(ids), self.dim)
        accum = (np.zeros(len(ids), np.float32) if accum is None
                 else np.asarray(accum, dtype=np.float32).reshape(-1))
        if not len(ids):
            return
        with self._lock:
            keep = ~np.isin(self._ids, ids)
            merged_ids = np.concatenate([self._ids[keep], ids])
            order = np.argsort(merged_ids, kind="stable")
            self._ids = merged_ids[order]
            self._rows = np.concatenate([self._rows[keep], vals])[order]
            self._accum = np.concatenate([self._accum[keep], accum])[order]

    def drop_slots(self, slot_list, num_slots):
        """Forget rows for slots this shard no longer owns (post-cutover
        cleanup on the migration source)."""
        slot_list = np.asarray(slot_list, dtype=np.int64).reshape(-1)
        with self._lock:
            keep = ~np.isin(self._ids % int(num_slots), slot_list)
            self._ids = self._ids[keep]
            self._rows = self._rows[keep]
            self._accum = self._accum[keep]

    def save(self, dirname):
        os.makedirs(dirname, exist_ok=True)
        snap = self.snapshot()
        np.savez(os.path.join(dirname, f"shard_{self.index}.npz"), **snap)

    def load(self, dirname):
        data = np.load(os.path.join(dirname, f"shard_{self.index}.npz"))
        with self._lock:
            order = np.argsort(data["ids"], kind="stable")
            self._ids = data["ids"][order].astype(np.int64)
            self._rows = data["vals"][order].astype(np.float32)
            if "accum" in data:
                # restore the adagrad accumulator so a recovered pserver
                # keeps its per-id effective LR (instead of re-applying
                # near-full-rate updates to hot ids after restart)
                self._accum = data["accum"][order].astype(np.float32)
            else:  # pre-round-3 checkpoints lack the key
                self._accum = np.zeros(len(self._ids), np.float32)


class ShardRouter:
    """Routing-table shard dispatch shared by the in-process service and
    the TCP client (transport.RemoteEmbeddingService) — one place owns
    the id -> shard placement rule, so local and remote never desync.

    Placement comes from ``self.routing`` (a routing.RoutingTable): an
    epoch-stamped slot→shard map whose canonical form reproduces the
    historical ``id % num_shards`` rule, but which can be swapped live
    (epoch bump) to add/remove shards while trainers run.

    Subclasses provide self.shards (objects with lookup/push/save) plus
    self.routing/self.num_shards/self.dim, and may override _map_shards
    to dispatch the per-shard calls concurrently (the remote client
    does; the reference's async gRPC client contract, grpc_client.h:175)."""

    def _map_shards(self, calls):
        """calls: [(shard_idx, method_name, args)] -> [result per call]."""
        return [
            getattr(self.shards[s], meth)(*args) for s, meth, args in calls
        ]

    def prefetch(self, ids):
        """Gather rows for a batch of (possibly duplicated) ids ->
        np [len(ids), dim].  reference RequestPrefetch (grpc_server.cc:157)."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        out = np.empty((len(ids), self.dim), dtype=np.float32)
        masks = self.routing.shard_masks(ids)
        calls = [(int(s), "lookup", (ids[m],)) for s, m in masks]
        results = self._map_shards(calls)
        for (_s, m), rows in zip(masks, results):
            out[m] = rows
        return out

    def push_sparse_grad(self, grad: SelectedRows):
        """Apply a SelectedRows gradient (merged first, as the pserver's
        grad-merge block did, transpiler :1468)."""
        merged = SelectedRows.merge([grad])
        ids = merged.rows
        vals = np.asarray(merged.value)
        calls = [
            (int(s), "push", (ids[m], vals[m]))
            for s, m in self.routing.shard_masks(ids)
        ]
        self._map_shards(calls)


class EmbeddingService(ShardRouter):
    """num_shards host shards of a [height, dim] embedding table, with
    live topology change: ``reshard(n)`` migrates slot ownership to the
    canonical n-shard layout without losing a row or an accumulator."""

    def __init__(self, height, dim, num_shards=1, optimizer="adagrad",
                 learning_rate=0.01, seed=0, init_scale=0.01, routing=None):
        self.height = height
        self.dim = dim
        self.num_shards = num_shards
        self._opt = optimizer
        self._lr = learning_rate
        self._seed = seed
        self._scale = init_scale
        self.routing = (RoutingTable.modulo(num_shards)
                        if routing is None else routing)
        assert self.routing.num_shards == num_shards
        self.shards = [self._new_shard(i) for i in range(num_shards)]
        for s in self.shards:
            s.install_route(self.routing.to_meta())

    def _new_shard(self, index):
        return Shard(index, self.num_shards, self.dim, optimizer=self._opt,
                     learning_rate=self._lr, seed=self._seed,
                     init_scale=self._scale, epoch=self.routing.epoch)

    # -- live topology change (in-process migration) ----------------------
    def install_routing(self, table):
        """Adopt a newer routing table and mirror it into every shard
        (the in-process cutover; remote cutover is driven by
        ShardSupervisor over OP_INSTALL)."""
        self.routing = table
        self.num_shards = table.num_shards
        meta = table.to_meta()
        for s in self.shards:
            s.num_shards = table.num_shards
            s.install_route(meta)

    def reshard(self, target_num_shards):
        """Migrate to the canonical ``target_num_shards`` layout: move
        each reassigned slot's rows (values AND adagrad accumulators)
        wholesale between shards, then bump the epoch.  Bitwise-exact:
        rows are moved, never recomputed, so lookups after reshard equal
        a never-resharded service's.  Returns the new RoutingTable."""
        target = int(target_num_shards)
        if target < 1:
            raise ValueError("need at least one shard")
        if target == self.num_shards:
            return self.routing
        plan = self.routing.plan_moves(target)
        num_slots = self.routing.num_slots
        for i in range(self.num_shards, target):  # grow first
            self.shards.append(self._new_shard(i))
        for (src, dst), slot_list in sorted(plan.items()):
            blob = self.shards[src].export_slots(slot_list, num_slots)
            self.shards[dst].import_rows(**blob)
            self.shards[src].drop_slots(slot_list, num_slots)
        del self.shards[target:]  # shrink after the moves
        self.install_routing(self.routing.rebalanced(target))
        return self.routing

    # -- checkpoint (go/pserver/service.go:120-227 design) ----------------
    def state_dict(self):
        """In-memory snapshot of the full service (meta + every shard's
        ids/rows/accumulators), each shard copied under its own lock.
        write_state(dirname, state_dict()) produces exactly the save()
        on-disk layout — the split lets CheckpointManager snapshot on the
        caller thread and serialize on its background writer."""
        return {
            "meta": {"height": self.height, "dim": self.dim,
                     "num_shards": self.num_shards,
                     "routing": self.routing.to_meta()},
            "shards": {s.index: s.snapshot() for s in self.shards},
        }

    @staticmethod
    def write_state(dirname, state):
        """Serialize a state_dict() snapshot into the save() layout:
        meta.json + shard_<index>.npz (ids/vals/accum keys)."""
        os.makedirs(dirname, exist_ok=True)
        with open(os.path.join(dirname, "meta.json"), "w") as f:
            json.dump(state["meta"], f)
        for index, snap in state["shards"].items():
            np.savez(os.path.join(dirname, f"shard_{index}.npz"), **snap)

    def save(self, dirname):
        self.write_state(dirname, self.state_dict())

    def load(self, dirname):
        """Restore from a save()/write_state() directory.  Elastic: a
        checkpoint taken at a different shard count (e.g. mid-training
        reshard happened since) rebuilds the shard list and adopts the
        checkpoint's routing table instead of failing."""
        with open(os.path.join(dirname, "meta.json")) as f:
            meta = json.load(f)
        assert meta["dim"] == self.dim
        n = int(meta["num_shards"])
        routing = (RoutingTable.from_meta(meta["routing"])
                   if meta.get("routing") else RoutingTable.modulo(n))
        if n != self.num_shards:
            self.num_shards = n
            self.routing = routing
            self.shards = [self._new_shard(i) for i in range(n)]
        self.install_routing(routing)
        for s in self.shards:
            s.load(dirname)
