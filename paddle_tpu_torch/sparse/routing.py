"""Versioned shard membership: the epoch-stamped slot -> owner map
(counterpart of paddle_tpu/sparse/routing.py; numpy only, every method as
the JAX file has it, so that a table and a hash agree across packages).

The reference stack scaled its Go pserver fleet through etcd-coordinated
membership (PAPER.md §11): clients re-resolved the shard set instead of
baking `id % num_shards` into every call site.  A ``RoutingTable`` — an
epoch-stamped slot→owner map — is that membership object.  In the port
its user is the serving fleet: `fleet.FleetRouter` hashes a prompt's
prefix key onto a slot and routes to the slot's replica, and an ejected
replica's slots are dealt round-robin across the survivors
(``redistributed``).

Placement is hash-slot based (the Redis-cluster / range-split idiom):

    slot(id)  = id % num_slots          (num_slots fixed for the table's
                                         lifetime, default 840)
    owner(id) = slots[slot(id)]         (mutable, epoch-stamped)

840 = lcm(1..8), so the canonical table for N owners (``slots[s] = s %
N``) places every id exactly where the historical ``id % N`` modulo rule
did for any N ≤ 8, while resharding becomes "move these slots" instead
of "rehash the world".

Epochs make staleness detectable: a peer serving a different epoch can
tell, and a stale client refreshes its table instead of silently reading
the wrong owner.  ``endpoints`` (optional) rides along so a client that
learns of a newer topology also learns where the owners live.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["RoutingTable", "DEFAULT_NUM_SLOTS"]

# lcm(1..8): the canonical N-shard table reproduces id % N placement for
# every historical shard count, so epoch-0 tables are drop-in
DEFAULT_NUM_SLOTS = 840


def _default_num_slots():
    from .. import flags

    try:
        return int(flags.get("sparse_route_slots"))
    except KeyError:  # flags registry not loaded (standalone tools)
        return DEFAULT_NUM_SLOTS


class RoutingTable:
    """Immutable epoch-stamped slot→shard map.  Mutation returns a NEW
    table with ``epoch + 1`` — an installed epoch never changes meaning,
    which is what makes the wire check sound."""

    __slots__ = ("epoch", "num_slots", "num_shards", "slots", "endpoints")

    def __init__(self, slots, num_shards, epoch=0, endpoints=None):
        self.slots = np.ascontiguousarray(slots, dtype=np.int32)
        self.num_slots = int(len(self.slots))
        self.num_shards = int(num_shards)
        self.epoch = int(epoch)
        self.endpoints = list(endpoints) if endpoints is not None else None
        if self.num_slots <= 0:
            raise ValueError("routing table needs at least one slot")
        if self.slots.size and (self.slots.min() < 0
                                or self.slots.max() >= self.num_shards):
            raise ValueError(
                f"slot owners out of range [0, {self.num_shards}): "
                f"min={self.slots.min()} max={self.slots.max()}")

    # -- construction ------------------------------------------------------
    @classmethod
    def modulo(cls, num_shards, num_slots=None, epoch=0, endpoints=None):
        """The canonical N-shard table: slot s -> s % N.  With the
        default 840 slots this reproduces ``id % N`` placement exactly
        for every N dividing 840 (all of 1..8)."""
        n = _default_num_slots() if num_slots is None else int(num_slots)
        slots = np.arange(n, dtype=np.int64) % int(num_shards)
        return cls(slots, num_shards, epoch=epoch, endpoints=endpoints)

    @classmethod
    def from_meta(cls, meta):
        if meta is None:
            raise ValueError("no routing meta")
        return cls(np.asarray(meta["slots"], dtype=np.int32),
                   meta["num_shards"], epoch=meta.get("epoch", 0),
                   endpoints=meta.get("endpoints"))

    def to_meta(self):
        meta = {"epoch": self.epoch, "num_slots": self.num_slots,
                "num_shards": self.num_shards,
                "slots": self.slots.tolist()}
        if self.endpoints is not None:
            meta["endpoints"] = list(self.endpoints)
        return meta

    def to_json(self):
        return json.dumps(self.to_meta())

    @classmethod
    def from_json(cls, text):
        return cls.from_meta(json.loads(text))

    # -- placement ---------------------------------------------------------
    def slot_of(self, ids):
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        return ids % self.num_slots

    def owner_of(self, ids):
        """Vectorized id -> owning shard index."""
        return self.slots[self.slot_of(ids)]

    def shard_masks(self, ids):
        """[(shard, bool mask)] for every shard that owns ≥1 of ids —
        the fan-out shape ShardRouter dispatches on."""
        owners = self.owner_of(ids)
        return [(s, owners == s) for s in np.unique(owners)]

    def slots_of_shard(self, shard):
        return np.flatnonzero(self.slots == int(shard))

    def same_placement(self, other):
        return (self.num_slots == other.num_slots
                and self.num_shards == other.num_shards
                and bool(np.array_equal(self.slots, other.slots)))

    # -- mutation (epoch-bumping) -----------------------------------------
    def moved(self, slot_list, dst, num_shards=None, endpoints=None):
        """New table (epoch+1) with ``slot_list`` reassigned to ``dst``.
        ``num_shards`` grows/shrinks the declared shard count (shrink
        requires the retired tail shards to own nothing afterwards)."""
        slots = self.slots.copy()
        slots[np.asarray(slot_list, dtype=np.int64)] = int(dst)
        n = self.num_shards if num_shards is None else int(num_shards)
        if endpoints is None:
            endpoints = self.endpoints
        return RoutingTable(slots, n, epoch=self.epoch + 1,
                            endpoints=endpoints)

    def resized(self, num_shards, endpoints=None):
        """New table (epoch+1) with the declared shard count changed but
        placement untouched — how scale-up announces new (still empty)
        shards before any slot moves, and scale-down retires shards that
        no longer own slots."""
        slots = self.slots
        if slots.size and slots.max() >= int(num_shards):
            raise ValueError(
                f"cannot shrink to {num_shards} shards: slots still "
                f"owned by shard {int(slots.max())}")
        return RoutingTable(slots, num_shards, epoch=self.epoch + 1,
                            endpoints=self.endpoints
                            if endpoints is None else endpoints)

    def plan_moves(self, target_num_shards):
        """{(src, dst): [slots]} migrating this table onto the CANONICAL
        ``modulo(target_num_shards)`` layout.  Canonical targets keep
        every reshard's end state equal to a fresh service of that size
        (placement-wise), so oracles and checkpoints stay comparable;
        the cost over minimal-movement hashing is bounded (≤ half the
        slots for 2x scale steps)."""
        target = RoutingTable.modulo(int(target_num_shards),
                                     num_slots=self.num_slots)
        plan = {}
        for slot in range(self.num_slots):
            src = int(self.slots[slot])
            dst = int(target.slots[slot])
            if src != dst:
                plan.setdefault((src, dst), []).append(slot)
        return plan

    def redistributed(self, dead, survivors=None, endpoints=None):
        """New table (epoch+1) with every slot owned by ``dead`` dealt
        round-robin (in slot order — deterministic, so every observer
        derives the same table) across ``survivors`` (default: every
        other shard).  The fleet tier's ejection primitive: a dead
        serving replica's traffic spreads evenly over the rest instead
        of piling onto one neighbour."""
        dead = int(dead)
        if survivors is None:
            survivors = [s for s in range(self.num_shards) if s != dead]
        survivors = [int(s) for s in survivors if int(s) != dead]
        if not survivors:
            raise ValueError("redistributed() needs >= 1 survivor")
        slots = self.slots.copy()
        for i, slot in enumerate(np.flatnonzero(slots == dead)):
            slots[slot] = survivors[i % len(survivors)]
        return RoutingTable(slots, self.num_shards, epoch=self.epoch + 1,
                            endpoints=self.endpoints
                            if endpoints is None else endpoints)

    def rebalanced(self, target_num_shards, endpoints=None):
        """The table plan_moves drives toward: canonical placement for
        ``target_num_shards``, epoch bumped past this one."""
        target = RoutingTable.modulo(
            int(target_num_shards), num_slots=self.num_slots,
            epoch=self.epoch + 1,
            endpoints=self.endpoints if endpoints is None else endpoints)
        return target

    def __repr__(self):
        return (f"RoutingTable(epoch={self.epoch}, "
                f"num_shards={self.num_shards}, "
                f"num_slots={self.num_slots})")
