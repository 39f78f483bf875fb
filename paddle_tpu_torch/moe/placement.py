"""Expert -> shard placement: the sparse tier's RoutingTable with one slot
an expert (counterpart of paddle_tpu/moe/placement.py; the same tables,
epochs and checkpoint meta, so either package adopts the other's).

A placement that can change under a live trainer is the sparse tier's
problem with a tiny id space: num_slots == num_experts, slot s is expert
s, and a rebalance is a reshard with an epoch bump, stamped into a
checkpoint as `moe_topology` beside `sparse_topology`
(checkpoint/manager.py).  The default is the canonical modulo table
(expert e on shard e % num_shards), where splitting the expert-major
[E, ...] params over a mesh axis puts the rows at epoch 0.
"""

from __future__ import annotations

import numpy as np

from ..sparse.routing import RoutingTable

__all__ = ["ExpertPlacement"]


class ExpertPlacement:
    """Mutable holder of an immutable epoch-stamped expert→shard table.

    The holder mutates (rebalance installs a successor table in place,
    restore swaps the checkpointed one back in) so long-lived owners —
    a Scheduler, a CheckpointManager caller — see updates without
    re-plumbing; each installed table itself never changes meaning,
    which is what keeps epochs honest."""

    def __init__(self, num_experts, num_shards, table=None,
                 param_names=None):
        self.num_experts = int(num_experts)
        self.num_shards = int(num_shards)
        if table is None:
            table = RoutingTable.modulo(self.num_shards,
                                        num_slots=self.num_experts)
        if table.num_slots != self.num_experts:
            raise ValueError(
                f"placement table has {table.num_slots} slots, expected "
                f"one per expert ({self.num_experts})")
        if table.num_shards != self.num_shards:
            raise ValueError(
                f"placement table spans {table.num_shards} shards, "
                f"expected {self.num_shards}")
        self.table = table
        # the expert-major params this placement governs (leading dim E);
        # ckpt_fsck cross-checks their on-disk leading dim against it
        self.param_names = list(param_names) if param_names else []

    @property
    def epoch(self):
        return self.table.epoch

    # -- placement ---------------------------------------------------------
    def owner_of(self, expert_ids):
        """Vectorized expert id -> owning shard index."""
        ids = np.asarray(expert_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_experts):
            raise ValueError(
                f"expert ids out of range [0, {self.num_experts})")
        return self.table.owner_of(ids)

    def experts_of_shard(self, shard):
        return self.table.slots_of_shard(shard)

    # -- rebalancing (epoch-bumping) ---------------------------------------
    def rebalance(self, loads):
        """Install a load-balanced successor table (epoch+1) and return
        the list of (expert, src_shard, dst_shard) moves.

        Greedy LPT: experts in descending observed load land on the
        currently-lightest shard, ties broken by index — deterministic,
        so every observer of the same loads derives the same table (the
        redistributed()/moved() discipline)."""
        loads = np.asarray(loads, dtype=np.float64).reshape(-1)
        if loads.shape[0] != self.num_experts:
            raise ValueError(
                f"loads has {loads.shape[0]} entries, expected "
                f"{self.num_experts}")
        order = np.argsort(-loads, kind="stable")
        shard_load = np.zeros(self.num_shards, dtype=np.float64)
        slots = np.zeros(self.num_experts, dtype=np.int32)
        for e in order:
            dst = int(np.argmin(shard_load))  # first-lightest wins ties
            slots[e] = dst
            shard_load[dst] += loads[e]
        moves = [(int(e), int(self.table.slots[e]), int(slots[e]))
                 for e in range(self.num_experts)
                 if int(self.table.slots[e]) != int(slots[e])]
        self.table = RoutingTable(slots, self.num_shards,
                                  epoch=self.table.epoch + 1,
                                  endpoints=self.table.endpoints)
        return moves

    # -- persistence (checkpoint meta, same shape as sparse services) ------
    def to_meta(self):
        return {"num_experts": self.num_experts,
                "num_shards": self.num_shards,
                "param_names": list(self.param_names),
                "routing": self.table.to_meta()}

    @classmethod
    def from_meta(cls, meta):
        if meta is None:
            raise ValueError("no expert placement meta")
        return cls(meta["num_experts"], meta["num_shards"],
                   table=RoutingTable.from_meta(meta["routing"]),
                   param_names=meta.get("param_names"))

    def load_meta(self, meta):
        """Adopt a checkpointed placement in place (restore path)."""
        other = ExpertPlacement.from_meta(meta)
        if other.num_experts != self.num_experts:
            raise ValueError(
                f"checkpoint has {other.num_experts} experts, "
                f"this placement has {self.num_experts}")
        if other.num_shards != self.num_shards:
            raise ValueError(
                f"checkpoint spans {other.num_shards} shards, "
                f"this placement has {self.num_shards}")
        self.table = other.table
        if other.param_names:
            self.param_names = other.param_names

    def __repr__(self):
        return (f"ExpertPlacement(num_experts={self.num_experts}, "
                f"num_shards={self.num_shards}, epoch={self.epoch})")
