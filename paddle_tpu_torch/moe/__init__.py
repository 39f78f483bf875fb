"""Mixture-of-experts tier: gating telemetry, load signals, placement
(counterpart of paddle_tpu/moe/__init__.py).

The ops are ops/moe_ops.py's (`top_k_gating`, `moe_expert_ffn`), the
builders layers/nn.py's (`top_k_gating`, `moe_ffn`).  This package holds
what neither builds nor lowers:

  ExpertPlacement   the epoch-stamped expert -> shard map over the sparse
                    tier's RoutingTable (placement.py), checkpointed as
                    `moe_topology` beside `sparse_topology`.
  MoeLoadMonitor    capacity-overflow accounting in the overload-control
                    idiom: each step's observation feeds an EWMA drop
                    rate and a load-imbalance gauge; `load_signal()`
                    answers ok / pressured / overloaded.
  program scanners  collect_aux_losses / gating_fetches /
                    placements_for_program find the MoE structure of a
                    built Program (models fold the aux losses into the
                    objective; serving fetches Load/Dropped a step).

Telemetry: `moe.tokens_dropped` (counter) and `moe.expert_load` (gauge:
the max over layers of max/mean load; 1.0 is balanced) are registered at
import, so a scrape finds them before the first drop.  Fetched outputs
may be card tensors: the monitor reads them back to the host.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops.moe_ops import expert_capacity
from ..telemetry import registry as _telem
from .placement import ExpertPlacement

__all__ = ["ExpertPlacement", "MoeLoadMonitor", "MOE_LOAD_LEVELS",
           "expert_capacity", "collect_aux_losses", "scaled_aux_loss",
           "gating_fetches", "placements_for_program", "step_monitor"]

_C_DROPPED = _telem.counter("moe.tokens_dropped")
_G_LOAD = _telem.gauge("moe.expert_load")

MOE_LOAD_LEVELS = ("ok", "pressured", "overloaded")

# EWMA smoothing matching the overload control plane's estimators
_EWMA_ALPHA = 0.1

# suffix contract with layers.moe_ffn's parameter naming
_W1_SUFFIX = "_moe_w1"
_EXPERT_PARAM_SUFFIXES = ("_moe_w1", "_moe_b1", "_moe_w2", "_moe_b2")


def _host(v):
    """A fetched output as a float64 numpy array (a card or bfloat16
    tensor included)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device="cpu", dtype=torch.float64).numpy()
    return np.asarray(v, dtype=np.float64)


class MoeLoadMonitor:
    """Capacity-overflow accounting for one serving/training loop.

    `observe(loads, dropped)` once per step with the fetched per-layer
    Load vectors and the summed Dropped count; `load_signal()` reads
    back an overload-style state for capacity pricing (the scheduler's
    admission plane can treat "overloaded" like queue pressure).
    Thresholds are on the EWMA drop RATE (dropped / routed assignments),
    not absolute counts, so batch size doesn't skew the signal."""

    def __init__(self, pressured_drop=0.05, overloaded_drop=0.20):
        self.pressured_drop = float(pressured_drop)
        self.overloaded_drop = float(overloaded_drop)
        self._lock = threading.Lock()
        self._drop_rate = None   # EWMA of per-step drop fraction
        self.imbalance = 1.0     # last max-over-layers max/mean load
        self.total_dropped = 0
        self.total_assigned = 0
        self.steps = 0

    def observe(self, loads, dropped):
        dropped = float(dropped)
        loads = [_host(l).reshape(-1) for l in loads]
        kept = float(sum(float(l.sum()) for l in loads))
        assigned = kept + dropped
        rate = (dropped / assigned) if assigned > 0 else 0.0
        imb = 1.0
        for l in loads:
            mean = l.mean() if l.size else 0.0
            if mean > 0:
                imb = max(imb, float(l.max() / mean))
        with self._lock:
            self._drop_rate = rate if self._drop_rate is None else \
                (1 - _EWMA_ALPHA) * self._drop_rate + _EWMA_ALPHA * rate
            self.imbalance = imb
            self.total_dropped += int(round(dropped))
            self.total_assigned += int(round(assigned))
            self.steps += 1
        _C_DROPPED.inc(int(round(dropped)))
        _G_LOAD.set(imb)

    def drop_rate(self):
        with self._lock:
            return 0.0 if self._drop_rate is None else self._drop_rate

    def load_signal(self):
        """Overload-style pressure answer: {"state", "drop_rate",
        "imbalance", "total_dropped", "total_assigned"}."""
        rate = self.drop_rate()
        if rate >= self.overloaded_drop:
            state = "overloaded"
        elif rate >= self.pressured_drop:
            state = "pressured"
        else:
            state = "ok"
        with self._lock:
            return {"state": state, "drop_rate": rate,
                    "imbalance": self.imbalance,
                    "total_dropped": self.total_dropped,
                    "total_assigned": self.total_assigned}


# ---------------------------------------------------------------------------
# Program scanners
# ---------------------------------------------------------------------------


def _iter_ops(program, op_type):
    for block in program.blocks:
        for op in block.ops:
            if op.type == op_type:
                yield block, op


def collect_aux_losses(program=None):
    """The AuxLoss [1] Variables of every top_k_gating op in `program`
    (default main program) — the model folds their (scaled) sum into the
    objective or the router collapses onto one expert."""
    if program is None:
        from ..framework.framework import default_main_program

        program = default_main_program()
    out = []
    for block, op in _iter_ops(program, "top_k_gating"):
        out.append(block._var_recursive(op.outputs["AuxLoss"][0]))
    return out


def scaled_aux_loss(weight, program=None):
    """`weight` x the sum of collect_aux_losses(program), appended to the
    program being built as the JAX models append it (an elementwise_add
    chain, then one scale); None without a gating op or at weight 0."""
    aux_list = collect_aux_losses(program) if weight else []
    if not aux_list:
        return None
    from .. import layers

    total = aux_list[0]
    for a in aux_list[1:]:
        total = layers.elementwise_add(x=total, y=a)
    return layers.scale(total, scale=float(weight))


def gating_fetches(program):
    """(load_names, dropped_names) of every top_k_gating op — what a
    serving step fetches to feed `step_monitor`."""
    loads, dropped = [], []
    for _block, op in _iter_ops(program, "top_k_gating"):
        loads.append(op.outputs["Load"][0])
        dropped.append(op.outputs["Dropped"][0])
    return loads, dropped


def placements_for_program(program, num_shards):
    """{layer_name: ExpertPlacement} for every moe_expert_ffn in
    `program`, num_experts read off the W1 [E, d, f] shape and
    param_names filled for the fsck cross-check; each is the canonical
    modulo placement at epoch 0 (expert e on shard e % num_shards)."""
    placements = {}
    for block, op in _iter_ops(program, "moe_expert_ffn"):
        w1_name = op.inputs["W1"][0]
        name = w1_name[:-len(_W1_SUFFIX)] if w1_name.endswith(_W1_SUFFIX) \
            else w1_name
        if name in placements:
            continue
        w1 = block._var_recursive(w1_name)
        param_names = [op.inputs[p][0] for p in ("W1", "B1", "W2", "B2")]
        placements[name] = ExpertPlacement(
            int(w1.shape[0]), num_shards, param_names=param_names)
    return placements


def step_monitor(load_names, dropped_names, monitor=None):
    """(monitor, notify) pair for a GenerationSpec: `notify(outs)`
    consumes one step's fetched outputs dict and feeds the monitor.
    Missing names are skipped, so the same callable serves programs that
    were rewritten (paged-KV) as long as the gating outputs survive.
    `notify.monitor` points back at the MoeLoadMonitor so code holding
    only the callable (GenerationSpec.monitor) can read load_signal()."""
    mon = monitor if monitor is not None else MoeLoadMonitor()

    def notify(outs):
        loads = [_host(outs[n]) for n in load_names if n in outs]
        drop = sum(float(_host(outs[n]).sum())
                   for n in dropped_names if n in outs)
        if loads or drop:
            mon.observe(loads, drop)

    notify.monitor = mon
    return mon, notify
