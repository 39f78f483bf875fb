"""Executor: runs a Program on a Place.

Counterpart of paddle_tpu/framework/executor.py, with its two paths:

  - `mode="interpret"` (`_run_interpret`, :226): the block's ops run one
    after another, each through its registered lowering on the scope's
    tensors, eagerly (`run_block`).  Persistables and fetch targets go to
    the scope; every other op output lives in a per-run table only until
    its last reader has run, so a training step never holds all its
    activations and gradients at once.
  - `mode="jit"` (`_run_jit`, :265): the block is split at `no_jit` ops
    into segments whose inputs, outputs and donations come from the JAX
    package's liveness (`build_plan`, its `_build_plan` :374), and the plan
    is cached under the JAX package's key (:281-295).  On the CPU a
    segment runs its ops eagerly (there is nothing to capture).  On the
    card it is a `cuda_graph.CapturedSegment`: run eagerly the first time
    a signature is seen, captured as a CUDA graph the second time and
    replayed after, which is what `jax.jit` of a segment is to XLA
    (`_compile_segment`, :451).  A segment that holds a stateful op is
    never captured: a graph would freeze the draw of the torch.Generator
    seeded per run (only startup programs hold such ops).

The port's default is "interpret" (flags.py's `executor_mode`), where the
JAX package's is "jit": training stays on the eager replay until ROADMAP
A3 captures it.  decode.Generator and serving.Scheduler always take the
jit path, through `program_as_function`.

Feeds are staged in the declared dtype (int64 stays int64); fetches come
back as numpy arrays unless `return_numpy=False` (bfloat16 tensors as
float32 arrays, value for value: numpy has no bfloat16).  Programs run
under `torch.no_grad()`: tensors a startup creates are ordinary tensors
that the grad lowerings may replay under autograd (tensors born under
`torch.inference_mode()` could not be saved for backward).

Stateful ops (uniform_random) draw from a `torch.Generator` on the place,
seeded from Program.random_seed and the scope's run counter, so one
program run twice in one scope draws differently and a rerun in a fresh
scope draws the same.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .core_types import as_device, dtype_to_torch
from .framework import EMPTY_VAR_NAME, Program, Variable, default_main_program
from .scope import Scope, global_scope

_RNG_COUNTER_NAME = "@RNG_COUNTER@"


def _as_fetch_name(f):
    return f.name if isinstance(f, Variable) else str(f)


def _declared_dtype(program, name):
    blk = program.global_block()
    if blk.has_var(name) and blk.var(name).type == "lod_tensor":
        return dtype_to_torch(blk.var(name).dtype)
    return None


def stage_feed(value, device, program, name, captured=False):
    """Host value -> tensor on `device`, in the var's declared dtype when
    `program` declares `name` (tensors already on the device pass as-is).
    With `captured` a host value stays on the host: a captured segment
    copies it into its graph's own buffer."""
    dtype = _declared_dtype(program, name)
    if isinstance(value, torch.Tensor):
        if captured and value.device.type == "cpu":
            device = value.device
        return value.to(device=device, dtype=dtype or value.dtype)
    if captured:
        device = None
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


def _next_generator(program, scope, device):
    counter = scope.find_var(_RNG_COUNTER_NAME) or 0
    scope.set_var(_RNG_COUNTER_NAME, counter + 1)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(program.random_seed or 0) << 20) + counter)
    return gen


def _last_reads(ops):
    """var name -> index of the last op that reads it."""
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_arg_names:
            last[n] = i
    return last


def _run_op(op, read, rng, device):
    from ..ops import registry

    info = registry.get_runtime_info(op.type)
    inputs = {param: [None if n == EMPTY_VAR_NAME else read(n)
                      for n in names]
              for param, names in op.inputs.items()}
    return registry.run_forward(info, inputs, op.attrs,
                                rng=rng if info.stateful else None,
                                out_names=op.outputs, device=device)


def _outputs(op, outs):
    """(name, value) of every output the op produced."""
    for param, names in op.outputs.items():
        vals = outs.get(param, [])
        for j, n in enumerate(names):
            if n != EMPTY_VAR_NAME and j < len(vals) and vals[j] is not None:
                yield n, vals[j]


def run_block(program, scope, device, rng=None, keep=(), write=None):
    """Run block 0's ops over `scope`.  Outputs that are persistable or in
    `keep` are stored with `write(name, value)` (default: scope.set_var);
    other outputs live in a local table until their last reader has run."""
    write = write or scope.set_var
    block = program.global_block()
    ops = block.ops
    last = _last_reads(ops)
    stored = set(keep) | {n for n, v in block.vars.items() if v.persistable}
    local = {}

    def read(n):
        return local[n] if n in local else scope.find_var(n)

    for i, op in enumerate(ops):
        outs = _run_op(op, read, rng, device)
        for n in op.input_arg_names:
            if last.get(n) == i:
                local.pop(n, None)
        for n, v in _outputs(op, outs):
            if n in stored:
                local.pop(n, None)
                write(n, v)
            elif last.get(n, -1) > i:
                local[n] = v


# ---------------------------------------------------------------------------
# the jit path: plan, segments
# ---------------------------------------------------------------------------


class _Segment:
    """A maximal run of ops between `no_jit` ops (executor.py:_Segment of
    the JAX package).  `donate` holds the 1-based positions in `in_names`
    (position 0 is the rng) of the persistable inputs the segment
    overwrites: on the card their new values are copied into the input's
    storage inside the graph, so a parameter keeps its address."""

    __slots__ = ("ops", "op_indices", "in_names", "out_names", "donate",
                 "fn", "stateful")

    def __init__(self, ops, op_indices):
        self.ops = ops
        self.op_indices = op_indices
        self.in_names = []
        self.out_names = []
        self.donate = ()
        self.fn = None
        self.stateful = False


def build_plan(program, fetch_names, block_idx=0):
    """Partition the block's ops into segments and `no_jit` op indices,
    with each segment's inputs (first-read order), outputs (read by a later
    item, persistable or fetched; first-production order) and donations:
    the JAX package's `_build_plan` (:374-449) without the compile."""
    from ..ops import registry

    block = program.block(block_idx)
    ops = block.ops
    plan, cur_ops, cur_idx = [], [], []
    for i, op in enumerate(ops):
        if registry.get_runtime_info(op.type).no_jit:
            if cur_ops:
                plan.append(_Segment(cur_ops, cur_idx))
                cur_ops, cur_idx = [], []
            plan.append(i)
        else:
            cur_ops.append(op)
            cur_idx.append(i)
    if cur_ops:
        plan.append(_Segment(cur_ops, cur_idx))

    persistable = {n for n, v in block.vars.items() if v.persistable}
    fetch_set = set(fetch_names)
    reads_after = collections.defaultdict(list)
    for i, op in enumerate(ops):
        for n in op.input_arg_names:
            reads_after[n].append(i)

    for seg in plan:
        if not isinstance(seg, _Segment):
            continue
        seg_set = set(seg.op_indices)
        produced = {}   # first-production order
        in_names = []
        for op in seg.ops:
            for n in op.input_arg_names:
                if n != EMPTY_VAR_NAME and n not in produced \
                        and n not in in_names:
                    in_names.append(n)
            for n in op.output_arg_names:
                if n != EMPTY_VAR_NAME:
                    produced[n] = True
        last = max(seg.op_indices)
        out_names = [
            n for n in produced
            if any(j > last and j not in seg_set for j in reads_after[n])
            or n in persistable or n in fetch_set]
        seg.in_names = in_names
        seg.out_names = out_names
        seg.stateful = any(registry.get_runtime_info(op.type).stateful
                           for op in seg.ops)
        overwritten = set(out_names) & set(in_names) & persistable
        seg.donate = tuple(i + 1 for i, n in enumerate(in_names)
                           if n in overwritten)
    return plan


def make_segment_fn(seg, device, where=None):
    """fn(rng, *args) -> outputs: the segment's ops run eagerly over its
    inputs (the JAX package's `make_segment_fn`, :496).  A value lives
    until its last reader in the segment unless it is an output.  `where`,
    a dict, is told which op runs (`where["op"]`), so that a failure
    inside a capture can name it."""
    op_list = list(zip(seg.op_indices, seg.ops))
    in_names = list(seg.in_names)
    out_names = list(seg.out_names)
    keep = set(out_names)
    last = {}
    for j, (_, op) in enumerate(op_list):
        for n in op.input_arg_names:
            last[n] = j
    where = {} if where is None else where

    def segment_fn(rng, *args):
        env = dict(zip(in_names, args))
        for j, (op_idx, op) in enumerate(op_list):
            where["op"] = (op_idx, op.type)
            outs = _run_op(op, env.get, rng, device)
            for n in op.input_arg_names:
                if last.get(n) == j and n not in keep:
                    env.pop(n, None)
            for n, v in _outputs(op, outs):
                if n in keep or last.get(n, -1) > j:
                    env[n] = v
        where.pop("op", None)
        return tuple(env[n] for n in out_names)

    return segment_fn


def _compile_segment(seg, device, graph_pool=None, capture=True):
    """The segment's callable on `device`: its ops run eagerly on the CPU,
    for a stateful segment and without `capture`; captured as a CUDA
    graph otherwise."""
    where = {}
    fn = make_segment_fn(seg, device, where)
    # a stateful segment draws from the torch.Generator seeded per run: a
    # graph would replay its first draw forever
    if device.type != "cuda" or seg.stateful or not capture:
        return fn
    from .cuda_graph import CapturedSegment

    return CapturedSegment(
        fn, seg.in_names, seg.out_names, device, donate=seg.donate,
        pool=graph_pool, where=where,
        label=f"ops {seg.op_indices[0]}-{seg.op_indices[-1]}")


def _feed_sig(v):
    return (tuple(v.shape), str(v.dtype))


class Executor:
    """User-facing executor (reference python/paddle/fluid/executor.py).
    `mode` is "interpret" or "jit"; None reads the `executor_mode` flag."""

    def __init__(self, place=None, mode=None):
        from .. import flags

        self.device = as_device(place)
        self.mode = mode or flags.get("executor_mode")
        if self.mode not in ("interpret", "jit"):
            raise ValueError(f"executor mode {self.mode!r}: 'interpret' or "
                             "'jit'")
        self._cache = {}
        self._graph_pool = None

    def run(self, program: Program = None, feed: dict = None,
            fetch_list=None, scope: Scope = None, return_numpy: bool = True):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        captured = self.mode == "jit" and self.device.type == "cuda"
        staged = {name: stage_feed(value, self.device, program, name,
                                   captured)
                  for name, value in (feed or {}).items()}
        for name, value in staged.items():
            scope.set_var(name, value)
        rng = _next_generator(program, scope, self.device)
        fetch_names = [_as_fetch_name(f) for f in fetch_list or []]
        with torch.no_grad():
            if self.mode == "interpret":
                run_block(program, scope, self.device, rng, keep=fetch_names)
            else:
                self._run_jit(program, scope, staged, fetch_names, rng)
        outs = []
        for name in fetch_names:
            v = scope.find_var(name)
            if return_numpy and isinstance(v, torch.Tensor):
                if v.dtype == torch.bfloat16:
                    v = v.float()
                v = v.cpu().numpy()
            outs.append(v)
        return outs

    def _plan(self, program, feed, fetch_names):
        """The cached plan for this (program, version, block, feed
        signatures, fetches, trace-affecting flags): the JAX package's key
        (:281-295).  A version bump evicts the program's stale plans."""
        from .. import flags

        key = (id(program), program.version, 0,
               tuple(sorted((n, _feed_sig(v)) for n, v in feed.items())),
               tuple(fetch_names), flags.trace_signature())
        plan = self._cache.get(key)
        if plan is None:
            for k in [k for k in self._cache
                      if k[0] == key[0] and k[1] != key[1]]:
                del self._cache[k]
            if self.device.type == "cuda" and self._graph_pool is None:
                # every graph of this Executor allocates from one pool:
                # safe because replays are serial on one stream and each
                # graph's outputs are copied out of it (or are the
                # caller's own tensors, written in place) before another
                # graph replays
                self._graph_pool = torch.cuda.graph_pool_handle()
            plan = build_plan(program, fetch_names)
            for seg in plan:
                if isinstance(seg, _Segment):
                    seg.fn = _compile_segment(seg, self.device,
                                              self._graph_pool)
            self._cache[key] = plan
        return plan

    def _run_jit(self, program, scope, feed, fetch_names, rng):
        block = program.global_block()
        for item in self._plan(program, feed, fetch_names):
            if isinstance(item, _Segment):
                args = []
                for n in item.in_names:
                    v = scope.find_var(n)
                    if v is None:
                        raise RuntimeError(
                            f"var {n!r} has no value in scope (did you run "
                            "the startup program?)")
                    args.append(v)
                for n, v in zip(item.out_names, item.fn(rng, *args)):
                    scope.set_var(n, v)
            else:   # a no_jit op, on the host between segments
                op = block.ops[item]
                for n, v in _outputs(op, _run_op(op, scope.find_var, rng,
                                                 self.device)):
                    scope.set_var(n, v)


def program_as_function(program, scope, fetch_names, place=None,
                        graph_pool=None, mode="jit"):
    """A callable over `program` as one segment: fn(feed) -> tuple of the
    fetched tensors, in `fetch_names` order (the JAX package's
    `program_as_function`, :554).  `feed` maps names to host arrays or
    tensors; every other input (the parameters) is read from `scope` at
    each call, and nothing is written into it.

    On the card the segment is captured (cuda_graph.CapturedSegment):
    host feeds are copied into the graph's own buffers, tensors on the
    card are read where they lie, and `graph_pool` (a
    `torch.cuda.graph_pool_handle()`) is the memory pool its graphs share
    with the caller's other graphs; `mode="interpret"` runs the ops
    eagerly there instead.  Raises when a `no_jit` op lies on the fetch
    path."""
    device = as_device(place)
    fetch_names = list(fetch_names)
    plan = build_plan(program, fetch_names)
    if len(plan) != 1 or not isinstance(plan[0], _Segment):
        # host ops off the fetch path are dropped, as the JAX package does
        program = program._prune(fetch_names)
        plan = build_plan(program, fetch_names)
    if len(plan) != 1 or not isinstance(plan[0], _Segment):
        host_ops = sorted({program.global_block().ops[i].type
                           for i in plan if not isinstance(i, _Segment)})
        raise ValueError("program contains host-side (no_jit) ops on the "
                         f"fetch path: {host_ops}")
    seg = plan[0]
    captured = device.type == "cuda" and not seg.stateful and mode == "jit"
    seg.fn = _compile_segment(seg, device, graph_pool, captured)
    in_names = list(seg.in_names)
    unknown = [n for n in fetch_names
               if n not in seg.out_names and n not in in_names]
    if unknown:
        raise ValueError(f"fetch targets {unknown} are neither computed nor "
                         "read by the program")
    out_index = {n: i for i, n in enumerate(seg.out_names)}

    def fn(feed):
        args = []
        for n in in_names:
            if n in feed:
                args.append(stage_feed(feed[n], device, program, n, captured))
                continue
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(f"var {n!r} has no value: feed it or run "
                                   "the startup program first")
            args.append(v)
        outs = seg.fn(None, *args)
        return tuple(outs[out_index[n]] if n in out_index
                     else args[in_names.index(n)] for n in fetch_names)

    return fn
