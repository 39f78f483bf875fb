"""Executor: runs a Program on a Place.

Counterpart of paddle_tpu/framework/executor.py's interpreter path
(`_run_interpret`, :226): the block's ops run one after another, each
through its registered lowering on the scope's tensors, eagerly.  There is
no segment tracing and no torch.compile.  Feeds are staged with
`torch.as_tensor(..., device=place)` in the declared dtype (int64 stays
int64), fetches come back as numpy arrays unless `return_numpy=False`
(bfloat16 tensors as float32 arrays, value for value: numpy has no
bfloat16).

What a run writes back is the JAX executor's liveness rule for a traced
block (`_build_plan`, :374): persistables and fetch targets go to the
scope; every other op output lives in a per-run table only until its last
reader has run, so a training step never holds all its activations and
gradients at once.  Programs run under `torch.no_grad()`: tensors a
startup creates are ordinary tensors that the grad lowerings may replay
under autograd (tensors born under `torch.inference_mode()` could not be
saved for backward).

Stateful ops (uniform_random) draw from a `torch.Generator` on the place,
seeded from Program.random_seed and the scope's run counter, so one
program run twice in one scope draws differently and a rerun in a fresh
scope draws the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .core_types import as_device, dtype_to_torch
from .framework import EMPTY_VAR_NAME, Program, Variable, default_main_program
from .scope import Scope, global_scope

_RNG_COUNTER_NAME = "@RNG_COUNTER@"


def _as_fetch_name(f):
    return f.name if isinstance(f, Variable) else str(f)


def stage_feed(value, device, program, name):
    """Host value -> tensor on `device`, in the var's declared dtype when
    `program` declares `name` (tensors already on the device pass as-is)."""
    dtype = None
    blk = program.global_block()
    if blk.has_var(name) and blk.var(name).type == "lod_tensor":
        dtype = dtype_to_torch(blk.var(name).dtype)
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype or value.dtype)
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


def run_block(program, scope, device, rng=None, keep=(), write=None):
    """Run block 0's ops over `scope`.  Outputs that are persistable or in
    `keep` are stored with `write(name, value)` (default: scope.set_var);
    other outputs live in a local table until their last reader has run."""
    from ..ops import registry

    write = write or scope.set_var
    block = program.global_block()
    ops = block.ops
    last = _last_reads(ops)
    stored = set(keep) | {n for n, v in block.vars.items() if v.persistable}
    local = {}

    def read(n):
        if n == EMPTY_VAR_NAME:
            return None
        return local[n] if n in local else scope.find_var(n)

    for i, op in enumerate(ops):
        info = registry.get_runtime_info(op.type)
        inputs = {param: [read(n) for n in names]
                  for param, names in op.inputs.items()}
        outs = registry.run_forward(info, inputs, op.attrs,
                                    rng=rng if info.stateful else None,
                                    out_names=op.outputs, device=device)
        for n in op.input_arg_names:
            if last.get(n) == i:
                local.pop(n, None)
        for param, names in op.outputs.items():
            vals = outs.get(param, [])
            for j, n in enumerate(names):
                if n == EMPTY_VAR_NAME or j >= len(vals) or vals[j] is None:
                    continue
                if n in stored:
                    local.pop(n, None)
                    write(n, vals[j])
                elif last.get(n, -1) > i:
                    local[n] = vals[j]


class Executor:
    """User-facing executor (reference python/paddle/fluid/executor.py)."""

    def __init__(self, place=None):
        self.device = as_device(place)

    def run(self, program: Program = None, feed: dict = None,
            fetch_list=None, scope: Scope = None, return_numpy: bool = True):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        for name, value in (feed or {}).items():
            scope.set_var(name, stage_feed(value, self.device, program, name))
        rng = _next_generator(program, scope, self.device)
        fetch_names = [_as_fetch_name(f) for f in fetch_list or []]
        with torch.no_grad():
            run_block(program, scope, self.device, rng, keep=fetch_names)
        outs = []
        for name in fetch_names:
            v = scope.find_var(name)
            if return_numpy and isinstance(v, torch.Tensor):
                if v.dtype == torch.bfloat16:
                    v = v.float()
                v = v.cpu().numpy()
            outs.append(v)
        return outs


def program_as_function(program, scope, fetch_names, place=None):
    """A callable that replays `program`'s ops: fn(feed) -> tuple of the
    fetched tensors, in `fetch_names` order.  `feed` maps names to host
    arrays or tensors.  Feeds and the fetched outputs live in a child scope
    made per call, so the replay reads `scope`'s parameters and never
    writes into it; other outputs die after their last reader."""
    device = as_device(place)
    fetch_names = list(fetch_names)

    def fn(feed):
        local = Scope(parent=scope)
        for name, value in feed.items():
            local.set_local(name, stage_feed(value, device, program, name))
        run_block(program, local, device, keep=fetch_names,
                  write=local.set_local)
        missing = [n for n in fetch_names if local.find_var(n) is None]
        if missing:
            raise RuntimeError(f"fetch targets {missing} have no value after "
                               "the replay")
        return tuple(local.find_var(n) for n in fetch_names)

    return fn
