"""Op registry: op_type -> {torch lowering, shape inference, grad maker}.

Counterpart of paddle_tpu/ops/registry.py.  A lowering is a plain
function over torch.Tensors that runs eagerly on whatever device its
inputs live on.  The Executor's jit path (framework/executor.py) runs
them in segments, each captured as a CUDA graph on the card; an op
registered `no_jit` runs on the host between segments.
Build-time shape/dtype inference runs the lowering once on
`torch.device("meta")` tensors, the role `jax.eval_shape` plays in the JAX
package.

Gradients follow the JAX package's contract: `append_backward` asks each
op's grad maker (a custom one, or `default_grad_maker`) for `<type>_grad`
op descs, and the lowering of `<type>_grad` is either hand-written
(`register_grad`) or synthesised by `make_generic_grad_forward`, which
replays the forward lowering under autograd where the JAX package calls
`jax.vjp`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..framework.core_types import (
    convert_dtype,
    dtype_to_torch,
    is_float_dtype,
)
from ..framework.framework import EMPTY_VAR_NAME, grad_var_name

# batch-dim sentinel: -1 dims are replaced by this prime for meta-tensor
# inference, then mapped back.  Large and prime so accidental collisions
# with real layer sizes are implausible (the JAX package's value).
_DYN_SENTINEL = 2039


@dataclass
class OpInfo:
    type: str
    forward: Callable  # fn(ctx) -> None, writes ctx outputs
    infer_shape: Optional[Callable] = None  # fn(op, block) -> None
    grad_maker: Optional[Callable] = None  # fn(op, block, no_grad_set)
    backward: Optional[Callable] = None  # hand-written grad lowering fn(ctx)
    stateful: bool = False  # draws from ctx.rng()
    no_grad: bool = False  # no gradient (optimizer updates, grad ops)
    # runs on the host between the jit path's segments (feed/fetch, I/O,
    # print, host-shaped ops), never inside a captured segment
    no_jit: bool = False
    # writes an input tensor in place and returns it as its output (the
    # KV cache appends); a sub-block op copies the states it hands such a
    # block (control_flow_ops.private)
    in_place: bool = False
    # raised when backward has to differentiate through a no_grad op
    # (None: the op silently contributes nothing)
    grad_error: Optional[str] = None


OPS: dict[str, OpInfo] = {}


class OpContext:
    """Runtime view of one op: named input tensors, attrs, output slots."""

    __slots__ = ("op_type", "_inputs", "attrs", "_outputs", "_rng",
                 "_out_names", "device")

    def __init__(self, op_type, inputs, attrs, rng=None, out_names=None,
                 device=None):
        self.op_type = op_type
        # where ops without tensor inputs (fill_constant, uniform_random,
        # assign_value) allocate: the Executor's place, or "meta" while
        # inferring shapes
        self.device = device
        self._inputs = inputs  # param -> [tensor|None]
        self.attrs = attrs
        self._outputs = {}
        self._rng = rng
        self._out_names = out_names or {}

    def input(self, name, idx=0):
        lst = self._inputs.get(name) or []
        return lst[idx] if idx < len(lst) else None

    def inputs(self, name):
        return self._inputs.get(name) or []

    def has_input(self, name):
        lst = self._inputs.get(name) or []
        return len(lst) > 0 and lst[0] is not None

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_output(self, name, value, idx=0):
        lst = self._outputs.setdefault(name, [])
        while len(lst) <= idx:
            lst.append(None)
        lst[idx] = value

    def set_outputs(self, name, values):
        self._outputs[name] = list(values)

    def num_outputs(self, name):
        return len(self._out_names.get(name, []))

    def wants(self, name):
        """Whether the op desc names a real var for output `name` (a grad
        op's output is EMPTY where no gradient is asked for)."""
        names = self._out_names.get(name) or []
        return bool(names) and names[0] != EMPTY_VAR_NAME

    def rng(self) -> torch.Generator:
        if self._rng is None:
            raise RuntimeError(
                f"op {self.op_type} needs a torch.Generator but none was "
                "provided")
        return self._rng


def register_op(op_type, *, stateful=False, no_grad=False, no_jit=False,
                in_place=False, grad_error=None, infer_shape=None):
    """Register the forward lowering for `op_type`."""

    def deco(fn):
        if op_type in OPS:
            raise ValueError(f"op {op_type} registered twice")
        OPS[op_type] = OpInfo(type=op_type, forward=fn, stateful=stateful,
                              no_grad=no_grad, no_jit=no_jit,
                              in_place=in_place, grad_error=grad_error,
                              infer_shape=infer_shape)
        return fn

    return deco


def register_grad(op_type):
    """Register a hand-written lowering for `<op_type>_grad`."""

    def deco(fn):
        OPS[op_type].backward = fn
        return fn

    return deco


def register_remat_grad(op_type):
    """Give `op_type` the generic gradient.  The JAX package adds an
    optimization barrier here so that XLA recomputes the op's internals in
    the backward instead of keeping them alive; an eager replay always
    recomputes, so the port needs no barrier."""
    OPS[op_type].backward = make_generic_grad_forward(op_type)


def register_grad_maker(op_type):
    """Register a custom desc-level grad maker: it decides which vars the
    grad op reads and writes."""

    def deco(fn):
        OPS[op_type].grad_maker = fn
        return fn

    return deco


def register_infer_shape(op_type):
    def deco(fn):
        OPS[op_type].infer_shape = fn
        return fn

    return deco


def get_op_info(op_type) -> OpInfo:
    info = OPS.get(op_type)
    if info is None:
        raise NotImplementedError(
            f"op {op_type!r} is not registered in paddle_tpu_torch yet; the "
            "op families still to port are listed in ROADMAP.md A")
    return info


def is_registered(op_type) -> bool:
    return op_type in OPS


def run_forward(info: OpInfo, inputs, attrs, rng=None, out_names=None,
                device=None):
    """Run an op lowering.  inputs: {param: [tensor|None]};
    returns {param: [tensor|None]}."""
    ctx = OpContext(info.type, inputs, attrs, rng=rng, out_names=out_names,
                    device=device)
    info.forward(ctx)
    return ctx._outputs


def infer_shape(op, block):
    """Compile-time shape/dtype propagation: run the lowering on meta
    tensors and set the output VarDesc shapes.  -1 (batch) dims are
    replaced by a sentinel and mapped back afterwards."""
    if not is_registered(op.type):
        return
    info = get_op_info(op.type)
    if info.infer_shape is not None:
        info.infer_shape(op, block)
        return
    if info.no_jit:     # host ops: shapes may depend on values
        return

    meta_inputs = {}
    for param, names in op.inputs.items():
        lst = []
        for name in names:
            v = block._var_recursive(name)
            if v.shape is None:
                return  # unknown input; skip inference
            shape = tuple(_DYN_SENTINEL if s in (-1, None) else s
                          for s in v.shape)
            lst.append(torch.empty(shape, dtype=dtype_to_torch(v.dtype),
                                   device="meta"))
        meta_inputs[param] = lst
    try:
        outs = run_forward(info, meta_inputs, op.attrs, out_names=op.outputs,
                           device=torch.device("meta"))
    except Exception as e:  # surface with op context
        raise RuntimeError(
            f"infer_shape failed for op {op.type!r} (inputs "
            f"{op.inputs}, outputs {op.outputs}): {e}") from e

    for param, names in op.outputs.items():
        shaped = [o for o in outs.get(param, []) if o is not None]
        for i, name in enumerate(names):
            if i >= len(shaped) or not block.has_var_recursive(name):
                continue
            v = block._var_recursive(name)
            # MULTIPLES of the sentinel are batch-dim products
            # (reshape[-1, V] -> batch*seq): map them back to -1 too
            v.shape = tuple(
                -1 if (s == _DYN_SENTINEL
                       or (s >= _DYN_SENTINEL and s % _DYN_SENTINEL == 0))
                else s
                for s in shaped[i].shape
            )
            v.dtype = convert_dtype(shaped[i].dtype)


# ---------------------------------------------------------------------------
# Gradients: the desc-level default maker and the autograd-backed lowering
# ---------------------------------------------------------------------------

GRAD_SUFFIX_PARAM = "@GRAD"


def default_grad_maker(op, block, no_grad_set):
    """One `<type>_grad` op whose inputs are the forward inputs, forward
    outputs and output grads, and whose outputs are the input grads
    (registry.py:297 of the JAX package)."""
    info = get_op_info(op.type)
    if info.no_grad:
        return []
    grad_inputs = {}
    for param, names in op.inputs.items():
        grad_inputs[param] = list(names)
    for param, names in op.outputs.items():
        grad_inputs[param] = list(names)
        grad_inputs[param + GRAD_SUFFIX_PARAM] = [grad_var_name(n)
                                                  for n in names]
    grad_outputs = {}
    for param, names in op.inputs.items():
        grad_outputs[param + GRAD_SUFFIX_PARAM] = [
            None if n in no_grad_set or not _differentiable(block, n)
            else grad_var_name(n)
            for n in names
        ]
    return [{"type": op.type + "_grad", "inputs": grad_inputs,
             "outputs": grad_outputs, "attrs": dict(op.attrs)}]


def _differentiable(block, name):
    try:
        v = block._var_recursive(name)
    except ValueError:
        return True
    return is_float_dtype(v.dtype) if v.type == "lod_tensor" else False


def make_generic_grad_forward(fwd_type):
    """The lowering of `<fwd_type>_grad`: replay the forward lowering under
    autograd and pull the cotangents back (the JAX package's `jax.vjp`).

    The differentiable leaves (the forward inputs whose `P@GRAD` the grad
    op writes) are detached and marked `requires_grad`; integer leaves
    carry no grad.  Each cotangent is cast to its primal's dtype.  A
    missing cotangent is zero: its output is left out of
    `torch.autograd.grad`, which adds the same nothing without computing
    it.  A leaf no output depends on gets zeros."""
    fwd_info = get_op_info(fwd_type)

    def grad_fn(ctx):
        fwd_in, out_grads = {}, {}
        for param, vals in ctx._inputs.items():
            if param.endswith(GRAD_SUFFIX_PARAM):
                out_grads[param[:-len(GRAD_SUFFIX_PARAM)]] = vals
            else:
                fwd_in[param] = vals
        for p in out_grads:       # forward outputs are not replay inputs
            fwd_in.pop(p, None)
        diff_params = [p[:-len(GRAD_SUFFIX_PARAM)] for p in ctx._out_names
                       if p.endswith(GRAD_SUFFIX_PARAM)]
        leaves = {}
        for p in diff_params:
            if p not in fwd_in:
                continue
            leaves[p] = [
                x.detach().requires_grad_(True)
                if x is not None and x.is_floating_point() else x
                for x in fwd_in[p]]
        merged = dict(fwd_in)
        merged.update(leaves)
        with torch.enable_grad():
            outs = run_forward(
                fwd_info, merged, ctx.attrs,
                rng=ctx._rng if fwd_info.stateful else None,
                out_names={p: [f"__o{i}" for i in range(len(v))]
                           for p, v in out_grads.items()},
                device=ctx.device)
            prims, cots = [], []
            for p, gs in out_grads.items():
                for i, prim in enumerate(outs.get(p, [])):
                    g = gs[i] if i < len(gs) else None
                    if prim is None or g is None or not prim.requires_grad:
                        continue
                    prims.append(prim)
                    cots.append(g.to(prim.dtype))
            flat = [x for p in leaves for x in leaves[p]
                    if x is not None and x.requires_grad]
            grads = (torch.autograd.grad(prims, flat, cots,
                                         allow_unused=True)
                     if prims and flat else [None] * len(flat))
        by_leaf = {id(x): g for x, g in zip(flat, grads)}
        for p, xs in leaves.items():
            vals = []
            for x in xs:
                if x is None or not x.requires_grad:
                    vals.append(None)
                    continue
                g = by_leaf[id(x)]
                vals.append(torch.zeros_like(x) if g is None else g.detach())
            ctx.set_outputs(p + GRAD_SUFFIX_PARAM, vals)

    return grad_fn


@functools.lru_cache(maxsize=None)
def get_runtime_info(op_type) -> OpInfo:
    """The runtime lowering of an op type; `<x>_grad` lowerings are
    synthesised on demand from `<x>`'s hand-written grad or the generic
    one."""
    if op_type in OPS:
        return OPS[op_type]
    if op_type.endswith("_grad"):
        fwd = OPS.get(op_type[:-len("_grad")])
        if fwd is not None:
            fn = fwd.backward or make_generic_grad_forward(fwd.type)
            return OpInfo(type=op_type, forward=fn, no_grad=True,
                          stateful=fwd.stateful)
    return get_op_info(op_type)


def make_grad_ops(op, block, no_grad_set):
    """Entry used by append_backward: the custom maker if registered, else
    the default one."""
    info = get_op_info(op.type)
    if info.grad_maker is not None:
        return info.grad_maker(op, block, no_grad_set)
    return default_grad_maker(op, block, no_grad_set)
