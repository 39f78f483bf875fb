"""Op registry: op_type -> {torch lowering, shape inference}.

Counterpart of paddle_tpu/ops/registry.py.  A lowering is a plain
function over torch.Tensors that runs eagerly on whatever device its
inputs live on; there is no jit, no segments and no torch.compile.
Build-time shape/dtype inference runs the lowering once on
`torch.device("meta")` tensors, the role `jax.eval_shape` plays in the JAX
package.  The serving slice is inference only: no grad makers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..framework.core_types import convert_dtype, dtype_to_torch

# batch-dim sentinel: -1 dims are replaced by this prime for meta-tensor
# inference, then mapped back.  Large and prime so accidental collisions
# with real layer sizes are implausible (the JAX package's value).
_DYN_SENTINEL = 2039


@dataclass
class OpInfo:
    type: str
    forward: Callable  # fn(ctx) -> None, writes ctx outputs
    infer_shape: Optional[Callable] = None  # fn(op, block) -> None
    stateful: bool = False  # draws from ctx.rng()


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

    def rng(self) -> torch.Generator:
        if self._rng is None:
            raise RuntimeError(
                f"op {self.op_type} needs a torch.Generator but none was "
                "provided")
        return self._rng


def register_op(op_type, *, stateful=False, infer_shape=None):
    """Register the forward lowering for `op_type`."""

    def deco(fn):
        if op_type in OPS:
            raise ValueError(f"op {op_type} registered twice")
        OPS[op_type] = OpInfo(type=op_type, forward=fn, stateful=stateful,
                              infer_shape=infer_shape)
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
            f"op {op_type!r} is not registered in paddle_tpu_torch (the "
            "serving slice ports 15 op types; see ROADMAP.md A)")
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
