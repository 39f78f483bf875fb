"""Program/Block/Operator/Variable — the define-then-run IR.

Counterpart of paddle_tpu/framework/framework.py, kept to what the serving
and training slices need: layer functions append Operators to a Program,
`append_backward` appends grad ops, the optimizers append update ops, the
Executor runs them.  The IR is plain Python data and `Program.to_dict` gives the
same `paddle_tpu.program.v1` form as the JAX package, so a program built
here can be compared op for op, attr for attr and var for var with the
JAX package's build of the same model.
"""

from __future__ import annotations

import collections
import contextlib
import copy

import numpy as np

from . import unique_name
from .core_types import VarType, convert_dtype

GRAD_VAR_SUFFIX = "@GRAD"
TEMP_VAR_NAME = "@TEMP@"
EMPTY_VAR_NAME = "@EMPTY@"


def grad_var_name(name: str) -> str:
    """reference: paddle/fluid/framework/operator.h GradVarName()"""
    return name + GRAD_VAR_SUFFIX


class OpRole:
    """The op_role attr the backward, optimizer and transpiler passes key
    off (framework.py:42 of the JAX package)."""

    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256

    ATTR_NAME = "op_role"
    VAR_ATTR_NAME = "op_role_var"


_OP_ROLE_STACK = [OpRole.Forward]


def current_op_role():
    return _OP_ROLE_STACK[-1]


@contextlib.contextmanager
def op_role_guard(role):
    """Ops appended inside get attrs[op_role] = role."""
    _OP_ROLE_STACK.append(role)
    try:
        yield
    finally:
        _OP_ROLE_STACK.pop()


class Variable:
    """A named slot in a Block: shape/dtype/type metadata only — values live
    in a Scope at run time."""

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype="float32",
        type=VarType.LOD_TENSOR,
        persistable=False,
        stop_gradient=False,
        is_data=False,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate(TEMP_VAR_NAME)
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if type == VarType.LOD_TENSOR else dtype
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = kwargs.get("lod_level", 0)
        # layout on a device mesh: one mesh-axis name (or a tuple of them,
        # or None) per dim, read by parallel/ (framework.py:124 of the JAX
        # package).  A clone copies it; to_dict leaves it out, as the JAX
        # package's does
        self.dist_attr = kwargs.get("dist_attr", None)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": str(self.dtype),
            "type": self.type,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "lod_level": self.lod_level,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }

    def __repr__(self):
        return (
            f"Variable(name={self.name}, shape={self.shape}, dtype={self.dtype}, "
            f"persistable={self.persistable})"
        )

    __str__ = __repr__


class Parameter(Variable):
    """Persistable trainable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or any(s is None for s in shape):
            raise ValueError("Parameter shape must be fully specified")
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)


class Operator:
    """One op invocation: type + named input/output var lists + attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}   # param name -> [var name]
        self.outputs = {}  # param name -> [var name]
        self.attrs = dict(attrs or {})
        self.attrs.setdefault(OpRole.ATTR_NAME, current_op_role())
        for param, vars_ in (inputs or {}).items():
            self.inputs[param] = _to_name_list(vars_)
        for param, vars_ in (outputs or {}).items():
            self.outputs[param] = _to_name_list(vars_)

    def input(self, name):
        return self.inputs.get(name, [])

    def output(self, name):
        return self.outputs.get(name, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rename_input(self, old, new):
        for param, names in self.inputs.items():
            self.inputs[param] = [new if n == old else n for n in names]

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _jsonable_attrs(self.attrs),
        }

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{self.type}({ins}) -> {outs}"


def _to_name_list(vars_):
    if vars_ is None:
        return []
    if not isinstance(vars_, (list, tuple)):
        vars_ = [vars_]
    out = []
    for v in vars_:
        if v is None:
            out.append(EMPTY_VAR_NAME)
        elif isinstance(v, Variable):
            out.append(v.name)
        else:
            out.append(str(v))
    return out


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if k.startswith("_"):
            continue  # runtime scratch, not desc
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif isinstance(v, Block):
            # a BLOCK attr serializes as its block index (reference
            # framework.proto AttrType.BLOCK)
            out[k] = {"__block__": v.idx}
        else:
            out[k] = v
    return out


class Block:
    """Ordered op list + var table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars = collections.OrderedDict()  # name -> Variable
        self.ops = []

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs):
        # parameters always live in the global block (reference behavior)
        global_block = self.program.global_block()
        name = kwargs.get("name")
        if name is not None and name in global_block.vars:
            return global_block.vars[name]
        param = Parameter(global_block, **kwargs)
        global_block.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"var {name!r} not in block {self.idx}")
        return v

    def has_var(self, name) -> bool:
        return name in self.vars

    def _var_recursive(self, name):
        blk = self
        while True:
            if name in blk.vars:
                return blk.vars[name]
            if blk.parent_idx == -1:
                raise ValueError(f"var {name!r} not found from block {self.idx}")
            blk = self.program.block(blk.parent_idx)

    def has_var_recursive(self, name):
        try:
            self._var_recursive(name)
            return True
        except ValueError:
            return False

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        if infer_shape:
            from ..ops import registry

            registry.infer_shape(op, self)
        return op

    def _prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        from ..ops import registry

        registry.infer_shape(op, self)
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """A list of Blocks; block 0 is global.  `default_startup_program`
    holds parameter-init ops, `default_main_program` the model."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0

    # -- versioning (the Executor's plan cache keys off this) -------------
    def _bump_version(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    def clone(self, for_test=False) -> "Program":
        """Deep copy of the whole program: ops, attrs and vars are the
        copy's own, so a rewrite of the copy leaves this one as it is.
        With `for_test` (framework.py:442-477 of the JAX package) the copy
        is an evaluation program: ops whose role is Backward or Optimize
        are dropped, `is_test` is set on every op that carries it and on
        dropout and batch_norm, and the `_`-prefixed runtime scratch attrs
        are stripped, in every block.  A BLOCK attr (a `while`'s
        sub_block) names the copy's own block: one deepcopy maps each
        block once."""
        p = copy.deepcopy(self)
        if not for_test:
            return p
        for blk in p.blocks:
            keep = []
            for op in blk.ops:
                for k in [k for k in op.attrs if k.startswith("_")]:
                    del op.attrs[k]
                role = op.attrs.get(OpRole.ATTR_NAME, OpRole.Forward)
                if role & OpRole.Backward or role == OpRole.Optimize:
                    continue
                if "is_test" in op.attrs or op.type in ("dropout",
                                                        "batch_norm"):
                    op.attrs["is_test"] = True
                keep.append(op)
            blk.ops = keep
        p._bump_version()
        return p

    def _prune(self, targets) -> "Program":
        """A copy that keeps only the ops needed to compute `targets`
        (framework.py:_prune of the JAX package): a reverse liveness walk
        over block 0."""
        needed = {t.name if isinstance(t, Variable) else str(t)
                  for t in targets}
        p = copy.deepcopy(self)
        blk = p.global_block()
        kept = []
        for op in reversed(blk.ops):
            if set(op.output_arg_names) & needed:
                kept.append(op)
                needed |= set(op.input_arg_names)
        blk.ops = kept[::-1]
        live = set(needed)
        for op in blk.ops:
            live |= set(op.input_arg_names) | set(op.output_arg_names)
        blk.vars = collections.OrderedDict(
            (n, v) for n, v in blk.vars.items() if n in live)
        p._bump_version()
        return p

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def block(self, idx) -> Block:
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def create_block(self, parent_idx=None) -> Block:
        """A new sub-block of the current block (or of `parent_idx`),
        made the current block: the ops that layers append until
        `rollback` go into it (framework.py:426-435 of the JAX
        package)."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        self._bump_version()
        return blk

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def to_dict(self):
        d = {
            "format": "paddle_tpu.program.v1",
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }
        # side tables of the JAX package's memory passes, carried through
        # save and load
        removed = getattr(self, "_memory_opt_removed", None)
        if removed:
            d["memory_opt_removed"] = dict(removed)
        reuse = getattr(self, "_reuse_plan", None)
        if reuse:
            d["reuse_plan"] = dict(reuse)
        return d

    @staticmethod
    def from_dict(d) -> "Program":
        """The inverse of `to_dict` (framework.py:518-565 of the JAX
        package): blocks and their vars first, so that a BLOCK attr can
        name any block, then the ops, with `__ndarray__` and `__block__`
        attrs restored.  A var with `is_parameter` becomes a Parameter
        with its `trainable`."""
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        if d.get("memory_opt_removed"):
            p._memory_opt_removed = dict(d["memory_opt_removed"])
        if d.get("reuse_plan"):
            p._reuse_plan = dict(d["reuse_plan"])
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd.get("parent_idx", -1))
            blk.forward_block_idx = bd.get("forward_block_idx", -1)
            p.blocks.append(blk)
            for vd in bd["vars"]:
                kwargs = dict(
                    name=vd["name"],
                    type=vd.get("type", VarType.LOD_TENSOR),
                    persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False),
                    is_data=vd.get("is_data", False),
                    lod_level=vd.get("lod_level", 0),
                )
                if vd.get("is_parameter"):
                    v = Parameter(blk, vd["shape"], vd["dtype"], **kwargs)
                    v.trainable = vd.get("trainable", True)
                else:
                    v = Variable(blk, shape=vd["shape"], dtype=vd["dtype"],
                                 **kwargs)
                blk.vars[v.name] = v
        for bd, blk in zip(d["blocks"], p.blocks):
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    elif isinstance(v, dict) and "__block__" in v:
                        attrs[k] = p.blocks[v["__block__"]]
                    else:
                        attrs[k] = v
                blk.ops.append(Operator(blk, od["type"], od["inputs"],
                                        od["outputs"], attrs))
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        return p

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append(f"-- block {blk.idx} (parent {blk.parent_idx}) --")
            for v in blk.vars.values():
                lines.append(f"  {v}")
            for op in blk.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)

    __str__ = __repr__


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Program = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
