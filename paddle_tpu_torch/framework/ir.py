"""IR pass infrastructure: the pass registry and the graph pattern matcher.

Counterpart of the pattern half of paddle_tpu/framework/ir.py (:36-253):
`register_pass`, `get_pass`, `apply_passes`, `GraphView`, `PatternOp`,
`GraphPatternDetector`, `Pass` and `PatternRewritePass`.  The Program
desc is the IR: a pass rewrites Blocks directly, and a GraphView gives
the producer/consumer edges the detector walks.  (The JAX module's
dataflow-driven analysis passes, from its :255 on, are not ported.)

    @register_pass("my_fuse")
    class MyFusePass(PatternRewritePass):
        pattern = [
            PatternOp("mul", type="mul", single_consumer_outputs=("Out",)),
            PatternOp("add", type="elementwise_add",
                      inputs={"X": ("mul", "Out")}),
        ]
        def rewrite(self, block, match, scope):
            return [...replacement Operators...]

    apply_passes(program, ["my_fuse"], scope=scope)

A PatternRewritePass whose rewrite() returns None keeps that match; a
list replaces the matched ops at the anchor's position.
"""

from __future__ import annotations

import collections

PASS_REGISTRY = {}


def register_pass(name):
    """REGISTER_PASS (ir/pass.h:199): register a Pass class (or zero-arg
    factory) under `name`."""

    def deco(cls):
        if name in PASS_REGISTRY:
            raise ValueError(f"pass {name!r} is registered more than once")
        PASS_REGISTRY[name] = cls
        return cls

    return deco


def get_pass(name):
    if name not in PASS_REGISTRY:
        raise KeyError(
            f"pass {name!r} has not been registered "
            f"(known: {sorted(PASS_REGISTRY)})")
    return PASS_REGISTRY[name]()


def apply_passes(program, names, scope=None):
    """Run the named passes over the program in order.  Every name is
    checked first, so that a typo late in the list cannot leave a
    half-transformed program; a bare string is one pass name."""
    if isinstance(names, str):
        names = [names]
    names = list(names)
    unknown = [n for n in names if n not in PASS_REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown pass name(s) {sorted(unknown)!r}; registered passes: "
            f"{sorted(PASS_REGISTRY)}")
    for name in names:
        program = get_pass(name).apply(program, scope=scope)
    return program


class GraphView:
    """Producer/consumer edges over one Block (the ops are the block's own
    objects, not copies)."""

    def __init__(self, block):
        self.block = block
        self.ops = list(block.ops)
        self.consumers = collections.defaultdict(list)  # var -> [op idx]
        for i, op in enumerate(self.ops):
            for n in op.input_arg_names:
                self.consumers[n].append(i)

    def n_consumers(self, var_name):
        return len(self.consumers.get(var_name, ()))


class PatternOp:
    """One op slot of a pattern.

    key: the name the match dict uses for this op.
    type: the required op type (str or tuple of str).
    inputs: {input_param: (earlier_key, output_param)}: the matched op's
        input var must be the earlier op's output var.
    single_consumer_outputs: output params whose var must have exactly one
        consumer in the block (the fuse-safety test).
    predicate: optional fn(block, op) -> bool for shape and attr gates.
    """

    def __init__(self, key, type, inputs=None, single_consumer_outputs=(),
                 predicate=None):
        self.key = key
        self.types = (type,) if isinstance(type, str) else tuple(type)
        self.inputs = dict(inputs or {})
        self.single_consumer_outputs = tuple(single_consumer_outputs)
        self.predicate = predicate


class GraphPatternDetector:
    """Yields every non-overlapping match of `pattern` (a list of
    PatternOp, anchor first) as {key: op}."""

    def __init__(self, pattern):
        if not pattern:
            raise ValueError("empty pattern")
        self.pattern = list(pattern)

    def _try_match(self, view, start_idx):
        match = {}
        used = set()
        for spec in self.pattern:
            if not match:  # anchor
                cand = start_idx
            else:
                # locate the op through its first linked input edge
                for param, (src_key, src_param) in spec.inputs.items():
                    outs = match[src_key].outputs.get(src_param) or []
                    if not outs:
                        return None
                    hits = [
                        i for i in view.consumers.get(outs[0], ())
                        if i not in used
                        and view.ops[i].type in spec.types
                        and (view.ops[i].inputs.get(param) or [None])[0]
                        == outs[0]
                    ]
                    if len(hits) != 1:
                        return None  # ambiguous or absent: no match
                    cand = hits[0]
                    break
                else:
                    raise ValueError(
                        f"pattern op {spec.key!r} has no linked input to "
                        "locate it from (only the first op may be free)")
            op = view.ops[cand]
            if op.type not in spec.types:
                return None
            # every declared edge must hold
            for param, (src_key, src_param) in spec.inputs.items():
                if src_key not in match:
                    return None
                src_outs = match[src_key].outputs.get(src_param) or []
                ins = op.inputs.get(param) or []
                if not src_outs or not ins or ins[0] != src_outs[0]:
                    return None
            for out_param in spec.single_consumer_outputs:
                outs = op.outputs.get(out_param) or []
                if not outs or view.n_consumers(outs[0]) != 1:
                    return None
            if spec.predicate is not None and not spec.predicate(
                    view.block, op):
                return None
            match[spec.key] = op
            used.add(cand)
        match["__indices__"] = used
        return match

    def find(self, view):
        anchor = self.pattern[0]
        taken = set()
        for i, op in enumerate(view.ops):
            if op.type not in anchor.types or i in taken:
                continue
            m = self._try_match(view, i)
            if m is None or (m["__indices__"] & taken):
                continue
            taken |= m["__indices__"]
            yield m


class Pass:
    """apply(program, scope) -> program.  Subclasses override apply(), or
    use PatternRewritePass for match-and-replace."""

    def apply(self, program, scope=None):
        raise NotImplementedError


class PatternRewritePass(Pass):
    """A pass defined by `pattern` (a list of PatternOp) and rewrite():
    each match's ops are replaced in place, at the anchor's position, by
    the ops rewrite() returns; None keeps the match."""

    pattern: list = None

    def rewrite(self, block, match, scope):
        raise NotImplementedError

    def apply(self, program, scope=None):
        changed = False
        for block in program.blocks:
            view = GraphView(block)
            replacements = {}  # anchor index -> (indices, new ops)
            for m in GraphPatternDetector(self.pattern).find(view):
                idxs = m.pop("__indices__")
                new_ops = self.rewrite(block, m, scope)
                if new_ops is None:
                    continue
                replacements[min(idxs)] = (idxs, list(new_ops))
            if not replacements:
                continue
            drop = set()
            for idxs, _ in replacements.values():
                drop |= idxs
            new_list = []
            for i, op in enumerate(view.ops):
                if i in replacements:
                    new_list.extend(replacements[i][1])
                elif i not in drop:
                    new_list.append(op)
            block.ops = new_list
            changed = True
        if changed:
            program._bump_version()
        return program
