"""Activation recompute (remat): trade FLOPs for device memory on the
backward pass.

Counterpart of paddle_tpu/recompute.py, line for line, so that both
packages rewrite a program into the same ops:

  * the user names *checkpoint* vars (segment boundaries, e.g. the
    residual stream after every transformer sub-block);
  * every activation produced between two checkpoints that the backward
    reads is re-derived by CLONED forward ops inserted into the backward
    region, and the grad ops are rewired to the clones' outputs, so the
    original activations die at the end of their forward segment and only
    checkpoints stay live across forward -> backward (the executor frees a
    value after its last reader, framework/executor.py);
  * each clone chain is seeded through an `rc_barrier` op, which takes the
    segment's incoming gradient as a trigger.  In the JAX package the
    barrier keeps XLA's CSE from merging the clones back into the forward
    values; eager torch merges nothing and runs ops in program order, so
    here it is an identity kept for the program's sake
    (ops/tensor_ops.py);
  * a cloned stateful op (dropout) carries `__rng_idx`, its original's
    position: the executor seeds its generator from that index, so the
    clone draws the mask its original drew in the same run.
"""

from __future__ import annotations

from .framework.framework import EMPTY_VAR_NAME, OpRole, Operator, Variable

__all__ = ["apply_recompute"]

_RC_FMT = "{}@RECOMPUTE@{}"
_RCB_FMT = "{}@RC_BARRIER@{}"


def _name(v):
    return v.name if isinstance(v, Variable) else str(v)


def apply_recompute(program, checkpoints, block_idx=0):
    """Rewrite `program` so activations between `checkpoints` are
    recomputed in the backward region.  Returns the number of cloned ops.

    Call after the backward (and optimizer) ops exist, i.e. after
    `optimizer.minimize`, and before the first `Executor.run`.
    """
    from .ops import registry

    block = program.block(block_idx)

    def role(op):
        return op.attrs.get(OpRole.ATTR_NAME, OpRole.Forward)

    def is_bwd(op):
        return bool(role(op) & OpRole.Backward)

    ops = block.ops
    bwd_start = next((i for i, op in enumerate(ops) if is_bwd(op)), len(ops))
    if bwd_start == len(ops):
        raise ValueError("apply_recompute: program has no backward ops; "
                         "call optimizer.minimize first")

    producer = {}  # var -> first producing forward op index
    for i in range(bwd_start):
        for n in ops[i].output_arg_names:
            producer.setdefault(n, i)

    cps = [_name(c) for c in checkpoints]
    cps = [c for c in cps if c in producer]
    cp_set = set(cps)
    if not cps:
        return 0
    cps.sort(key=lambda c: producer[c])

    # segment boundaries: (start_op_exclusive, end_op_inclusive) per
    # segment, walking checkpoints plus the head run after the last one
    seg_ranges = []
    for i, c in enumerate(cps):
        lo = producer[c]
        hi = producer[cps[i + 1]] if i + 1 < len(cps) else bwd_start - 1
        if hi > lo:
            seg_ranges.append((lo, hi))

    n_cloned = 0
    for seg_id, (lo, hi) in enumerate(seg_ranges):
        seg_ops = [op for op in block.ops[lo + 1: hi + 1]
                   if not is_bwd(op) and not role(op) & OpRole.Optimize]
        produced_here = set()
        for op in seg_ops:
            produced_here.update(n for n in op.output_arg_names
                                 if n != EMPTY_VAR_NAME)
        # vars the backward reads from this segment (checkpoints excluded:
        # they are kept by definition)
        rewire = set()
        for op in block.ops:
            if not is_bwd(op):
                continue
            for n in op.input_arg_names:
                if n in produced_here and n not in cp_set:
                    rewire.add(n)
        if not rewire:
            continue

        # backward slice inside the segment: clone only the ops needed to
        # re-derive `rewire`
        needed = set(rewire)
        keep = []
        for op in reversed(seg_ops):
            if set(op.output_arg_names) & needed:
                keep.append(op)
                needed |= {n for n in op.input_arg_names
                           if n != EMPTY_VAR_NAME}
        keep.reverse()
        if not keep:
            continue

        # the checkpoints the clones read go through the barrier
        seeds = []
        for op in keep:
            for n in op.input_arg_names:
                if n in cp_set and n not in seeds:
                    seeds.append(n)

        # insertion point: before the first backward op reading a rewired
        # var
        insert_at = None
        for j in range(bwd_start, len(block.ops)):
            op = block.ops[j]
            if is_bwd(op) and set(op.input_arg_names) & rewire:
                insert_at = j
                break
        if insert_at is None:
            continue

        # trigger: a gradient the segment's first rewired consumer also
        # reads, produced before the insertion point
        produced_before = set()
        for j in range(insert_at):
            produced_before.update(block.ops[j].output_arg_names)
        trigger = None
        for n in block.ops[insert_at].input_arg_names:
            if "@GRAD" in n and n in produced_before:
                trigger = n
                break

        new_ops = []
        seed_map = {}
        if seeds:
            barrier_outs = []
            for s in seeds:
                b = _RCB_FMT.format(s, seg_id)
                seed_map[s] = b
                barrier_outs.append(b)
                _clone_var(block, s, b)
            new_ops.append(Operator(
                block, "rc_barrier",
                inputs={"X": list(seeds),
                        "Trigger": [trigger] if trigger else []},
                outputs={"Out": barrier_outs},
                attrs={OpRole.ATTR_NAME: OpRole.Backward},
            ))

        cloned_names = {}
        for op in keep:
            ins = {param: [cloned_names.get(n, seed_map.get(n, n))
                           for n in names]
                   for param, names in op.inputs.items()}
            outs = {}
            for param, names in op.outputs.items():
                renamed = []
                for n in names:
                    if n == EMPTY_VAR_NAME:
                        renamed.append(n)
                        continue
                    r = _RC_FMT.format(n, seg_id)
                    cloned_names[n] = r
                    _clone_var(block, n, r)
                    renamed.append(r)
                outs[param] = renamed
            attrs = dict(op.attrs)
            attrs[OpRole.ATTR_NAME] = OpRole.Backward
            # a stateful clone (dropout) replays its original's draw: pin
            # its rng index to the original op's position
            if registry.is_registered(op.type) and \
                    registry.get_op_info(op.type).stateful:
                attrs.setdefault("__rng_idx", block.ops.index(op))
            new_ops.append(Operator(block, op.type, inputs=ins,
                                    outputs=outs, attrs=attrs))
        n_cloned += len(keep)

        block.ops[insert_at:insert_at] = new_ops

        # rewire every backward reader after the insertion point
        for j in range(insert_at + len(new_ops), len(block.ops)):
            op = block.ops[j]
            if not is_bwd(op):
                continue
            for param, names in op.inputs.items():
                op.inputs[param] = [cloned_names.get(n, n) if n in rewire
                                    else n for n in names]

    program._bump_version()
    return n_cloned


def _clone_var(block, src, dst):
    if block.has_var(dst):
        return
    v = block._var_recursive(src)
    block.create_var(name=dst, shape=v.shape, dtype=v.dtype,
                     stop_gradient=True)
