"""Control-flow ops: while, conditional_block, static_rnn.

Counterpart of paddle_tpu/ops/control_flow_ops.py.  A sub-block is the
op's `sub_block` attr (a Block) and is replayed by `replay_ops` over an
env of tensors, the role of the JAX package's functional replay inside
lax.while_loop / lax.scan / lax.cond.

How each op runs:
  - `while` is exact, as the JAX package's lax.while_loop: eagerly (the
    CPU, the interpreter, a warm-up, an eager segment on the card) it is
    a Python loop that reads its condition on the host every trip;
    inside a CUDA graph capture (the jit path on the card), where no host
    read may happen, it runs the trips the program fixes (`exact_trips`:
    the `i < const` counter pattern with integer constants) unrolled.  A
    `while` whose trip count the program does not fix, a `max_steps`
    set by hand included, cannot be captured:
    `framework/executor.build_plan` marks its segment eager
    (`needs_host`), and the capture path raises if one gets there.
  - `conditional_block` runs its block on every path, on its inputs when
    Cond holds and on zeros of them when it does not, and selects the
    block's outputs against zeros (no host read, so one form serves the
    CPU, the interpreter and a capture).  A gather by an index that only
    the condition keeps in bounds reads row 0 in the untaken branch, the
    select on the inputs masks the NaN or inf that the untaken branch's
    grad carries (0 * inf never reaches a leaf), and the block's draws
    advance its generator whether Cond holds or not.
  - `static_rnn` loops over its S steps (unrolled inside a capture).

Random draws: a drawing op inside a sub-block (dropout in a body) draws
from the generator of the sub-block op that runs it (`ctx.rng()`, seeded
by the Executor like any drawing op's, see executor._Streams), in the
order the body runs.  The generic grad of static_rnn and
conditional_block replays its forward from the same seed in the same
order, so it redraws the forward's values; while_grad replays the body
in another order, so a `while` whose body draws has no gradient here
(it raises).

Gradients: static_rnn and conditional_block take the registry's generic
replay under autograd, as the JAX package takes jax.vjp.  `while` has a
hand-written grad (`while_grad`, the JAX rule :122-315): the forward
also emits InitCarry (the pre-loop carries; the loop writes its carries
back in place), and the grad replays the body step by step pulling
cotangents back.  With a trip bound `max_steps` it is the JAX package's
scan: `max_steps` predicated steps record every step's carry (O(T)
replays; a dead step replays the last live step's inputs, so a body that
gathers by the counter reads in bounds, and its result is discarded) and
the gradients are NaN when the bound underestimates the trip count.
Without one it records UNBOUNDED_CKPT_SLOTS carry checkpoints at stride
ceil(T/K) and recomputes each step from its nearest checkpoint
(~3T + T^2/(2K) replays; eager only, the trip count is read on the
host).
"""

from __future__ import annotations

import warnings

import torch

from ..framework.framework import EMPTY_VAR_NAME
from .registry import register_grad, register_op

# unbounded while_grad: K carry checkpoints bound the body replays by
# ~3T + T^2/(2K), O(T^1.5) up to T = K^2 (the JAX package's K)
UNBOUNDED_CKPT_SLOTS = 64

# test instrumentation: when True, every body application of while_grad
# adds one to BODY_REPLAY_COUNT["n"]
COUNT_BODY_REPLAYS = False
BODY_REPLAY_COUNT = {"n": 0}

_warned_unbounded = False


def capturing(t):
    """Whether `t` lives on the card and its stream is capturing a CUDA
    graph (no host read is allowed then)."""
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def replay_ops(ops, env, rng, device=None):
    """Run `ops` one after another over `env` (var name -> tensor), each
    through its registered lowering; every output is written into `env`,
    which is returned.  A drawing op draws from `rng`, the generator of
    the sub-block op (see the module docstring)."""
    from . import registry

    for op in ops:
        info = registry.get_runtime_info(op.type)
        inputs = {param: [None if n == EMPTY_VAR_NAME else env.get(n)
                          for n in names]
                  for param, names in op.inputs.items()}
        outs = registry.run_forward(info, inputs, op.attrs,
                                    rng=rng if info.stateful else None,
                                    out_names=op.outputs, device=device)
        for param, names in op.outputs.items():
            vals = outs.get(param, [])
            for i, n in enumerate(names):
                if n != EMPTY_VAR_NAME and i < len(vals) \
                        and vals[i] is not None:
                    env[n] = vals[i]
    return env


def private(block, states):
    """`states`, copied when an op of `block` (or of a block nested in it)
    writes its input in place (`in_place` in the registry): the JAX
    package's arrays are immutable, so a sub-block op must not change the
    tensors it was given (two memories seeded by one tensor, the
    InitCarry a while_grad replays from, the inputs a generic grad replays
    the forward on)."""
    if not _writes_in_place(block):
        return list(states)
    return [s.clone() for s in states]


def _writes_in_place(block):
    from . import registry

    for op in block.ops:
        if registry.get_runtime_info(op.type).in_place:
            return True
        sub = op.attrs.get("sub_block")
        if sub is not None and _writes_in_place(sub):
            return True
    return False


def block_draws(block):
    """Whether any op of `block` (or of a block nested in it) draws."""
    from . import registry

    for op in block.ops:
        if registry.get_runtime_info(op.type).stateful \
                and not op.attrs.get("is_test", False):
            sub = op.attrs.get("sub_block")
            if sub is None or block_draws(sub):
                return True
    return False


def needs_host(op):
    """Whether `op` (or an op nested in its sub-block) reads a loop
    condition on the host: a `while` whose trip count the program does not
    fix (`exact_trips`), or a `while_grad` without a trip bound.  Its
    segment cannot be captured."""
    if op.type == "while" and exact_trips(op.attrs) is None:
        return True
    if op.type == "while_grad" and not op.attrs.get("max_steps"):
        return True
    sub = op.attrs.get("sub_block")
    return sub is not None and any(needs_host(o) for o in sub.ops)


def counter_pattern(sub, cond_name):
    """(i's name, limit's name, step, the trips a compare before the
    increment adds) when the body `sub` re-derives the condition by one
    `less_than(i, limit)`, advances `i` by one `increment` of a positive
    step and does not write `limit`; else None."""

    def sole_writer(name, op_type):
        ws = [o for o in sub.ops if name in o.output_arg_names]
        return ws[0] if len(ws) == 1 and ws[0].type == op_type else None

    cmp_op = sole_writer(cond_name, "less_than")
    if cmp_op is None:
        return None
    i_name, lim_name = cmp_op.input("X")[0], cmp_op.input("Y")[0]
    inc = sole_writer(i_name, "increment")
    step = float(inc.attrs.get("step", 1.0)) if inc is not None else 0.0
    if step <= 0 or any(lim_name in o.output_arg_names for o in sub.ops):
        return None
    # a compare before the increment reads the old counter: one trip more
    extra = 1 if sub.ops.index(cmp_op) < sub.ops.index(inc) else 0
    return i_name, lim_name, step, extra


def exact_trips(attrs):
    """The trip count of the `while` with these attrs when the program
    fixes it, else None.  It is fixed for the counter pattern
    (`counter_pattern`, which layers.control_flow._infer_trip_bound also
    reads) with `i` and `limit` last set by `fill_constant`s before the
    loop, integer start, limit and step (a float counter then adds
    without rounding), and the condition entering the loop as
    `less_than(i, limit)` of those values."""
    sub, cond_name = attrs["sub_block"], attrs["cond_name"]
    pat = counter_pattern(sub, cond_name)
    if pat is None:
        return None
    i_name, lim_name, step, extra = pat
    parent = sub.program.block(sub.parent_idx)
    pos = next(k for k, o in enumerate(parent.ops)
               if o.attrs.get("sub_block") is sub)
    before = parent.ops[:pos]

    def last_writer(name):
        ks = [k for k, o in enumerate(before) if name in o.output_arg_names]
        return ks[-1] if ks else -1

    ki, kl, kc = (last_writer(n) for n in (i_name, lim_name, cond_name))
    if min(ki, kl) < 0 or kc < max(ki, kl) \
            or before[ki].type != "fill_constant" \
            or before[kl].type != "fill_constant" \
            or before[kc].type != "less_than" \
            or before[kc].input("X") != [i_name] \
            or before[kc].input("Y") != [lim_name]:
        return None
    i0 = float(before[ki].attrs.get("value", 0.0))
    lim = float(before[kl].attrs.get("value", 0.0))
    if not all(v.is_integer() for v in (i0, lim, step)):
        return None
    if i0 >= lim:
        return 0
    return -(-int(lim - i0) // int(step)) + extra


def _pred(t):
    return t.reshape(())


def _select(pred, new, old):
    return [torch.where(pred, a, b) for a, b in zip(new, old)]


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------


def _while_body(ctx, base_env):
    block = ctx.attr("sub_block")
    carry_names = list(ctx.attr("carry_names"))
    rng = ctx._rng

    def body(carry, caps=None):
        env = dict(base_env)
        if caps:
            env.update(caps)
        env.update(zip(carry_names, carry))
        env = replay_ops(block.ops, env, rng, ctx.device)
        return [env[n] for n in carry_names]

    return body


@register_op("while", stateful=True)
def while_op(ctx):
    """inputs X: the vars the body reads and writes (the condition
    among them).  attrs: sub_block, carry_names (the vars the body writes
    that live outside it, the condition included), cond_name, x_names,
    max_steps (a trip bound or None).  outputs Out: the final carries;
    InitCarry: the carries before the loop, for while_grad."""
    carry_names = list(ctx.attr("carry_names"))
    cond_pos = carry_names.index(ctx.attr("cond_name"))
    base_env = dict(zip(ctx.attr("x_names"), ctx.inputs("X")))
    carry0 = private(ctx.attr("sub_block"),
                     [base_env[n] for n in carry_names])
    body = _while_body(ctx, base_env)
    cond = carry0[cond_pos]
    if cond.device.type == "meta":
        final = carry0      # shape inference: carries keep their shapes
    elif capturing(cond):
        trips = exact_trips(ctx.attrs)
        if trips is None:
            raise RuntimeError(
                "a while whose trip count the program does not fix cannot "
                "run inside a CUDA graph capture: its segment must run "
                "eagerly")
        final = carry0
        for _ in range(trips):
            final = body(final)
    else:
        final = carry0
        while bool(_pred(final[cond_pos])):
            final = body(final)
    ctx.set_outputs("Out", final)
    if ctx.num_outputs("InitCarry"):
        ctx.set_outputs("InitCarry", [base_env[n] for n in carry_names])


def _grad_of_step(body, fmask, ck, gf, caps):
    """The pull-back of one body application at carry `ck`: the
    cotangents of its float carries and of the float captures `caps`,
    given `gf`, the cotangents of its float outputs."""
    with torch.enable_grad():
        leaves = [c.detach().requires_grad_(True) if m else c
                  for c, m in zip(ck, fmask)]
        cap_leaves = {n: v.detach().requires_grad_(True)
                      for n, v in caps.items()}
        outs = [o for o, m in zip(body(leaves, cap_leaves), fmask) if m]
        prims, cots = [], []
        for o, g in zip(outs, gf):
            if o.requires_grad:
                prims.append(o)
                cots.append(g.to(o.dtype))
        flat = [c for c, m in zip(leaves, fmask) if m] \
            + list(cap_leaves.values())
        grads = (torch.autograd.grad(prims, flat, cots, allow_unused=True)
                 if prims else [None] * len(flat))
    grads = [torch.zeros_like(x) if g is None else g.detach()
             for x, g in zip(flat, grads)]
    n = sum(fmask)
    return grads[:n], dict(zip(cap_leaves, grads[n:]))


@register_grad("while")
def while_grad(ctx):
    """The JAX rule (control_flow_ops.py:122-315): replay the body once a
    forward step, pulling the carries' cotangent back through each step in
    reverse and summing the cotangents of the loop-invariant float
    captures.  X@GRAD: d/d(initial carry) for a carry, the summed grad
    for a capture, None otherwise."""
    block = ctx.attr("sub_block")
    carry_names = list(ctx.attr("carry_names"))
    cond_pos = carry_names.index(ctx.attr("cond_name"))
    x_names = list(ctx.attr("x_names"))
    max_steps = ctx.attr("max_steps", None)
    base_env = dict(zip(x_names, ctx.inputs("X")))
    carry0 = list(ctx.inputs("InitCarry"))
    out_grads = list(ctx.inputs("Out@GRAD"))
    fmask = [c.is_floating_point() for c in carry0]
    cap_names = [n for n in x_names if n not in carry_names
                 and base_env[n].is_floating_point()]
    caps0 = {n: base_env[n] for n in cap_names}
    raw = _while_body(ctx, base_env)

    def body(carry, caps=None):
        if COUNT_BODY_REPLAYS:
            BODY_REPLAY_COUNT["n"] += 1
        # a recorded carry is replayed again: the body may not write it
        return raw(private(block, carry), caps)

    gfin = [torch.zeros_like(c) if g is None else g.to(c.dtype)
            for c, m, g in zip(carry0, fmask,
                               out_grads + [None] * len(carry0)) if m]
    gcaps = {n: torch.zeros_like(v) for n, v in caps0.items()}
    g0 = gfin
    if gfin or cap_names:
        if block_draws(block):
            raise NotImplementedError(
                "while_grad: the body of this while draws random values; "
                "its backward replays the body in another order than the "
                "forward and cannot redraw them")

        def pull(ck, gf):
            return _grad_of_step(body, fmask, ck, gf, caps0)

        if max_steps:
            g0, gcaps = _bounded_grad(body, pull, carry0, cond_pos, caps0,
                                      gfin, gcaps, int(max_steps))
        else:
            g0, gcaps = _unbounded_grad(body, pull, carry0, cond_pos, caps0,
                                        gfin, gcaps)
    carry_grads = dict(zip([n for n, m in zip(carry_names, fmask) if m], g0))
    ctx.set_outputs("X@GRAD", [carry_grads.get(n, gcaps.get(n))
                               for n in x_names])


def _bounded_grad(body, pull, carry0, cond_pos, caps0, gfin, gcaps, steps):
    """The JAX package's scan: `steps` predicated steps recorded (a dead
    step replays the last live inputs and is discarded by the select),
    then the reverse pull-back; NaN gradients when the condition still
    holds after them."""
    c = list(carry0)
    cs, preds, live_in = [], [], list(c)
    for _ in range(steps):
        pred = _pred(c[cond_pos])
        live_in = _select(pred, c, live_in)
        cs.append(live_in)
        preds.append(pred)
        c = _select(pred, body(live_in, caps0), c)
    poison = torch.where(_pred(c[cond_pos]),
                         torch.full((), float("nan"), device=c[0].device),
                         torch.ones((), device=c[0].device))
    gf = [g * poison.to(g.dtype) for g in gfin]
    for ck, pred in zip(reversed(cs), reversed(preds)):
        dfl, dcaps = pull(ck, gf)
        gf = _select(pred, dfl, gf)
        gcaps = {n: torch.where(pred, gcaps[n] + dcaps[n], gcaps[n])
                 for n in gcaps}
    return gf, gcaps


def _unbounded_grad(body, pull, carry0, cond_pos, caps0, gfin, gcaps):
    """Checkpointed recompute (eager only: the trip count is read on the
    host): count T, record K checkpoints at stride ceil(T/K), then pull
    back from step T-1 down, each step's carry recomputed from its
    nearest checkpoint."""
    global _warned_unbounded
    if not _warned_unbounded:
        _warned_unbounded = True
        warnings.warn(
            f"while_grad without max_steps: {UNBOUNDED_CKPT_SLOTS}-slot "
            "checkpointed recompute (~3T + T^2/(2K) body replays); set "
            "max_steps on layers.While for O(T) replays, or write the "
            "i < constant pattern, which infers it and also lets a CUDA "
            "graph capture the loop", stacklevel=2)
    k_slots = int(UNBOUNDED_CKPT_SLOTS)
    c, t_total = list(carry0), 0
    while bool(_pred(c[cond_pos])):
        c = body(c, caps0)
        t_total += 1
    seg = max(-(-t_total // k_slots), 1)
    ckpts, c = [], list(carry0)
    for i in range(t_total):
        if i % seg == 0:
            ckpts.append(c)
        c = body(c, caps0)
    gf = gfin
    for k in range(t_total - 1, -1, -1):
        ck = ckpts[k // seg]
        for _ in range(k % seg):
            ck = body(ck, caps0)
        dfl, dcaps = pull(ck, gf)
        gf = dfl
        gcaps = {n: gcaps[n] + dcaps[n] for n in gcaps}
    return gf, gcaps


# ---------------------------------------------------------------------------
# conditional_block
# ---------------------------------------------------------------------------


@register_op("conditional_block", stateful=True)
def conditional_block(ctx):
    """Out: the sub-block's `out_names` when Cond holds, else zeros of
    their shapes (the JAX op :318-346).  inputs X (the vars the block
    reads, `x_names`), Cond (a bool scalar)."""
    block = ctx.attr("sub_block")
    x_names = list(ctx.attr("x_names"))
    out_names = list(ctx.attr("out_names"))
    cond = _pred(ctx.input("Cond"))
    # the block runs whether Cond holds or not (see the module docstring):
    # on zeros of its inputs where it does not, its outputs then zeros
    xs = [torch.where(cond, x, torch.zeros_like(x)) for x in ctx.inputs("X")]
    env = replay_ops(block.ops, dict(zip(x_names, xs)), ctx._rng, ctx.device)
    outs = [torch.where(cond, env[n], torch.zeros_like(env[n]))
            for n in out_names]
    ctx.set_outputs("Out", outs)


# ---------------------------------------------------------------------------
# static_rnn
# ---------------------------------------------------------------------------


@register_op("static_rnn", stateful=True)
def static_rnn(ctx):
    """A loop over the time dim, unrolled (the JAX op's lax.scan, :349).
    inputs X (step-input sequences, time-major [S, ...]), Init (memory
    seeds), Cap (read-only outer vars).  attrs: sub_block, x_names (the
    per-step vars), mem_names, mem_update_names (the vars that hold each
    memory's next value), out_names, cap_names.  outputs Out (each
    out_name stacked over time), LastMem (the final memories)."""
    block = ctx.attr("sub_block")
    x_names = list(ctx.attr("x_names"))
    mem_names = list(ctx.attr("mem_names"))
    upd_names = list(ctx.attr("mem_update_names"))
    out_names = list(ctx.attr("out_names"))
    cap_env = dict(zip(ctx.attr("cap_names", []) or [], ctx.inputs("Cap")))
    seqs = ctx.inputs("X")
    carry = private(block, ctx.inputs("Init"))
    steps = []
    for t in range(seqs[0].shape[0]):
        env = dict(cap_env)
        env.update(zip(mem_names, carry))
        env.update(zip(x_names, [s[t] for s in seqs]))
        env = replay_ops(block.ops, env, ctx._rng, ctx.device)
        carry = [env[n] for n in upd_names]
        steps.append([env[n] for n in out_names])
    ctx.set_outputs("Out", [torch.stack([s[i] for s in steps])
                            for i in range(len(out_names))])
    ctx.set_outputs("LastMem", carry)
