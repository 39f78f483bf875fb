"""Control-flow layers: While, StaticRNN, DynamicRNN, BeamSearchDecoder,
IfElse, increment and the compare helpers (paddle_tpu/layers/
control_flow.py).  Sub-blocks are built as the JAX package builds them
(Program.create_block / rollback) into the same op descs: one `while`,
`static_rnn`, `beam_search_decode` op carrying its sub-block, and a
`select` per IfElse output.  `Print` waits for the `print` op (ROADMAP A
item 8).
"""

from __future__ import annotations

from ..framework.framework import default_main_program
from ..layer_helper import LayerHelper


def _collect_block_io(block):
    """(reads-from-outer, writes) var-name sets for a sub-block."""
    defined = set()
    reads = []
    writes = []
    for op in block.ops:
        for n in op.input_arg_names:
            if n not in defined and n not in reads:
                reads.append(n)
        for n in op.output_arg_names:
            defined.add(n)
            if n not in writes:
                writes.append(n)
    # only names that resolve OUTSIDE the block are true captures
    parent = block.program.block(block.parent_idx)
    outer_reads = [n for n in reads if _resolvable(parent, n)]
    return outer_reads, writes


def _resolvable(block, name):
    blk = block
    while True:
        if name in blk.vars:
            return True
        if blk.parent_idx == -1:
            return False
        blk = blk.program.block(blk.parent_idx)


class While:
    """reference layers/control_flow.py:655.

        i = fluid.layers.zeros(shape=[1], dtype='int64')
        cond = layers.less_than(x=i, y=limit)
        w = While(cond)
        with w.block():
            ...body, must re-assign `cond` via layers.assign...

    Loop-carried state is every outer var the body overwrites; results are
    written back to those vars after the loop (one `while` op).
    """

    def __init__(self, cond, name=None, max_steps=None):
        """max_steps: optional trip-count bound, as in the JAX package it
        guides the gradient only: the forward is exact, whatever the
        bound.  With a bound (given here or inferred from the
        `i < const` / increment pattern) the gradient records every step's
        carry over `max_steps` predicated steps (O(T) replays; NaN
        gradients when the bound is below the trip count); without one it
        uses K-slot checkpointed recompute (K =
        control_flow_ops.UNBOUNDED_CKPT_SLOTS: ~3T + T^2/(2K) body
        replays, and K checkpoints of the carries) and its segment runs
        eagerly on the card.  On the card the loop is captured in a CUDA
        graph only when the program fixes its trip count
        (control_flow_ops.exact_trips: the counter pattern with integer
        constants); any other loop, a hand-set `max_steps` included, runs
        in an eager segment that reads the condition every trip."""
        if cond.shape not in ((1,), ()):
            raise ValueError("While condition must be a bool scalar")
        self.cond_var = cond
        self.max_steps = max_steps
        self.helper = LayerHelper("while", name=name)
        self._block = None

    class _Guard:
        def __init__(self, w):
            self.w = w

        def __enter__(self):
            prog = default_main_program()
            self.w._block = prog.create_block()
            return self.w._block

        def __exit__(self, exc_type, exc_val, exc_tb):
            prog = default_main_program()
            prog.rollback()
            if exc_type is None:
                self.w._complete()
            return False

    def block(self):
        return self._Guard(self)

    def _complete(self):
        sub = self._block
        parent = sub.program.block(sub.parent_idx)
        outer_reads, writes = _collect_block_io(sub)
        cond_name = self.cond_var.name
        if cond_name not in writes:
            raise ValueError(
                "While body must update the condition variable (layers.assign"
                f"(..., {cond_name!r}) or a compare op writing it)"
            )
        # carries: outer vars the body overwrites, condition included — its
        # final (False) value is written back to the scope after the loop,
        # matching the reference's scope-based While
        carry_names = [n for n in writes if _resolvable(parent, n)]
        if cond_name not in carry_names:
            carry_names.append(cond_name)
        x_names = list(dict.fromkeys(outer_reads + carry_names + [cond_name]))
        x_vars = [parent._var_recursive(n) for n in x_names]
        out_vars = [parent._var_recursive(n) for n in carry_names]
        max_steps = self.max_steps
        if max_steps is None:
            max_steps = _infer_trip_bound(parent, sub, cond_name)
        # preserve the pre-loop carry values in fresh vars: the loop writes
        # its carries back in place, so while_grad could not otherwise
        # recover the initial state it must replay from (the reference
        # keeps them alive in step scopes, while_op.cc:101)
        from ..framework import unique_name

        init_vars = [
            parent.create_var(
                name=unique_name.generate(f"{n}@while_init"),
                shape=parent._var_recursive(n).shape,
                dtype=parent._var_recursive(n).dtype,
            )
            for n in carry_names
        ]
        parent.append_op(
            type="while",
            inputs={"X": x_vars},
            outputs={"Out": out_vars, "InitCarry": init_vars},
            attrs={
                "sub_block": sub,
                "carry_names": carry_names,
                "cond_name": cond_name,
                "x_names": x_names,
                "max_steps": max_steps,
            },
            infer_shape=False,
        )


def _infer_trip_bound(parent, sub, cond_name):
    """Static trip-count inference for the canonical counter loop: the
    condition is re-derived by a single `less_than(i, limit)` in the body,
    `i` advances by one `increment` with a constant step, and both i's and
    limit's initial values come from `fill_constant` in the parent block.
    Returns an int bound, or None when the pattern doesn't match."""
    from ..ops.control_flow_ops import counter_pattern

    pat = counter_pattern(sub, cond_name)
    if pat is None:
        return None
    i_name, lim_name, step, extra = pat

    def const_of(name):
        val = None
        for op in parent.ops:
            if name in op.output_arg_names:
                val = (float(op.attrs.get("value", 0.0))
                       if op.type == "fill_constant" else None)
        return val

    i0, lim = const_of(i_name), const_of(lim_name)
    if i0 is None or lim is None:
        return None
    import math

    return max(int(math.ceil((lim - i0) / step)) + extra, 0)


class StaticRNN:
    """reference layers/control_flow.py:429: a fixed-length RNN, one
    `static_rnn` op looping over the time dim.

        rnn = StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)        # x: [B, S, D] batch-major
            h = rnn.memory(shape=[H], batch_ref=xt) | rnn.memory(init=h0)
            new_h = ...layers(xt, h)...
            rnn.update_memory(h, new_h)
            rnn.step_output(new_h)
        out = rnn()                        # [B, S, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._block = None
        self._seq_inputs = []  # (outer var, step var)
        self._memories = []  # (mem step var, init outer var, update step var)
        self._outputs = []  # step vars
        self.seq_len = None
        self._complete_outs = None

    class _Guard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            self.rnn._block = default_main_program().create_block()
            return self.rnn

        def __exit__(self, exc_type, exc_val, exc_tb):
            default_main_program().rollback()
            if exc_type is None:
                self.rnn._complete()
            return False

    def step(self):
        return self._Guard(self)

    def step_input(self, x):
        """x: [B, S, ...] batch-major sequence -> per-step [B, ...] var."""
        if self.seq_len is None:
            self.seq_len = x.shape[1]
        step_shape = (x.shape[0],) + tuple(x.shape[2:])
        v = self._block.create_var(
            name=f"{x.name}@step", shape=step_shape, dtype=x.dtype
        )
        self._seq_inputs.append((x, v))
        return v

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               dtype="float32"):
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory() needs init= or (shape=, batch_ref=)")
            # init creation is deferred to _complete(): it must live in the
            # PARENT block (reference StaticRNN builds the zero-init with
            # fill_constant_batch_size_like on the outer sequence)
            v = self._block.create_var(
                name=self.helper.name + f"@mem{len(self._memories)}",
                shape=(batch_ref.shape[0],) + tuple(shape),
                dtype=dtype,
            )
            self._memories.append([v, ("deferred", batch_ref, list(shape),
                                       float(init_value), dtype), None])
            return v
        v = self._block.create_var(
            name=f"{init.name}@mem", shape=init.shape, dtype=init.dtype
        )
        self._memories.append([v, init, None])
        return v

    def update_memory(self, mem, new_val):
        for m in self._memories:
            if m[0] is mem:
                m[2] = new_val
                return
        raise ValueError("update_memory: unknown memory var")

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        sub = self._block
        parent = sub.program.block(sub.parent_idx)
        for m in self._memories:
            if m[2] is None:
                raise ValueError("every memory needs update_memory()")
        # materialise deferred zero-inits in the parent block
        from . import tensor as tensor_layers

        step_to_outer = {v.name: x for x, v in self._seq_inputs}
        for m in self._memories:
            if isinstance(m[1], tuple) and m[1][0] == "deferred":
                _, batch_ref, shape, value, dtype = m[1]
                outer_ref = step_to_outer.get(batch_ref.name, batch_ref)
                m[1] = tensor_layers.fill_constant_batch_size_like(
                    input=outer_ref, shape=[1] + shape, dtype=dtype,
                    value=value,
                )

        outer_reads, _ = _collect_block_io(sub)
        internal = {v.name for _, v in self._seq_inputs}
        internal |= {m[0].name for m in self._memories}
        cap_names = [n for n in outer_reads if n not in internal]
        helper = self.helper

        # sequences go time-major for the scan
        time_major = []
        from . import nn as nn_layers

        for x, v in self._seq_inputs:
            perm = [1, 0] + list(range(2, len(x.shape)))
            time_major.append(nn_layers.transpose(x, perm=perm))

        out_vars, last_mems = [], []
        for o in self._outputs:
            ov = helper.create_variable_for_type_inference(o.dtype)
            out_vars.append(ov)
        for m in self._memories:
            lm = helper.create_variable_for_type_inference(m[1].dtype)
            last_mems.append(lm)

        parent.append_op(
            type="static_rnn",
            inputs={
                "X": time_major,
                "Init": [m[1] for m in self._memories],
                "Cap": [parent._var_recursive(n) for n in cap_names],
            },
            outputs={"Out": out_vars, "LastMem": last_mems},
            attrs={
                "sub_block": sub,
                "x_names": [v.name for _, v in self._seq_inputs],
                "mem_names": [m[0].name for m in self._memories],
                "mem_update_names": [m[2].name for m in self._memories],
                "out_names": [o.name for o in self._outputs],
                "cap_names": cap_names,
            },
            infer_shape=False,
        )
        # stacked outputs are time-major [S, B, ...] -> back to batch-major
        finals = []
        for ov, o in zip(out_vars, self._outputs):
            ov.shape = (self.seq_len,) + tuple(o.shape or ())
            ov.dtype = o.dtype
            perm = [1, 0] + list(range(2, len(ov.shape)))
            finals.append(nn_layers.transpose(ov, perm=perm))
        self._complete_outs = finals
        self._last_mems = last_mems

    def __call__(self):
        outs = self._complete_outs
        return outs[0] if len(outs) == 1 else outs


class DynamicRNN:
    """Variable-length RNN over padded batches (reference
    layers/control_flow.py:1542 DynamicRNN).

    The reference implementation sorts instances by length descending and
    shrinks the live batch every step (lod_rank_table + shrink_memory,
    data-dependent shapes).  Here: one `static_rnn` over the padded time
    axis with a per-row validity mask: memories freeze and outputs are
    zero once a row's length is exhausted.  No sorting, no dynamic shapes,
    one captured graph per padded length.

        drnn = DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x, seq_len=lens)   # x: [B, T, D]
            h = drnn.memory(shape=[H], batch_ref=xt)
            new_h = ...layers(xt, h)...
            drnn.update_memory(h, new_h)
            drnn.output(new_h)
        out = drnn()          # [B, T, H], zeros past each row's length

    `drnn.last_step(i)` gives output i at each row's final live step (the
    reference's sequence_last_step-over-drnn-output idiom).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._rnn = StaticRNN(name=self.helper.name + "_scan")
        self._seq_len_var = None
        self._mask = None  # [B, 1] float step-validity mask (in-block)

    class _Guard:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            self.d._inner = self.d._rnn.step()
            self.d._inner.__enter__()
            return self.d

        def __exit__(self, exc_type, exc_val, exc_tb):
            return self.d._inner.__exit__(exc_type, exc_val, exc_tb)

    def block(self):
        return self._Guard(self)

    def _ensure_mask(self, batch_ref):
        """Build the in-block [B, 1] mask from a step counter memory and the
        captured lengths var (valid while t < len)."""
        if self._mask is not None or self._seq_len_var is None:
            return
        from . import nn as nn_layers
        from . import tensor as tensor_layers

        # step counter rides as a [B, 1] float memory starting at 0
        t_mem = self._rnn.memory(shape=[1], batch_ref=batch_ref,
                                 init_value=0.0, dtype="float32")
        t_next = nn_layers.scale(t_mem, scale=1.0, bias=1.0)
        self._rnn.update_memory(t_mem, t_next)
        # lengths [B] -> [B, 1] float; capture happens automatically
        lens_f = tensor_layers.cast(
            nn_layers.reshape(self._seq_len_var, shape=[-1, 1]), "float32"
        )
        self._mask = tensor_layers.cast(
            less_than(t_mem, lens_f), "float32"
        )

    def step_input(self, x, seq_len=None, level=0):
        if seq_len is not None:
            if self._seq_len_var is not None and seq_len is not self._seq_len_var:
                raise ValueError("all step_inputs must share one seq_len")
            self._seq_len_var = seq_len
        xt = self._rnn.step_input(x)
        self._ensure_mask(xt)
        return xt

    def static_input(self, x):
        """Non-sequence input visible every step (captured automatically)."""
        return x

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               init_value=0.0, dtype="float32", need_reorder=False):
        v = self._rnn.memory(init=init, shape=shape, batch_ref=batch_ref,
                             init_value=value or init_value, dtype=dtype)
        return v

    def update_memory(self, mem, new_val):
        """Masked update: rows past their length keep the old memory."""
        from . import nn as nn_layers

        if self._mask is not None:
            keep = nn_layers.scale(self._mask, scale=-1.0, bias=1.0)
            new_val = _add(
                _mul(new_val, self._mask), _mul(mem, keep)
            )
        self._rnn.update_memory(mem, new_val)

    def output(self, *outputs):
        for o in outputs:
            masked = _mul(o, self._mask) if self._mask is not None else o
            self._rnn.step_output(masked)

    def last_step(self, i=0):
        """Output i at each row's final valid step: [B, ...]."""
        from .sequence import sequence_last_step

        outs = self._rnn._complete_outs
        return sequence_last_step(outs[i], seq_len=self._seq_len_var)

    def __call__(self):
        return self._rnn()


def _mul(x, y):
    """elementwise_mul with trailing broadcast (y: [B,1] mask)."""
    helper = LayerHelper("elementwise_mul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="elementwise_mul", inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]}, attrs={"axis": 0},
    )
    return out


def _add(x, y):
    helper = LayerHelper("elementwise_add")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="elementwise_add", inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]}, attrs={"axis": 0},
    )
    return out


class BeamSearchDecoder:
    """Whole-decode beam search (reference beam_search_op.cc +
    beam_search_decode_op.cc orchestrated by While; here one
    `beam_search_decode` op, ops/beam_search_ops.py).

        dec = BeamSearchDecoder(beam_size=4, max_len=16, bos_id=0, eos_id=1)
        with dec.block():
            prev = dec.prev_ids()              # [B*K] int64
            logits = ...layers over prev...    # [B*K, V]
            dec.set_logits(logits)
        ids, scores = dec()                    # [B, K, max_len], [B, K]

    Outer vars read inside the block (params, encoder states tiled to B*K)
    are captured automatically.
    """

    def __init__(self, beam_size, max_len, bos_id=0, eos_id=1, batch_size=1,
                 name=None):
        self.beam_size = beam_size
        self.max_len = max_len
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.batch_size = batch_size
        self.helper = LayerHelper("beam_search_decode", name=name)
        self._block = None
        self._ids_var = None
        self._logits_var = None
        self._outs = None
        self._memories = []  # (sub-block state var, init outer var, new var)

    class _Guard:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            self.d._block = default_main_program().create_block()
            return self.d

        def __exit__(self, exc_type, exc_val, exc_tb):
            default_main_program().rollback()
            if exc_type is None:
                self.d._complete()
            return False

    def block(self):
        return self._Guard(self)

    def prev_ids(self):
        self._ids_var = self._block.create_var(
            name=f"{self.helper.name}@prev_ids", shape=(-1,), dtype="int64"
        )
        return self._ids_var

    def memory(self, init):
        """Recurrent decoder state: `init` is the initial value tiled to
        [B*K, ...] in the OUTER block; returns the sub-block var holding
        the previous step's state.  Pair with update_memory — the decode
        scan reorders the state by source beam every step (the
        reference's state_array gather)."""
        shape = init.shape
        if shape:
            # batch-carried state: declare the leading (B*K) dim dynamic so
            # sub-block shape inference sees ONE batch sentinel everywhere
            # (a static init batch against dynamic per-step projections
            # would tear ops like kv_cache_append / fused_attention)
            shape = (-1,) + tuple(shape[1:])
        mem = self._block.create_var(
            name=f"{self.helper.name}@mem{len(self._memories)}",
            shape=shape, dtype=init.dtype,
        )
        self._memories.append([mem, init, None])
        return mem

    def update_memory(self, mem, new_val):
        for entry in self._memories:
            if entry[0] is mem:
                entry[2] = new_val
                return
        raise ValueError("update_memory: unknown memory var")

    def set_logits(self, logits):
        self._logits_var = logits

    def _complete(self):
        if self._ids_var is None or self._logits_var is None:
            raise ValueError("beam decoder block needs prev_ids() and set_logits()")
        sub = self._block
        parent = sub.program.block(sub.parent_idx)
        for mem, init, new in self._memories:
            if new is None:
                raise ValueError(
                    f"beam decoder memory {mem.name!r} has no update_memory"
                )
        state_names = [m[0].name for m in self._memories]
        outer_reads, _ = _collect_block_io(sub)
        skip = {self._ids_var.name, *state_names}
        cap_names = [n for n in outer_reads if n not in skip]
        out = self.helper.create_variable_for_type_inference("int64")
        scores = self.helper.create_variable_for_type_inference("float32")
        parent.append_op(
            type="beam_search_decode",
            inputs={
                "Cap": [parent._var_recursive(n) for n in cap_names],
                "Init": [m[1] for m in self._memories],
            },
            outputs={"Out": [out], "Scores": [scores]},
            attrs={
                "sub_block": sub,
                "ids_name": self._ids_var.name,
                "logits_name": self._logits_var.name,
                "cap_names": cap_names,
                "state_names": state_names,
                "state_update_names": [m[2].name for m in self._memories],
                "beam_size": self.beam_size,
                "max_len": self.max_len,
                "bos_id": self.bos_id,
                "eos_id": self.eos_id,
                "batch_size": self.batch_size,
            },
            infer_shape=False,
        )
        self._outs = (out, scores)

    def __call__(self):
        return self._outs


class IfElse:
    """reference layers/control_flow.py:1412 IfElse — per-ROW branching.

    The reference physically partitions the batch by the condition
    (split_lod_tensor -> run each sub-block on its row subset -> merge),
    which is a data-dependent-shape design.  Here both branches compute
    over the full batch and a per-row `select` merges them, so shapes stay
    static.

        ie = layers.IfElse(cond)          # cond: [B, 1] bool
        with ie.true_block():
            ie.output(f(ie.input(x)))
        with ie.false_block():
            ie.output(g(ie.input(x)))
        (out,) = ie()                     # rows pick their branch
    """

    def __init__(self, cond, name=None):
        self.cond = cond
        self._phase = None
        self._outs = {"true": [], "false": []}

    class _Branch:
        def __init__(self, ie, phase):
            self.ie = ie
            self.phase = phase

        def __enter__(self):
            if self.ie._phase is not None:
                raise RuntimeError("IfElse blocks cannot nest")
            self.ie._phase = self.phase
            return self.ie

        def __exit__(self, exc_type, exc_val, exc_tb):
            self.ie._phase = None
            return False

    def true_block(self):
        return self._Branch(self, "true")

    def false_block(self):
        return self._Branch(self, "false")

    def input(self, x):
        """Full-batch view (the reference returned the row subset)."""
        if self._phase is None:
            raise RuntimeError("IfElse.input() only inside a block")
        return x

    def output(self, *outs):
        if self._phase is None:
            raise RuntimeError("IfElse.output() only inside a block")
        self._outs[self._phase].extend(outs)

    def __call__(self):
        t, f = self._outs["true"], self._outs["false"]
        if len(t) != len(f):
            raise ValueError(
                f"true_block produced {len(t)} outputs, false_block {len(f)}"
            )
        # real select, not mask-multiply: log(x)-style guards produce
        # NaN in the untaken branch, and NaN * 0 = NaN would leak into
        # exactly the rows the guard protects; select also preserves
        # integer/bool output dtypes
        merged = []
        for tv, fv in zip(t, f):
            helper = LayerHelper("select")
            out = helper.create_variable_for_type_inference(tv.dtype)
            helper.append_op(
                type="select",
                inputs={"Condition": [self.cond], "X": [tv], "Y": [fv]},
                outputs={"Out": [out]},
            )
            merged.append(out)
        return merged


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape  # elementwise: consumers still see a shape
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)},
                     infer_shape=False)
    return out


def _compare(op_type, x, y, cond=None):
    """A bool [x.shape] output (`cond`, or a new var that stops
    gradients), without an axis attr, as the JAX helper builds it."""
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool",
                                                         stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]}, infer_shape=False)
    cond.dtype = "bool"
    cond.shape = x.shape
    return cond


def less_than(x, y, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)
