"""RNN fusion passes: unfused projection + recurrence chains rewritten
into the fused recurrent ops.

Counterpart of paddle_tpu/transpiler/rnn_fuse_passes.py (reference
ir/fc_lstm_fuse_pass.cc, fc_gru_fuse_pass.cc,
seqconv_eltadd_relu_fuse_pass.cc, attention_lstm_fuse_pass.cc):

  - fc_lstm_fuse: an fc or mul projection [B, S, D] @ [D, 4H] whose only
    reader is an `lstm` becomes one `fusion_lstm`, the projection bias
    folded into the lstm's (the peephole tail Bias[4H:7H] kept);
  - fc_gru_fuse: the same for `gru` -> `fusion_gru`, when nothing reads
    the gru's BatchGate or BatchResetHiddenPrev;
  - seqconv_eltadd_relu_fuse: sequence_conv + bias add + relu ->
    `fusion_seqconv_eltadd_relu`;
  - attention_lstm_fuse: a `static_rnn` whose step is the additive
    attention LSTM stencil (below) -> one `attention_lstm`, the
    lstm_unit's i, f, o, g gate columns permuted to f, i, o, g.

Folded weights are computed on the tensors where the scope holds them,
in the JAX package's float32 operations, so that they are its values.
Every interior var must have exactly one reader, and the gates refuse
what the fused ops do not model (SeqLen, activations other than the
defaults, a nonzero forget_bias).  A var a fused op no longer writes
leaves the block, so that a later fetch of it fails instead of reading
a stale scope value.
"""

from __future__ import annotations

import math

import torch

from ..framework.core_types import convert_dtype
from ..framework.framework import Operator
from ..framework.ir import Pass, PatternOp, PatternRewritePass, register_pass
from .inference_transpiler import _is_2d, _is_bias_param, _is_bias_var


def _consumers(block, var_name, exclude=()):
    """The ops of `block` that read var_name."""
    ex = {id(o) for o in exclude}
    return [op for op in block.ops
            if id(op) not in ex and var_name in op.input_arg_names]


def _drop_dead_output_vars(block, names):
    for n in names:
        block.vars.pop(n, None)


def _default_act(op, attr_name, default):
    v = op.attr(attr_name, None)
    return v is None or str(v) == default


def _proj_gate_3d(block, op):
    """The projection keeps [B, S, *]: fc with in_num_col_dims 2, or mul
    with x_num_col_dims 2 and a 2-D weight."""
    if op.type == "fc":
        return int(op.attr("in_num_col_dims", 1) or 1) == 2
    return (int(op.attr("x_num_col_dims", 1) or 1) == 2
            and int(op.attr("y_num_col_dims", 1) or 1) == 1
            and _is_2d(block, op.input("Y")[0]))


def _proj_parts(op):
    """(x, w, bias or None) of an fc or mul projection."""
    if op.type == "fc":
        bias = op.input("Bias")[0] if op.inputs.get("Bias") else None
        return op.input("Input")[0], op.input("W")[0], bias
    return op.input("X")[0], op.input("Y")[0], None


def _fold_proj_bias(block, scope, proj_bias, rec_bias, w_name, gates_width):
    """The one Bias the fused op reads: the recurrence bias with the
    projection bias added to its first gates_width entries.  A var name,
    None, or "__missing__" when the values are not in the scope."""
    if proj_bias is None:
        return rec_bias
    if rec_bias is None:
        return proj_bias
    if scope is None or scope.find_var(proj_bias) is None \
            or scope.find_var(rec_bias) is None:
        return "__missing__"
    pb = torch.as_tensor(scope.find_var(proj_bias)).reshape(-1)
    rb = torch.as_tensor(scope.find_var(rec_bias)).reshape(-1).clone()
    rb[:gates_width] += pb[:gates_width].to(rb.device)
    name = w_name + "@rnn_folded_bias"
    scope.set_var(name, rb.to(pb.dtype))
    block.create_var(name=name, shape=(rb.shape[0],),
                     dtype=convert_dtype(pb.dtype), persistable=True)
    return name


class _FCRecurrenceFusePass(PatternRewritePass):
    """fc_lstm_fuse and fc_gru_fuse: an fc/mul projection whose only reader
    is the recurrence op, the biases folded, one fused op.  Subclasses set
    the fused type, the gate multiple and the outputs."""

    fused_type = None
    gate_mult = None

    def _outputs(self, block, match):
        raise NotImplementedError

    def _extra_attrs(self, block, rec_op, hidden):
        return {}

    def rewrite(self, block, match, scope):
        proj, rec = match["proj"], match["rec"]
        x_name, w_name, proj_bias = _proj_parts(proj)
        hidden_w = rec.input("Weight")[0]
        rec_bias = rec.input("Bias")[0] if rec.inputs.get("Bias") else None
        w_var = block.vars.get(hidden_w)
        if w_var is None or w_var.shape is None:
            return None
        hidden = int(w_var.shape[0])
        bias = _fold_proj_bias(block, scope, proj_bias, rec_bias, w_name,
                               self.gate_mult * hidden)
        if bias == "__missing__":
            return None
        inputs = {
            "X": [block._var_recursive(x_name)],
            "WeightX": [block._var_recursive(w_name)],
            "WeightH": [block._var_recursive(hidden_w)],
        }
        if bias is not None:
            inputs["Bias"] = [block._var_recursive(bias)]
        for init in ("H0", "C0"):
            if rec.inputs.get(init):
                inputs[init] = [block._var_recursive(rec.input(init)[0])]
        outputs = self._outputs(block, match)
        # XX (the projection with the folded bias) gets a var of its own:
        # its value is not the old projection output's
        out_var = block.vars.get(proj.output("Out")[0])
        xx_name = w_name + "@xx"
        block.create_var(name=xx_name, shape=None,
                         dtype=str(out_var.dtype) if out_var is not None
                         else "float32")
        outputs["XX"] = [block.var(xx_name)]
        _drop_dead_output_vars(block, [proj.output("Out")[0]])
        attrs = {"is_reverse": bool(rec.attr("is_reverse", False))}
        attrs.update(self._extra_attrs(block, rec, hidden))
        return [Operator(block, type=self.fused_type, inputs=inputs,
                         outputs=outputs, attrs=attrs)]


def _lstm_gate(block, op):
    """fusion_lstm models the dense lstm with the default activations."""
    return (not op.inputs.get("SeqLen")
            and _default_act(op, "gate_activation", "sigmoid")
            and _default_act(op, "cell_activation", "tanh")
            and _default_act(op, "candidate_activation", "tanh"))


@register_pass("fc_lstm_fuse")
class FCLstmFusePass(_FCRecurrenceFusePass):
    """fc/mul projection + lstm -> fusion_lstm."""

    fused_type = "fusion_lstm"
    gate_mult = 4

    pattern = [
        PatternOp("proj", type=("fc", "mul"),
                  single_consumer_outputs=("Out",), predicate=_proj_gate_3d),
        PatternOp("rec", type="lstm", inputs={"Input": ("proj", "Out")},
                  predicate=_lstm_gate),
    ]

    def _outputs(self, block, match):
        rec = match["rec"]
        return {
            "Hidden": [block._var_recursive(rec.output("Hidden")[0])],
            "Cell": [block._var_recursive(rec.output("Cell")[0])],
        }

    def _extra_attrs(self, block, rec_op, hidden):
        # lstm ignores use_peepholes when its bias is shorter than 7H, and
        # fusion_lstm would raise: carry the claim only where it holds
        peep = bool(rec_op.attr("use_peepholes", False))
        if peep:
            b = (block.vars.get(rec_op.input("Bias")[0])
                 if rec_op.inputs.get("Bias") else None)
            size = (math.prod(int(s) for s in b.shape)
                    if b is not None and b.shape is not None else 0)
            peep = size >= 7 * hidden
        return {"use_peepholes": peep}


def _gru_gate(block, op):
    return (not op.inputs.get("SeqLen")
            and _default_act(op, "gate_activation", "sigmoid")
            and _default_act(op, "activation", "tanh"))


@register_pass("fc_gru_fuse")
class FCGruFusePass(_FCRecurrenceFusePass):
    """fc/mul projection + gru -> fusion_gru, when the gru's training-only
    outputs (BatchGate, BatchResetHiddenPrev) have no reader."""

    fused_type = "fusion_gru"
    gate_mult = 3

    pattern = [
        PatternOp("proj", type=("fc", "mul"),
                  single_consumer_outputs=("Out",), predicate=_proj_gate_3d),
        PatternOp("rec", type="gru", inputs={"Input": ("proj", "Out")},
                  predicate=_gru_gate),
    ]

    def rewrite(self, block, match, scope):
        rec = match["rec"]
        dead = []
        for param in ("BatchGate", "BatchResetHiddenPrev"):
            outs = rec.outputs.get(param) or []
            if outs and _consumers(block, outs[0], exclude=(rec,)):
                return None
            dead += outs
        ops = super().rewrite(block, match, scope)
        if ops is not None:
            _drop_dead_output_vars(block, dead)
        return ops

    def _outputs(self, block, match):
        rec = match["rec"]
        return {"Hidden": [block._var_recursive(rec.output("Hidden")[0])]}


def _seqconv_gate(block, op):
    # no SeqLen: the fused op masks after the relu, where the unfused
    # chain leaves relu(bias) on padded rows
    return (int(op.attr("contextStride", 1) or 1) == 1
            and not op.inputs.get("SeqLen"))


def _eltadd_bias_gate(block, op):
    axis = op.attr("axis")
    return (_is_bias_param(block, op.input("Y")[0])
            and int(axis if axis is not None else -1) in (-1, 2))


@register_pass("seqconv_eltadd_relu_fuse")
class SeqConvEltAddReluFusePass(PatternRewritePass):
    """sequence_conv + elementwise_add(bias) + relu ->
    fusion_seqconv_eltadd_relu."""

    pattern = [
        PatternOp("conv", type="sequence_conv",
                  single_consumer_outputs=("Out",),
                  predicate=_seqconv_gate),
        PatternOp("add", type="elementwise_add",
                  inputs={"X": ("conv", "Out")},
                  single_consumer_outputs=("Out",),
                  predicate=_eltadd_bias_gate),
        PatternOp("relu", type="relu", inputs={"X": ("add", "Out")}),
    ]

    def rewrite(self, block, match, scope):
        conv, add, relu = match["conv"], match["add"], match["relu"]
        cl = int(conv.attr("contextLength", 3))
        start = conv.attr("contextStart", None)
        start = int(start) if start is not None else -((cl - 1) // 2)
        colmat = conv.output("Out")[0] + "@colmat"
        out_var = block.vars.get(relu.output("Out")[0])
        block.create_var(name=colmat, shape=None,
                         dtype=str(out_var.dtype) if out_var is not None
                         else "float32")
        op = Operator(
            block, type="fusion_seqconv_eltadd_relu",
            inputs={
                "X": [block._var_recursive(conv.input("X")[0])],
                "Filter": [block._var_recursive(conv.input("Filter")[0])],
                "Bias": [block._var_recursive(add.input("Y")[0])],
            },
            outputs={"Out": [block._var_recursive(relu.output("Out")[0])],
                     "ColMat": [block.var(colmat)]},
            attrs={"contextLength": cl, "contextStart": start,
                   "contextStride": 1},
        )
        _drop_dead_output_vars(
            block, [conv.output("Out")[0], add.output("Out")[0]])
        return [op]


def _producer(block, var_name):
    """The last op of `block` that writes var_name, or None."""
    hit = None
    for op in block.ops:
        if var_name in op.output_arg_names:
            hit = op
    return hit


def _is_bias_param_rec(block, name):
    """_is_bias_param through the parent blocks (a sub-block reads the
    parameters of its parent)."""
    try:
        var = block._var_recursive(name)
    except ValueError:
        return False
    return _is_bias_var(var)


def _single(names):
    return names[0] if names and len(names) == 1 else None


def _perm_ifog_to_fiog(w):
    """lstm_unit's i, f, o, g gate columns -> attention_lstm's f, i, o, g."""
    i, f, o, g = w.chunk(4, dim=-1)
    return torch.cat([f, i, o, g], dim=-1)


def _axis(op, default=-1):
    v = op.attr("axis")     # not `or -1`: 0 is an axis
    return int(v if v is not None else default)


@register_pass("attention_lstm_fuse")
class AttentionLstmFusePass(Pass):
    """A static_rnn whose step computes

        score  = relu(atted_x + c @ aw_c)        # atted_x = X @ aw_x
        alpha  = softmax(score)
        pooled = alpha @ X
        gates  = concat([h, pooled]) @ W + b
        h, c   = lstm_unit(gates, c)             # forget_bias == 0

    becomes one attention_lstm: AttentionWeight is vstack(aw_x, aw_c), W
    and b have their gate columns permuted to f, i, o, g."""

    def apply(self, program, scope=None):
        changed = False
        for block in list(program.blocks):
            for op in list(block.ops):
                if op.type == "static_rnn" \
                        and self._try_fuse(block, op, scope):
                    changed = True
        if changed:
            program._bump_version()
        return program

    def _match(self, block, rnn_op):
        attrs = rnn_op.attrs
        sub = attrs.get("sub_block")
        mems = list(attrs.get("mem_names") or [])
        updates = list(attrs.get("mem_update_names") or [])
        outs = list(attrs.get("out_names") or [])
        caps = set(attrs.get("cap_names") or [])
        if sub is None or len(mems) != 2 or len(outs) != 1:
            return None
        units = [o for o in sub.ops if o.type == "lstm_unit"]
        if len(units) != 1:
            return None
        unit = units[0]
        if float(unit.attr("forget_bias", 0.0) or 0.0) != 0.0:
            return None
        c_mem = _single(unit.input("C_prev"))
        if c_mem not in mems:
            return None
        h_mem = next(n for n in mems if n != c_mem)
        # the carry is exactly (h <- unit.H, c <- unit.C), the one step
        # output unit.H
        carry = dict(zip(mems, updates))
        if (carry.get(h_mem) != _single(unit.output("H"))
                or carry.get(c_mem) != _single(unit.output("C"))
                or outs[0] != _single(unit.output("H"))):
            return None

        def prod(name):
            return _producer(sub, name) if name else None

        gate_add = prod(_single(unit.input("X")))
        if (gate_add is None or gate_add.type != "elementwise_add"
                or not _is_bias_param_rec(sub, gate_add.input("Y")[0])
                or _axis(gate_add) not in (-1, 1)):
            return None
        gate_mul = prod(_single(gate_add.input("X")))
        if gate_mul is None or gate_mul.type != "mul":
            return None
        cat = prod(_single(gate_mul.input("X")))
        if (cat is None or cat.type != "concat"
                or len(cat.input("X")) != 2
                or cat.input("X")[0] != h_mem
                or int(cat.attr("axis", 1) or 1) != 1):
            return None
        # pooled = reshape(matmul(reshape(alpha), X))
        rs2 = prod(cat.input("X")[1])
        if rs2 is None or rs2.type != "reshape":
            return None
        mm = prod(_single(rs2.input("X")))
        if (mm is None or mm.type != "matmul"
                or bool(mm.attr("transpose_X", False))
                or bool(mm.attr("transpose_Y", False))):
            return None
        x_cap = _single(mm.input("Y"))
        if x_cap not in caps:
            return None
        rs1 = prod(_single(mm.input("X")))
        if rs1 is None or rs1.type != "reshape":
            return None
        sm = prod(_single(rs1.input("X")))
        if sm is None or sm.type != "softmax" or _axis(sm) != -1:
            return None
        rl = prod(_single(sm.input("X")))
        if rl is None or rl.type != "relu":
            return None
        score_add = prod(_single(rl.input("X")))
        if (score_add is None or score_add.type != "elementwise_add"
                or _axis(score_add) != 0):
            return None
        atted_cap = _single(score_add.input("X"))
        if atted_cap not in caps:
            return None
        score_mul = prod(_single(score_add.input("Y")))
        if (score_mul is None or score_mul.type != "mul"
                or _single(score_mul.input("X")) != c_mem):
            return None
        return {
            "x_cap": x_cap, "atted_cap": atted_cap,
            "aw_c": _single(score_mul.input("Y")),
            "w_lstm": _single(gate_mul.input("Y")),
            "b_lstm": _single(gate_add.input("Y")),
            "h_mem": h_mem, "c_mem": c_mem,
        }

    def _try_fuse(self, block, rnn_op, scope):
        m = self._match(block, rnn_op)
        if m is None or scope is None:
            return False
        # in the parent: atted_x = reshape(mul(X, aw_x, x_num_col_dims=2))
        atted_rs = _producer(block, m["atted_cap"])
        if atted_rs is None or atted_rs.type != "reshape":
            return False
        atted_mul = _producer(block, _single(atted_rs.input("X")))
        if (atted_mul is None or atted_mul.type != "mul"
                or int(atted_mul.attr("x_num_col_dims", 1) or 1) != 2
                or _single(atted_mul.input("X")) != m["x_cap"]):
            return False
        aw_x = _single(atted_mul.input("Y"))
        # the time-major Out feeds exactly one [1, 0, 2] transpose back to
        # batch-major, which the fused Hidden replaces; LastMem is dead
        out_tm = rnn_op.output("Out")[0]
        out_consumers = _consumers(block, out_tm, exclude=(rnn_op,))
        if len(out_consumers) != 1 or out_consumers[0].type != "transpose":
            return False
        out_tr = out_consumers[0]
        if list(out_tr.attr("axis", []) or []) != [1, 0, 2]:
            return False
        for n in rnn_op.outputs.get("LastMem") or []:
            if _consumers(block, n, exclude=(rnn_op,)):
                return False
        init_by_mem = dict(zip(rnn_op.attrs["mem_names"],
                               rnn_op.input("Init")))
        vals = {}
        for key, name in (("aw_c", m["aw_c"]), ("w_lstm", m["w_lstm"]),
                          ("b_lstm", m["b_lstm"]), ("aw_x", aw_x)):
            v = scope.find_var(name)
            if v is None:
                return False
            vals[key] = torch.as_tensor(v)
        w = vals["w_lstm"]
        aw = torch.cat([vals["aw_x"], vals["aw_c"].to(vals["aw_x"].device)])
        lw = _perm_ifog_to_fiog(w)
        lb = _perm_ifog_to_fiog(vals["b_lstm"].reshape(1, -1)).reshape(-1)
        names = {}
        for key, arr in (("att_w", aw), ("lstm_w", lw), ("lstm_b", lb)):
            name = m["w_lstm"] + f"@{key}"
            scope.set_var(name, arr.to(w.dtype))
            block.create_var(name=name, shape=tuple(arr.shape),
                             dtype=convert_dtype(arr.dtype), persistable=True)
            names[key] = name
        cell = block.create_var(name=out_tr.output("Out")[0] + "@cell",
                                shape=None, dtype="float32")
        fused = Operator(
            block, type="attention_lstm",
            inputs={
                "X": [block._var_recursive(m["x_cap"])],
                "H0": [block._var_recursive(init_by_mem[m["h_mem"]])],
                "C0": [block._var_recursive(init_by_mem[m["c_mem"]])],
                "AttentionWeight": [block.var(names["att_w"])],
                "LSTMWeight": [block.var(names["lstm_w"])],
                "LSTMBias": [block.var(names["lstm_b"])],
            },
            outputs={"Hidden": [block._var_recursive(out_tr.output("Out")[0])],
                     "Cell": [cell]},
            attrs={},
        )
        # the fused op replaces the static_rnn; the out transpose, the feed
        # transpose to time-major and the atted_x chain (the fused op
        # computes it from X and AttentionWeight) go where nothing else
        # reads them
        x_tm = rnn_op.input("X")[0]
        drop = {id(rnn_op), id(out_tr)}
        dead_vars = [out_tm] + list(rnn_op.outputs.get("LastMem") or [])
        x_tm_prod = _producer(block, x_tm)
        if (x_tm_prod is not None and x_tm_prod.type == "transpose"
                and not _consumers(block, x_tm, exclude=(rnn_op,))):
            drop.add(id(x_tm_prod))
            dead_vars.append(x_tm)
        if not _consumers(block, m["atted_cap"], exclude=(rnn_op,)):
            drop.add(id(atted_rs))
            dead_vars.append(m["atted_cap"])
            mul_out = _single(atted_rs.input("X"))
            if not _consumers(block, mul_out, exclude=(atted_rs,)):
                drop.add(id(atted_mul))
                dead_vars.append(mul_out)
        block.ops = [fused if id(op) == id(rnn_op) else op
                     for op in block.ops
                     if id(op) == id(rnn_op) or id(op) not in drop]
        _drop_dead_output_vars(block, dead_vars)
        return True


# the RNN slice of the InferenceTranspiler's line-up, after fc_fuse (whose
# fc ops these patterns anchor on)
RNN_FUSE_PASSES = ["fc_lstm_fuse", "fc_gru_fuse", "seqconv_eltadd_relu_fuse",
                   "attention_lstm_fuse"]
