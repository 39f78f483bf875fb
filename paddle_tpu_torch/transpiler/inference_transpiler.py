"""Inference transpiler: inference-time rewrites of a Program, as
registered IR passes.

Counterpart of paddle_tpu/transpiler/inference_transpiler.py:45-222.  Each
rewrite is a PatternRewritePass on framework/ir.py's registry:

  - conv_bn_fuse: a frozen batch norm after a conv folds into the conv's
    filter and one per-channel bias add (the weights change);
  - conv_relu_fuse: a relu after a conv rides the conv's fuse_relu attr;
  - fc_fuse: mul + bias add become one `fc` op;
  - rnn_fuse_passes.RNN_FUSE_PASSES: fc + lstm -> fusion_lstm, fc + gru
    -> fusion_gru, sequence_conv + bias add + relu ->
    fusion_seqconv_eltadd_relu, and the attention-LSTM static_rnn ->
    attention_lstm;
  - dropout_strip: dropout leaves the program (or becomes the scale by
    1 - p that its default downgrade_in_infer mode applies at test time).

INFERENCE_PASSES is the JAX package's line-up (its `_inference_passes()`),
in its order.
"""

from __future__ import annotations

import torch

from ..framework.core_types import convert_dtype
from ..framework.framework import Operator
from ..framework.ir import (
    PatternOp,
    PatternRewritePass,
    apply_passes,
    register_pass,
)


def _is_2d(block, name):
    """fc contracts a 2-D W directly; a >2-D mul weight (flattened by
    mul's y_num_col_dims) must not ride the fuse."""
    var = block.vars.get(name)
    return var is not None and var.shape is not None and len(var.shape) == 2


def _is_bias_var(var):
    """An effectively 1-D persistable var (a bias vector)."""
    return (var is not None and getattr(var, "persistable", False)
            and var.shape is not None
            and len([s for s in var.shape if s not in (1,)]) <= 1)


def _is_bias_param(block, name):
    return _is_bias_var(block.vars.get(name))


def _value(scope, name):
    return torch.as_tensor(scope.find_var(name))


@register_pass("conv_bn_fuse")
class ConvBNFusePass(PatternRewritePass):
    """At inference the bn statistics are frozen, so W' = W * scale / std
    and what is left of the bn is one per-channel bias add writing the bn
    op's old output name.

    The fold computes what the JAX pass computes with numpy, in the same
    float32 operations and order (std = sqrt(var + eps), then W * (scale /
    std), then bias - mean * scale / std), on the tensors where the scope
    holds them, so that the folded weights are the JAX package's bit for
    bit.  The new filter replaces the scope's entry: a CUDA graph
    captured before the fold binds the old filter's address, so its
    signature no longer matches and the folded program is captured anew."""

    pattern = [
        PatternOp("conv", type="conv2d", single_consumer_outputs=("Output",)),
        PatternOp("bn", type="batch_norm",
                  inputs={"X": ("conv", "Output")}),
    ]

    def rewrite(self, block, match, scope):
        conv_op, bn_op = match["conv"], match["bn"]
        w_name = conv_op.input("Filter")[0]
        scale = _value(scope, bn_op.input("Scale")[0])
        bias = _value(scope, bn_op.input("Bias")[0])
        mean = _value(scope, bn_op.input("Mean")[0])
        var = _value(scope, bn_op.input("Variance")[0])
        eps = bn_op.attrs.get("epsilon", 1e-5)
        # sqrt of the float32 sum taken in float64 and rounded once: the
        # correctly rounded float32 sqrt that numpy computes (torch's own
        # float32 sqrt on the CPU can be an ulp off)
        std = torch.sqrt((var + eps).double()).to(var.dtype)
        w = _value(scope, w_name)
        scope.set_var(
            w_name, (w * (scale / std)[:, None, None, None]).to(w.dtype))
        bias_name = w_name + "@bn_folded_bias"
        scope.set_var(bias_name, (bias - mean * scale / std).to(w.dtype))
        block.create_var(name=bias_name, shape=(w.shape[0],),
                         dtype=convert_dtype(w.dtype), persistable=True)
        # the conv keeps its name; its output feeds a per-channel bias add
        # that writes the bn op's old output, so downstream is untouched
        return [conv_op,
                _make_add_bias_op(block, conv_op.output("Output")[0],
                                  bias_name, bn_op.output("Y")[0])]


@register_pass("conv_relu_fuse")
class ConvReluFusePass(PatternRewritePass):
    """relu rides the conv op's fuse_relu attr; the conv writes the
    relu's old output."""

    pattern = [
        PatternOp("conv", type="conv2d", single_consumer_outputs=("Output",)),
        PatternOp("relu", type="relu", inputs={"X": ("conv", "Output")}),
    ]

    def rewrite(self, block, match, scope):
        conv_op, relu_op = match["conv"], match["relu"]
        conv_op.attrs["fuse_relu"] = True
        conv_op.outputs["Output"] = [relu_op.output("Out")[0]]
        return [conv_op]


def _fc_mul_gate(block, op):
    # fc's bias adds along the last (column) dim: fuse 2-D [N, size]
    # (x_num_col_dims 1) and the sequence form [B, S, size] (x_num_col_dims
    # 2); the rewrite checks that the add's axis matches the mul's split
    return (int(op.attrs.get("x_num_col_dims", 1) or 1) in (1, 2)
            and int(op.attrs.get("y_num_col_dims", 1) or 1) == 1
            and _is_2d(block, op.input("Y")[0]))


def _fc_add_gate(block, op):
    axis = op.attrs.get("axis")
    return (_is_bias_param(block, op.input("Y")[0])
            and int(axis if axis is not None else -1) in (-1, 1, 2))


@register_pass("fc_fuse")
class FCFusePass(PatternRewritePass):
    """mul(X, W) + elementwise_add(bias) -> one fc op."""

    pattern = [
        PatternOp("mul", type="mul", single_consumer_outputs=("Out",),
                  predicate=_fc_mul_gate),
        PatternOp("add", type="elementwise_add",
                  inputs={"X": ("mul", "Out")}, predicate=_fc_add_gate),
    ]

    def rewrite(self, block, match, scope):
        mul_op, add_op = match["mul"], match["add"]
        ncd = int(mul_op.attrs.get("x_num_col_dims", 1) or 1)
        axis = add_op.attrs.get("axis")
        if int(axis if axis is not None else -1) not in (-1, ncd):
            return None  # the bias does not add along the mul's column dim
        return [Operator(
            block,
            type="fc",
            inputs={
                "Input": [block._var_recursive(mul_op.input("X")[0])],
                "W": [block._var_recursive(mul_op.input("Y")[0])],
                "Bias": [block._var_recursive(add_op.input("Y")[0])],
            },
            outputs={"Out": [block._var_recursive(add_op.output("Out")[0])]},
            attrs={"in_num_col_dims": ncd},
        )]


@register_pass("dropout_strip")
class DropoutStripPass(PatternRewritePass):
    """Take dropout out at inference.  `upscale_in_train` dropout is the
    identity at test time: its consumers read its input instead.  The
    default `downgrade_in_infer` mode scales by (1 - p) at test time, so
    it becomes an explicit scale op."""

    pattern = [PatternOp("drop", type="dropout")]

    def rewrite(self, block, match, scope):
        op = match["drop"]
        src, dst = op.input("X")[0], op.output("Out")[0]
        impl = op.attrs.get("dropout_implementation", "downgrade_in_infer")
        p = float(op.attrs.get("dropout_prob", 0.5))
        if impl == "downgrade_in_infer" and p != 0.0:
            return [Operator(
                block, type="scale",
                inputs={"X": [block._var_recursive(src)]},
                outputs={"Out": [block._var_recursive(dst)]},
                attrs={"scale": 1.0 - p},
            )]
        # rewire only the ops after the dropout: descs are not SSA, so an
        # earlier op reading a var of the same name stays as it is
        idx = block.ops.index(op)
        for later in block.ops[idx + 1:]:
            for param, names in later.inputs.items():
                later.inputs[param] = [src if n == dst else n for n in names]
        return []


def _inference_passes():
    """The reference transpiler's order: the bn fold must see the conv
    before the relu fuse renames the conv's output, and fc_fuse makes the
    fc ops that the RNN fusions anchor on."""
    from .rnn_fuse_passes import RNN_FUSE_PASSES

    return (["conv_bn_fuse", "conv_relu_fuse", "fc_fuse"]
            + list(RNN_FUSE_PASSES) + ["dropout_strip"])


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        """Apply INFERENCE_PASSES to the program, folding weights in
        `scope` (default: the global scope)."""
        from ..framework.scope import global_scope

        scope = scope if scope is not None else global_scope()
        return apply_passes(program, INFERENCE_PASSES, scope=scope)


def _make_add_bias_op(block, x_name, bias_name, out_name):
    return Operator(
        block,
        type="elementwise_add",
        inputs={"X": [block.var(x_name)], "Y": [block.var(bias_name)]},
        outputs={"Out": [block._var_recursive(out_name)]},
        attrs={"axis": 1},
    )


INFERENCE_PASSES = _inference_passes()
