"""Activation ops: relu with its Out-based grad
(paddle_tpu/ops/activation_ops.py:18-49, :74)."""

from __future__ import annotations

import torch

from ..framework.framework import grad_var_name
from .registry import register_grad, register_grad_maker, register_op


@register_op("relu")
def relu(ctx):
    ctx.set_output("Out", torch.relu(ctx.input("X")))


@register_grad_maker("relu")
def _relu_grad_maker(op, block, no_grad_set):
    """The grad op reads Out and dOut only, so the pre-activation input dies
    at the end of the forward."""
    x = op.input("X")[0]
    if x in no_grad_set:
        return []
    out = op.output("Out")[0]
    return [{"type": "relu_grad",
             "inputs": {"Out": [out], "Out@GRAD": [grad_var_name(out)]},
             "outputs": {"X@GRAD": [grad_var_name(x)]},
             "attrs": dict(op.attrs)}]


@register_grad("relu")
def relu_grad(ctx):
    out, dout = ctx.input("Out"), ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD", dout * (out > 0).to(dout.dtype))
