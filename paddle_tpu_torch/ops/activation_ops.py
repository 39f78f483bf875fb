"""Activation ops: relu and tanh with their Out-based grads, gelu and
softmax with the generic one (paddle_tpu/ops/activation_ops.py:25-49, :55,
:56, :71, :74, :76, softmax :139)."""

from __future__ import annotations

import torch

from ..framework.framework import grad_var_name
from .registry import register_grad, register_grad_maker, register_op


def _unary(name, fn):
    def _act(ctx, fn=fn):
        ctx.set_output("Out", fn(ctx.input("X"), ctx))

    register_op(name)(_act)


def _out_grad(name, dfn):
    """Out-based gradient: the grad op reads Out and dOut only, so the
    pre-activation input dies at the end of the forward."""

    def _maker(op, block, no_grad_set, name=name):
        x = op.input("X")[0]
        if x in no_grad_set:
            return []
        out = op.output("Out")[0]
        return [{"type": name + "_grad",
                 "inputs": {"Out": [out], "Out@GRAD": [grad_var_name(out)]},
                 "outputs": {"X@GRAD": [grad_var_name(x)]},
                 "attrs": dict(op.attrs)}]

    def _bwd(ctx, dfn=dfn):
        out, dout = ctx.input("Out"), ctx.input("Out@GRAD")
        ctx.set_output("X@GRAD", dfn(out, dout))

    register_grad_maker(name)(_maker)
    register_grad(name)(_bwd)


_unary("relu", lambda x, ctx: torch.relu(x))
_unary("tanh", lambda x, ctx: torch.tanh(x))
# exact erf form by default, the tanh form when `approximate` is set
# (jax.nn.gelu's two forms)
_unary("gelu", lambda x, ctx: torch.nn.functional.gelu(
    x, approximate="tanh" if ctx.attr("approximate", False) else "none"))

_out_grad("relu", lambda out, dout: dout * (out > 0).to(dout.dtype))
_out_grad("tanh", lambda out, dout: dout * (1.0 - out * out))


@register_op("softmax")
def softmax(ctx):
    """Softmax over the last dim, computed in float32 and returned in X's
    dtype."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.softmax(x.float(), dim=-1).to(x.dtype))
