"""Activation ops: the JAX package's 35 activation op types
(paddle_tpu/ops/activation_ops.py:52-173).  relu, sigmoid, tanh, sqrt and
relu6 have Out-based grads (:72-81); every other op takes the registry's
generic grad.  Attributes keep Fluid's defaults, not torch's (leaky_relu's
alpha 0.02, brelu's t_max 24, soft_relu's threshold 40, stanh's 2/3 and
1.7159), and a scalar attribute meets X as `jnp.asarray(v, x.dtype)`
does: rounded to X's dtype first."""

from __future__ import annotations

import torch

from ..framework.framework import grad_var_name
from .math_ops import _in_dtype
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
        ctx.set_output("X@GRAD", dfn(out, dout, ctx))

    register_grad_maker(name)(_maker)
    register_grad(name)(_bwd)


def _attr(ctx, name, default, x):
    """Attribute `name` as a python number rounded to X's dtype."""
    return _in_dtype(ctx.attr(name, default), x.dtype)


def _softplus(x):
    """jax.nn.softplus, logaddexp(x, 0): no switch to x above a
    threshold, as torch's F.softplus has."""
    return torch.logaddexp(x, x.new_zeros(()))


_unary("sigmoid", lambda x, ctx: torch.sigmoid(x))
_unary("logsigmoid", lambda x, ctx: -_softplus(-x))
_unary("exp", lambda x, ctx: torch.exp(x))
_unary("relu", lambda x, ctx: torch.relu(x))
_unary("tanh", lambda x, ctx: torch.tanh(x))
_unary("tanh_shrink", lambda x, ctx: x - torch.tanh(x))
_unary("sqrt", lambda x, ctx: torch.sqrt(x))
_unary("rsqrt", lambda x, ctx: torch.rsqrt(x))
_unary("abs", lambda x, ctx: torch.abs(x))
_unary("ceil", lambda x, ctx: torch.ceil(x))
_unary("floor", lambda x, ctx: torch.floor(x))
_unary("round", lambda x, ctx: torch.round(x))   # half to even, as jnp
_unary("cos", lambda x, ctx: torch.cos(x))
_unary("sin", lambda x, ctx: torch.sin(x))
_unary("reciprocal", lambda x, ctx: 1.0 / x)
_unary("log", lambda x, ctx: torch.log(x))
_unary("square", lambda x, ctx: torch.square(x))
_unary("softplus", lambda x, ctx: _softplus(x))
_unary("softsign", lambda x, ctx: x / (1.0 + torch.abs(x)))
# exact erf form by default, the tanh form when `approximate` is set
# (jax.nn.gelu's two forms)
_unary("gelu", lambda x, ctx: torch.nn.functional.gelu(
    x, approximate="tanh" if ctx.attr("approximate", False) else "none"))
_unary("relu6", lambda x, ctx: torch.clamp(x, 0.0,
                                           ctx.attr("threshold", 6.0)))

_out_grad("relu", lambda out, dout, ctx: dout * (out > 0).to(dout.dtype))
_out_grad("sigmoid", lambda out, dout, ctx: dout * out * (1.0 - out))
_out_grad("tanh", lambda out, dout, ctx: dout * (1.0 - out * out))
_out_grad("sqrt", lambda out, dout, ctx: dout * 0.5 / out)
_out_grad("relu6", lambda out, dout, ctx: dout * (
    (out > 0) & (out < ctx.attr("threshold", 6.0))).to(dout.dtype))

# the x >= 0 branch at 0, as the JAX lowerings take it
_unary("leaky_relu", lambda x, ctx: torch.where(
    x >= 0, x, x * _attr(ctx, "alpha", 0.02, x)))
_unary("elu", lambda x, ctx: torch.where(
    x >= 0, x, _attr(ctx, "alpha", 1.0, x) * (torch.exp(x) - 1.0)))
_unary("brelu", lambda x, ctx: torch.clamp(
    x, ctx.attr("t_min", 0.0), ctx.attr("t_max", 24.0)))
_unary("soft_relu", lambda x, ctx: torch.log1p(torch.exp(torch.clamp(
    x, -ctx.attr("threshold", 40.0), ctx.attr("threshold", 40.0)))))
_unary("stanh", lambda x, ctx: _attr(ctx, "scale_b", 1.7159, x) * torch.tanh(
    _attr(ctx, "scale_a", 2.0 / 3.0, x) * x))
_unary("hard_sigmoid", lambda x, ctx: torch.clamp(
    _attr(ctx, "slope", 0.2, x) * x + _attr(ctx, "offset", 0.5, x),
    0.0, 1.0))
_unary("thresholded_relu", lambda x, ctx: torch.where(
    x > ctx.attr("threshold", 1.0), x, torch.zeros_like(x)))
_unary("hard_shrink", lambda x, ctx: torch.where(
    torch.abs(x) > ctx.attr("threshold", 0.5), x, torch.zeros_like(x)))
_unary("softshrink", lambda x, ctx: torch.sign(x) * torch.relu(
    torch.abs(x) - _attr(ctx, "lambda", 0.5, x)))
_unary("swish", lambda x, ctx: x * torch.sigmoid(
    _attr(ctx, "beta", 1.0, x) * x))


@register_op("softmax")
def softmax(ctx):
    """Softmax over the last dim, computed in float32 and returned in X's
    dtype."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.softmax(x.float(), dim=-1).to(x.dtype))


@register_op("log_softmax")
def log_softmax(ctx):
    """Over `axis`, in X's dtype."""
    ctx.set_output("Out", torch.log_softmax(ctx.input("X"),
                                            dim=ctx.attr("axis", -1)))


@register_op("maxout")
def maxout(ctx):
    """NCHW channel groups: (n, c // g, g, h, w), the max over the g
    consecutive channels of each group (amax: tied maxima share the grad,
    as jax.vjp of jnp.max)."""
    x = ctx.input("X")
    g = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out", torch.amax(x.reshape(n, c // g, g, h, w), dim=2))


@register_op("prelu")
def prelu(ctx):
    """x where x >= 0, else Alpha * x; Alpha one value ("all"), one a
    channel ("channel") or one an element of a sample ("element")."""
    x, alpha = ctx.input("X"), ctx.input("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:   # element
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    ctx.set_output("Out", torch.where(x >= 0, x, a * x))
