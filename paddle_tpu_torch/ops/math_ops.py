"""Dense math ops: elementwise_add, mul, scale, sum, mean.

Counterparts of paddle_tpu/ops/math_ops.py (elementwise_add :44, mul :55,
scale :86, sum :98, mean :105).  Their gradients are the registry's
generic ones: autograd over these lowerings reduces a broadcast Y back to
its own shape, as `jax.vjp` does.  `mul` stays `torch.matmul`: the JAX package left it to XLA,
outside any Pallas kernel.  A float32 matmul on the card runs in full
float32 only while `torch.backends.cuda.matmul.allow_tf32` is False (the
PyTorch default); the port relies on that and never turns it on.
"""

from __future__ import annotations

import functools
import math

import torch

from .registry import register_op


def _broadcast_y(x, y, axis):
    """Paddle elementwise broadcast: Y's shape matches a contiguous span of
    X's shape starting at `axis`; pad Y with singleton dims around it."""
    if x.dim() == y.dim():
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    new_shape = ((1,) * axis + tuple(y.shape)
                 + (1,) * (x.dim() - axis - y.dim()))
    return y.reshape(new_shape)


@register_op("elementwise_add")
def elementwise_add(ctx):
    x = ctx.input("X")
    y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
    ctx.set_output("Out", x + y)


@register_op("mul")
def mul(ctx):
    """Flatten X/Y to 2-D at {x,y}_num_col_dims, matmul, reshape to
    X.shape[:xn] + Y.shape[yn:] (reference mul_op.cc)."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    xm = x.reshape(math.prod(x.shape[:xn]), -1)
    ym = y.reshape(math.prod(y.shape[:yn]), -1)
    out = torch.matmul(xm, ym)
    ctx.set_output("Out", out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:])))


def _in_dtype(value, dtype):
    """A python scalar rounded to `dtype` on the host, as jnp.asarray(value,
    x.dtype) rounds it; kept a python number so no tensor is staged onto
    the device per call."""
    return torch.tensor(value, dtype=dtype).item()


@register_op("scale")
def scale(ctx):
    """Out = scale * X + bias, or scale * (X + bias)."""
    x = ctx.input("X")
    s = _in_dtype(ctx.attr("scale", 1.0), x.dtype)
    b = _in_dtype(ctx.attr("bias", 0.0), x.dtype)
    if ctx.attr("bias_after_scale", True):
        ctx.set_output("Out", x * s + b)
    else:
        ctx.set_output("Out", (x + b) * s)


@register_op("sum")
def sum_op(ctx):
    """Add N tensors (the backward pass folds multi-consumer grads with it)."""
    xs = [x for x in ctx.inputs("X") if x is not None]
    ctx.set_output("Out", functools.reduce(torch.add, xs))


@register_op("mean")
def mean(ctx):
    """Scalar mean kept as shape [1], accumulated in float32."""
    x = ctx.input("X")
    ctx.set_output("Out", x.float().mean().reshape(1).to(x.dtype))
