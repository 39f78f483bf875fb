"""Dense math ops: the elementwise family and comparisons, mul, matmul,
scale, sum, mean, and the reduce family (sum, mean, max, min, prod).

Counterparts of paddle_tpu/ops/math_ops.py (elementwise :36-51, mul :55,
matmul :69, scale :86, sum :98, mean :105, the reduce family :116-139,
comparisons :192-205).  Their gradients are the registry's generic ones:
autograd over these lowerings reduces a broadcast Y back to its own
shape, as `jax.vjp` does.  `mul` and `matmul` stay `torch.matmul`: the
JAX package left them to XLA, outside any Pallas kernel.  A float32
matmul on the card runs in full float32 only while
`torch.backends.cuda.matmul.allow_tf32` is False (the PyTorch default);
the port relies on that and never turns it on.

Mixed operand dtypes follow the JAX package's runtime dtypes, not the
VarDescs': `jnp.matmul(x, y, preferred_element_type=x.dtype)` promotes
the operands and returns X's dtype, so under AMP the float32 one-hot of
BERT's position gather times a bfloat16 activation is a float32 product.
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


def _make_elementwise(name, fn, no_grad=False):
    @register_op(name, no_grad=no_grad)
    def _ew(ctx, fn=fn):
        x = ctx.input("X")
        y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
        ctx.set_output("Out", fn(x, y))


_make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_sub", torch.sub)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.div)
_make_elementwise("elementwise_pow", torch.pow)
_make_elementwise("elementwise_mod", torch.remainder)   # jnp.mod's sign rule

for _name, _fn in [("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge)]:
    _make_elementwise(_name, _fn, no_grad=True)


def _matmul(x, y):
    """torch.matmul over the promoted operand dtype, returned in X's dtype
    (jnp.matmul's preferred_element_type=x.dtype)."""
    common = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(common), y.to(common)).to(x.dtype)


@register_op("mul")
def mul(ctx):
    """Flatten X/Y to 2-D at {x,y}_num_col_dims, matmul, reshape to
    X.shape[:xn] + Y.shape[yn:] (reference mul_op.cc)."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    xm = x.reshape(math.prod(x.shape[:xn]), -1)
    ym = y.reshape(math.prod(y.shape[:yn]), -1)
    out = _matmul(xm, ym)
    ctx.set_output("Out", out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:])))


@register_op("matmul")
def matmul(ctx):
    """Batched matmul with transpose_X / transpose_Y flags and alpha; 1-D
    operands get the standard vector promotions (reference
    matmul_op.cc)."""
    x, y = ctx.input("X"), ctx.input("Y")
    if x.dim() > 1 and ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if y.dim() > 1 and ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = _matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * _in_dtype(alpha, out.dtype)
    ctx.set_output("Out", out)


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


def _reduce(fn, ctx):
    """The reduce family's one lowering (math_ops.py:116-139 of the JAX
    package): over `dim` (keep_dim), or over everything with reduce_all; a
    scalar result is kept as shape [1]."""
    x = ctx.input("X")
    dim = ctx.attr("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False):
        out = fn(x, tuple(range(x.dim())), False)
        out = out.reshape((1,) * x.dim()) if keep else out.reshape(1)
    else:
        out = fn(x, tuple(dim), keep)
        if out.dim() == 0:
            out = out.reshape(1)
    ctx.set_output("Out", out)


def _sum(x, dim, keep):
    """Stays in X's dtype, as jnp.sum keeps int32 (torch.sum would widen
    it to int64)."""
    return x.sum(dim=dim, keepdim=keep, dtype=x.dtype)


def _mean(x, dim, keep):
    """A bfloat16 mean sums in float32 and rounds once, as jnp.mean."""
    if x.dtype == torch.bfloat16:
        return x.float().mean(dim=dim, keepdim=keep).to(x.dtype)
    return x.mean(dim=dim, keepdim=keep)


def _prod(x, dim, keep):
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = x.prod(dim=d, keepdim=keep, dtype=x.dtype)
    return x


# amax/amin, not max(dim).values: their backward splits the cotangent
# equally among tied maxima, as jax.vjp of jnp.max does
for _name, _fn in [
    ("reduce_sum", _sum),
    ("reduce_mean", _mean),
    ("reduce_max", lambda x, dim, keep: torch.amax(x, dim=dim, keepdim=keep)),
    ("reduce_min", lambda x, dim, keep: torch.amin(x, dim=dim, keepdim=keep)),
    ("reduce_prod", _prod),
]:
    register_op(_name)(functools.partial(_reduce, _fn))
