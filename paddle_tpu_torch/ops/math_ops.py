"""Dense math ops: the elementwise family, comparisons and logical ops,
mul, matmul, scale, sum, mean, the reduce family (sum, mean, max, min,
prod), the clip family (clip, clip_by_norm, squared_l2_norm), cumsum,
pow, sign, isfinite/isinf/isnan and the learning-rate schedules
(lr_schedule).

Counterparts of paddle_tpu/ops/math_ops.py (elementwise :36-52, mul :55,
matmul :69, scale :86, sum :98, mean :105, the reduce family :116-139,
clip :142, clip_by_norm :151, squared_l2_norm :160, cumsum :165, pow
:179, sign :185, comparisons and logical ops :190-222, isfinite/isinf/
isnan :225-240, lr_schedule :243).  Their
gradients are the registry's generic ones: autograd over these lowerings
reduces a broadcast Y back to its own shape, as `jax.vjp` does, and
splits a tie of elementwise_max/min evenly, as jnp.maximum's does.  `mul` and
`matmul` stay `torch.matmul`: the JAX package left them to XLA, outside
any Pallas kernel.  A float32 matmul on the card runs in full float32
only while `torch.backends.cuda.matmul.allow_tf32` is False (the PyTorch
default); the port relies on that and never turns it on.

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
_make_elementwise("elementwise_max", torch.maximum)
_make_elementwise("elementwise_min", torch.minimum)
_make_elementwise("elementwise_pow", torch.pow)
_make_elementwise("elementwise_mod", torch.remainder)   # jnp.mod's sign rule
# rounds toward -inf for negative operands, as jnp.floor_divide (not
# truncation); its gradient is zero
_make_elementwise("elementwise_floordiv",
                  functools.partial(torch.div, rounding_mode="floor"))

for _name, _fn in [("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("equal", torch.eq), ("not_equal", torch.ne)]:
    _make_elementwise(_name, _fn, no_grad=True)


def _logical(fn, ctx):
    """X and Y of one shape: no axis broadcast, as the JAX lowerings."""
    ctx.set_output("Out", fn(ctx.input("X"), ctx.input("Y")))


for _name, _fn in [("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)]:
    register_op(_name, no_grad=True)(functools.partial(_logical, _fn))


@register_op("logical_not", no_grad=True)
def logical_not(ctx):
    ctx.set_output("Out", torch.logical_not(ctx.input("X")))


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


@register_op("clip")
def clip(ctx):
    """min(max(X, min), max), the bounds rounded to X's dtype."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.clamp(x, _in_dtype(ctx.attr("min"), x.dtype),
                                      _in_dtype(ctx.attr("max"), x.dtype)))


@register_op("clip_by_norm")
def clip_by_norm(ctx):
    """Out = X * max_norm / max(||X||_2, max_norm) (reference
    clip_by_norm_op.cc); the norm stays a tensor on X's device."""
    x = ctx.input("X")
    max_norm = _in_dtype(ctx.attr("max_norm"), x.dtype)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    ctx.set_output("Out", x * (max_norm / torch.clamp(norm, min=max_norm)))


@register_op("squared_l2_norm")
def squared_l2_norm(ctx):
    """sum(X^2) as shape [1]."""
    ctx.set_output("Out", torch.sum(torch.square(ctx.input("X"))).reshape(1))


@register_op("cumsum")
def cumsum(ctx):
    """Running sum along `axis`; `exclusive` leaves each entry out of its
    own sum, `reverse` sums from the end (the JAX lowering's arithmetic:
    the exclusive form subtracts X from the inclusive sum)."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    exclusive = ctx.attr("exclusive", False)
    if ctx.attr("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, [axis]), dim=axis),
                         [axis])
    else:
        out = torch.cumsum(x, dim=axis)
    if exclusive:
        out = out - x
    ctx.set_output("Out", out.to(x.dtype))


@register_op("pow")
def pow_op(ctx):
    """X ** factor, the factor rounded to X's dtype."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.pow(x, _in_dtype(ctx.attr("factor", 1.0),
                                                 x.dtype)))


def _overflow(reduce, test, ctx):
    """One bool of shape [1] over the whole tensor (reference
    isfinite_op.cc)."""
    ctx.set_output("Out", reduce(test(ctx.input("X"))).reshape(1))


for _name, _reduce_fn, _test in [("isfinite", torch.all, torch.isfinite),
                                 ("isinf", torch.any, torch.isinf),
                                 ("isnan", torch.any, torch.isnan)]:
    register_op(_name, no_grad=True)(
        functools.partial(_overflow, _reduce_fn, _test))


@register_op("sign", no_grad=True)
def sign(ctx):
    ctx.set_output("Out", torch.sign(ctx.input("X")))


def _piecewise(step, bounds, values):
    """values[the count of bounds <= step], selected on the step's device
    (no host read, no host-to-card copy: a captured step replays it)."""
    n = torch.zeros_like(step, dtype=torch.int32)
    for b in bounds:
        n = n + (step >= b).to(torch.int32)
    lr = torch.zeros_like(step)
    for k, v in enumerate(values):
        lr = torch.where(n == k, v, lr)
    return lr


@register_op("lr_schedule", no_grad=True)
def lr_schedule(ctx):
    """A learning-rate schedule as one op over the step counter Step
    (layers/learning_rate_scheduler.py).  Pure tensor arithmetic on the
    counter's device, so a captured training step replays it with the
    counter its `increment` advanced: nothing is read back to the host.
    noam at step 0 is min(inf, 0) = 0, as in the JAX lowering."""
    step = ctx.input("Step").reshape(()).float()
    kind = ctx.attr("kind")
    if kind == "noam":
        d_model = ctx.attr("d_model")
        warmup = ctx.attr("warmup_steps")
        lr = d_model ** -0.5 * torch.minimum(step ** -0.5,
                                             step * warmup ** -1.5)
    elif kind in ("exponential", "natural_exp", "inverse_time"):
        base = ctx.attr("learning_rate")
        rate = ctx.attr("decay_rate")
        div = step / ctx.attr("decay_steps")
        if ctx.attr("staircase", False):
            div = torch.floor(div)
        if kind == "exponential":
            lr = base * torch.pow(rate, div)
        elif kind == "natural_exp":
            lr = base * torch.exp(-rate * div)
        else:
            lr = base / (1.0 + rate * div)
    elif kind == "polynomial":
        base = ctx.attr("learning_rate")
        dsteps = ctx.attr("decay_steps")
        end = ctx.attr("end_learning_rate")
        if ctx.attr("cycle", False):
            dsteps = dsteps * torch.ceil(torch.clamp(step, min=1.0) / dsteps)
            capped = torch.minimum(step, dsteps)
        else:
            capped = torch.clamp(step, max=dsteps)
        lr = ((base - end) * torch.pow(1.0 - capped / dsteps,
                                       ctx.attr("power")) + end)
    elif kind == "piecewise":
        lr = _piecewise(step, ctx.attr("boundaries"), ctx.attr("values"))
    elif kind == "cosine":
        cur_epoch = torch.floor(step / ctx.attr("step_each_epoch"))
        lr = ctx.attr("learning_rate") * 0.5 * (
            torch.cos(cur_epoch * math.pi / ctx.attr("epochs")) + 1.0)
    else:
        raise ValueError(f"unknown lr schedule kind {kind!r}")
    ctx.set_output("Out", lr.reshape(1).float())
