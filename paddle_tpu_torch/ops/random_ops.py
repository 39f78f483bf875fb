"""Random ops: uniform_random, gaussian_random, their batch_size_like
forms, truncated_gaussian_random, sampling_id, and dropout with its grad
(paddle_tpu/ops/random_ops.py:20-66, :77-117, :124).

Stateful ops draw from ctx.rng(), the Executor's `torch.Generator` on the
op's device, reseeded before every run from Program.random_seed and the
scope's run counter (framework/executor.py), so a captured graph draws
anew at each replay.  torch cannot reproduce jax.random's threefry draws,
so the values differ from the JAX package's for the same seed; the
distribution and the determinism are the same.  Every draw is in float32;
the result is cast to the op's dtype (bfloat16 under AMP).  Shape
inference runs the lowerings on meta tensors with no generator.
"""

from __future__ import annotations

import math

import torch

from ..framework.core_types import dtype_to_torch
from ..framework.framework import grad_var_name
from .registry import register_grad_maker, register_op


def _gen(ctx, device):
    """The op's generator; none while shapes are inferred on meta."""
    return None if torch.device(device).type == "meta" else ctx.rng()


def _shape(ctx):
    """The shape attr; the *_batch_size_like forms take dim
    output_dim_idx from Input's dim input_dim_idx."""
    shape = [int(s) for s in ctx.attr("shape")]
    x = ctx.input("Input")
    if x is not None:
        shape[ctx.attr("output_dim_idx", 0)] = x.shape[
            ctx.attr("input_dim_idx", 0)]
        return shape, x.device
    return shape, ctx.device


def _uniform(ctx):
    shape, device = _shape(ctx)
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = torch.rand(shape, generator=_gen(ctx, device), dtype=torch.float32,
                   device=device)
    ctx.set_output("Out", (u * (hi - lo) + lo).to(dtype))


def _gaussian(ctx):
    shape, device = _shape(ctx)
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    n = torch.randn(shape, generator=_gen(ctx, device), dtype=torch.float32,
                    device=device)
    ctx.set_output("Out", (n * std + mean).to(dtype))


uniform_random = register_op("uniform_random", stateful=True)(_uniform)
uniform_random_batch_size_like = register_op(
    "uniform_random_batch_size_like", stateful=True, no_grad=True)(_uniform)
gaussian_random = register_op("gaussian_random", stateful=True,
                              no_grad=True)(_gaussian)
gaussian_random_batch_size_like = register_op(
    "gaussian_random_batch_size_like", stateful=True,
    no_grad=True)(_gaussian)

# the standard normal's CDF at -2 and 2: a truncated draw maps a uniform
# in between through the inverse CDF (no rejection loop, so a fixed
# number of draws a call)
_PHI_LO = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
_PHI_HI = 1.0 - _PHI_LO


@register_op("truncated_gaussian_random", stateful=True, no_grad=True)
def truncated_gaussian_random(ctx):
    """mean + std * z, z standard normal restricted to [-2, 2]
    (jax.random.truncated_normal(-2, 2)): z = sqrt(2) erfinv(2u - 1) for
    u uniform on [Phi(-2), Phi(2)], clamped against rounding."""
    shape, device = _shape(ctx)
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    u = torch.rand(shape, generator=_gen(ctx, device), dtype=torch.float32,
                   device=device)
    u = u * (_PHI_HI - _PHI_LO) + _PHI_LO
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    ctx.set_output("Out", (z * std + mean).to(dtype))


@register_op("sampling_id", stateful=True, no_grad=True)
def sampling_id(ctx):
    """One int64 id a row of X, drawn with probability X[row, id]
    (reference sampling_id_op.cc): the Gumbel-max draw that
    jax.random.categorical makes over log(X + 1e-20)."""
    x = ctx.input("X")
    u = torch.rand(x.shape, generator=_gen(ctx, x.device),
                   dtype=torch.float32, device=x.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(
        torch.finfo(torch.float32).tiny)))
    ctx.set_output("Out", torch.argmax(
        torch.log(x.float() + 1e-20) + gumbel, dim=-1))


def _weak(value, x):
    """A Python scalar as jnp treats it beside x: rounded to x's dtype (a
    CPU 0-d tensor, which torch passes to a kernel on the card as a
    scalar argument)."""
    return torch.tensor(value, dtype=x.dtype)


@register_op("dropout", stateful=True)
def dropout(ctx):
    """reference dropout_op.cc.  Mask is a real output in X's dtype, so the
    grad multiplies by it and never replays the draw.  Training: keep ~
    Bernoulli(1 - p) from a float32 uniform; the mask is keep, or
    keep / (1 - p) under upscale_in_train (zeros when p == 1).  is_test:
    x * (1 - p) under downgrade_in_infer, x under upscale_in_train, and a
    mask of ones."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        out = x if impl == "upscale_in_train" else x * _weak(1.0 - p, x)
        ctx.set_output("Out", out)
        ctx.set_output("Mask", torch.ones_like(x))
        return
    if x.device.type == "meta":     # shape inference: nothing to draw
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    else:
        keep = torch.rand(x.shape, generator=ctx.rng(), dtype=torch.float32,
                          device=x.device) < 1.0 - p
    if impl == "upscale_in_train":
        mask = (keep.to(x.dtype) / _weak(1.0 - p, x) if p < 1.0
                else torch.zeros_like(x))
    else:
        mask = keep.to(x.dtype)
    ctx.set_output("Out", x * mask)
    ctx.set_output("Mask", mask)


@register_grad_maker("dropout")
def _dropout_grad_maker(op, block, no_grad_set):
    x = op.input("X")[0]
    if x in no_grad_set:
        return []
    return [{
        "type": "dropout_grad",
        "inputs": {"Mask": list(op.output("Mask")),
                   "Out@GRAD": [grad_var_name(op.output("Out")[0])]},
        "outputs": {"X@GRAD": [grad_var_name(x)]},
        "attrs": dict(op.attrs),
    }]


@register_op("dropout_grad", no_grad=True)
def dropout_grad(ctx):
    ctx.set_output("X@GRAD", ctx.input("Out@GRAD") * ctx.input("Mask"))
