"""Random ops of the ported slices: uniform_random, gaussian_random and
dropout with its grad (paddle_tpu/ops/random_ops.py:20, :44, :77-117).

Stateful ops draw from ctx.rng(), the Executor's `torch.Generator` on the
op's device, reseeded before every run from Program.random_seed and the
scope's run counter (framework/executor.py).  torch cannot reproduce
jax.random's threefry draws, so the values differ from the JAX package's
for the same seed; the distribution and the determinism are the same.
Every draw is in float32; the result is cast to the op's dtype (bfloat16
under AMP).
"""

from __future__ import annotations

import torch

from ..framework.core_types import dtype_to_torch
from ..framework.framework import grad_var_name
from .registry import register_grad_maker, register_op


@register_op("uniform_random", stateful=True)
def uniform_random(ctx):
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = torch.rand(shape, generator=ctx.rng(), dtype=torch.float32,
                   device=ctx.device)
    ctx.set_output("Out", (u * (hi - lo) + lo).to(dtype))


@register_op("gaussian_random", stateful=True, no_grad=True)
def gaussian_random(ctx):
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    n = torch.randn(shape, generator=ctx.rng(), dtype=torch.float32,
                    device=ctx.device)
    ctx.set_output("Out", (n * std + mean).to(dtype))


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
