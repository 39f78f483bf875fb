"""Random ops of the ported slices: uniform_random and gaussian_random
(paddle_tpu/ops/random_ops.py:20, :44).

Stateful ops draw from ctx.rng(), a `torch.Generator` on the op's device
that the Executor seeds from Program.random_seed.  torch cannot reproduce
jax.random's threefry draws, so the values differ from the JAX package's
for the same seed; the distribution and the determinism are the same.
Both draw in float32 and cast to the op's dtype (bfloat16 under AMP).
"""

from __future__ import annotations

import torch

from ..framework.core_types import dtype_to_torch
from .registry import register_op


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
