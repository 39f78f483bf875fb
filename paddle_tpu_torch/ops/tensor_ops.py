"""Tensor ops of the serving slice: fill_constant, assign_value, reshape,
gather, lookup_table, increment.

Counterparts of paddle_tpu/ops/tensor_ops.py (fill_constant :25,
assign_value :65, reshape :83, gather :229, lookup_table :286,
increment :395).  Integer feeds keep int64 here, where the JAX package
(x64 off) narrows them to int32: values agree, dtypes do not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.core_types import dtype_to_torch
from .registry import register_op


@register_op("fill_constant")
def fill_constant(ctx):
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype, device=ctx.device))


@register_op("assign_value")
def assign_value(ctx):
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    shape = [int(s) for s in ctx.attr("shape")]
    host = np.asarray(ctx.attr("values"))
    out = torch.from_numpy(host).reshape(shape).to(dtype=dtype,
                                                   device=ctx.device)
    ctx.set_output("Out", out)


@register_op("reshape")
def reshape(ctx):
    x = ctx.input("X")
    shape = [int(s) for s in ctx.attr("shape")]
    # paddle: 0 means copy the corresponding input dim
    nd = x.dim()
    shape = ([x.shape[i] if s == 0 else s for i, s in enumerate(shape[:nd])]
             + list(shape[nd:]))
    ctx.set_output("Out", x.reshape(shape))


@register_op("gather")
def gather(ctx):
    x, index = ctx.input("X"), ctx.input("Index")
    ctx.set_output("Out", torch.index_select(x, 0, index.reshape(-1)))


@register_op("lookup_table")
def lookup_table(ctx):
    """Ids [..., 1] -> Out [..., D] (the trailing 1 dropped, decided at
    build time by the embedding layer's strip_trailing_one attr); rows at
    padding_idx come out as zeros."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    flat = ids.reshape(-1)
    out = torch.index_select(w, 0, flat)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx != -1:
        out = torch.where((flat == padding_idx)[:, None],
                          torch.zeros_like(out), out)
    if ctx.attr("strip_trailing_one", ids.shape[-1] == 1):
        lead = tuple(ids.shape[:-1])
    else:
        lead = tuple(ids.shape)
    ctx.set_output("Out", out.reshape(lead + (w.shape[1],)))


@register_op("increment")
def increment(ctx):
    x = ctx.input("X")
    step = torch.tensor(ctx.attr("step", 1.0), dtype=x.dtype).item()
    ctx.set_output("Out", x + step)
