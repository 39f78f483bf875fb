"""Tensor ops: fill_constant, fill_constant_batch_size_like, assign,
assign_value, cast, reshape, concat, slice, gather, one_hot, top_k,
lookup_table (with its hand-written grad), increment.

Counterparts of paddle_tpu/ops/tensor_ops.py (fill_constant :25,
fill_constant_batch_size_like :42, assign :60, assign_value :65, cast
:78, reshape :83, concat :118, slice :138, gather :229, one_hot :242,
top_k :254, lookup_table :286, lookup_table_grad :311-342, increment
:395).  Shape inference and grads are the registry's generic ones (a
meta-tensor run; an autograd replay).  Integer
feeds keep int64 here, where the JAX package (x64 off) narrows them to
int32: values agree, dtypes do not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.core_types import dtype_to_torch
from ..framework.framework import grad_var_name
from .registry import register_grad_maker, register_op


@register_op("fill_constant")
def fill_constant(ctx):
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype, device=ctx.device))


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ctx):
    """The shape attr with dim output_dim_idx taken from Input's dim
    input_dim_idx (its batch size)."""
    x = ctx.input("Input")
    shape = [int(s) for s in ctx.attr("shape")]
    shape[ctx.attr("output_dim_idx", 0)] = x.shape[ctx.attr("input_dim_idx",
                                                            0)]
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype, device=x.device))


@register_op("assign")
def assign(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("assign_value")
def assign_value(ctx):
    """The constant, staged from the host once per op and device (kept in
    the op's `_`-prefixed scratch attrs, which the desc leaves out) and
    cloned at each run: a CUDA graph capture cannot hold a copy from
    pageable host memory, and the eager warm-up before it stages the
    constant."""
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    key = f"_staged_{ctx.device}"
    staged = ctx.attrs.get(key)
    if staged is None or staged.dtype != dtype:
        host = np.asarray(ctx.attr("values"))
        shape = [int(s) for s in ctx.attr("shape")]
        staged = ctx.attrs[key] = torch.from_numpy(host).reshape(shape).to(
            dtype=dtype, device=ctx.device)
    ctx.set_output("Out", staged.clone())


@register_op("cast")
def cast(ctx):
    ctx.set_output("Out", ctx.input("X").to(dtype_to_torch(
        ctx.attr("out_dtype"))))


@register_op("reshape")
def reshape(ctx):
    x = ctx.input("X")
    shape = [int(s) for s in ctx.attr("shape")]
    # paddle: 0 means copy the corresponding input dim
    nd = x.dim()
    shape = ([x.shape[i] if s == 0 else s for i, s in enumerate(shape[:nd])]
             + list(shape[nd:]))
    ctx.set_output("Out", x.reshape(shape))


@register_op("concat")
def concat(ctx):
    """The X list joined along `axis`; absent inputs are skipped."""
    xs = [x for x in ctx.inputs("X") if x is not None]
    ctx.set_output("Out", torch.cat(xs, dim=ctx.attr("axis", 0)))


@register_op("slice")
def slice_op(ctx):
    """Input[starts:ends] along `axes`; a negative bound counts from the
    end, and bounds are clamped into [0, dim]."""
    x = ctx.input("Input")
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"),
                          ctx.attr("ends")):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(st, en)
    ctx.set_output("Out", x[tuple(idx)])


@register_op("gather")
def gather(ctx):
    x, index = ctx.input("X"), ctx.input("Index")
    ctx.set_output("Out", torch.index_select(x, 0, index.reshape(-1)))


@register_op("one_hot", no_grad=True)
def one_hot(ctx):
    """Ids [..., 1] -> [..., depth]; ids without the trailing singleton
    ([..., M] index tensors) -> [..., M, depth].  Always float32 (also
    under AMP, whatever the VarDesc says); ids outside [0, depth) give a
    zero row, as jax.nn.one_hot gives."""
    x = ctx.input("X")
    depth = ctx.attr("depth")
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    classes = torch.arange(depth, device=x.device)
    ctx.set_output("Out", (x[..., None] == classes).to(torch.float32))


@register_op("top_k", no_grad=True)
def top_k(ctx):
    """The k largest entries of the last dim, largest first, and their
    int64 indices; equal values keep their index order, lower index
    first, as jax.lax.top_k orders them (torch.topk gives no order for
    ties)."""
    k = ctx.attr("k", 1)
    vals, idx = torch.sort(ctx.input("X"), dim=-1, descending=True,
                           stable=True)
    ctx.set_output("Out", vals[..., :k])
    ctx.set_output("Indices", idx[..., :k])


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


@register_grad_maker("lookup_table")
def _lookup_table_grad_maker(op, block, no_grad_set):
    """Only W gets a grad; Ids is integer."""
    w = op.input("W")[0]
    if w in no_grad_set:
        return []
    return [{
        "type": "lookup_table_grad",
        "inputs": {"W": [w], "Ids": list(op.input("Ids")),
                   "Out@GRAD": [grad_var_name(op.output("Out")[0])]},
        "outputs": {"W@GRAD": [grad_var_name(w)]},
        "attrs": dict(op.attrs),
    }]


@register_op("lookup_table_grad", no_grad=True)
def lookup_table_grad(ctx):
    """Scatter-add of the output grad rows into a dense W@GRAD: repeated ids
    add up, rows at padding_idx add nothing.  Sums in float32 whatever W's
    dtype, then casts."""
    w, ids, gout = ctx.input("W"), ctx.input("Ids"), ctx.input("Out@GRAD")
    flat = ids.reshape(-1)
    g = gout.reshape(-1, w.shape[1]).float()
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx != -1:
        g = torch.where((flat == padding_idx)[:, None], torch.zeros_like(g), g)
    gw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    gw.index_add_(0, flat, g)
    ctx.set_output("W@GRAD", gw.to(w.dtype))


@register_op("increment")
def increment(ctx):
    x = ctx.input("X")
    step = torch.tensor(ctx.attr("step", 1.0), dtype=x.dtype).item()
    ctx.set_output("Out", x + step)
