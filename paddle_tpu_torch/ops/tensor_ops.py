"""Tensor ops: creation (fill_constant, fill_constant_batch_size_like,
fill, fill_zeros_like, assign, assign_value, shape), cast, the shape
family (reshape, reshape2, transpose, transpose2, squeeze, squeeze2,
unsqueeze, unsqueeze2, concat, split, slice, stack, unstack, expand, pad,
pad2d, reverse), indexing (gather, scatter, one_hot, select, diag),
ordering (top_k, arg_max, arg_min, argsort), lookup_table (with its
hand-written grad), increment, rc_barrier, and the host-shaped range,
linspace and where.

Counterparts of paddle_tpu/ops/tensor_ops.py (fill_constant :25, fill
:32, fill_constant_batch_size_like :42, fill_zeros_like :55, assign :60,
assign_value :65, shape :73, cast :78, reshape :83, reshape2 :99,
transpose :106, transpose2 :111, concat :118, split :124, slice :138,
squeeze/squeeze2 :152-166, unsqueeze/unsqueeze2 :169-182, stack :185,
unstack :191, expand :198, pad :205, pad2d :215, gather :229, scatter
:235, one_hot :242, top_k :254, arg_max/arg_min/argsort :263-283,
lookup_table :286, lookup_table_grad :311-342, range/linspace/where
:345-366, select :369, diag :390, increment :395, reverse :401,
rc_barrier :410).  Shape inference and grads are the registry's generic
ones (a meta-tensor run; an autograd replay).  Integer feeds keep int64
here, where the JAX package (x64 off) narrows them to int32: values
agree, dtypes do not.

The `*2` ops' XShape is the JAX package's: a zero-size [0, *X.shape]
tensor in X's dtype that no gradient flows through.  `range`,
`linspace` and `where` have data-dependent shapes: they are `no_jit`, so
the jit path runs them on the host between segments, and shape
inference skips them, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.core_types import dtype_to_torch
from ..framework.framework import grad_var_name
from .registry import register_grad, register_grad_maker, register_op


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


def _staged(ctx, key, make):
    """A constant built on the host by `make()`, staged onto the op's
    device once (kept in the op's `_`-prefixed scratch attrs, which the
    desc leaves out) and cloned at each run: a CUDA graph capture cannot
    hold a copy from pageable host memory, and the eager warm-up before
    it stages the constant."""
    key = f"_staged_{key}_{ctx.device}"
    staged = ctx.attrs.get(key)
    if staged is None:
        staged = ctx.attrs[key] = make().to(ctx.device)
    return staged.clone()


@register_op("assign_value")
def assign_value(ctx):
    """The `values` list as a tensor of `shape` and `dtype`."""
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    shape = [int(s) for s in ctx.attr("shape")]
    ctx.set_output("Out", _staged(ctx, f"assign_{dtype}", lambda: (
        torch.from_numpy(np.asarray(ctx.attr("values"))).reshape(shape)
        .to(dtype))))


@register_op("fill", no_grad=True)
def fill(ctx):
    """The `value` list as a tensor of `shape` and `dtype` (reference
    fill_op.cc), the values rounded through float32 as the JAX
    lowering rounds them."""
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = dtype_to_torch(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", _staged(ctx, f"fill_{dtype}", lambda: torch.tensor(
        [float(v) for v in ctx.attr("value")],
        dtype=torch.float32).reshape(shape).to(dtype)))


@register_op("fill_zeros_like")
def fill_zeros_like(ctx):
    ctx.set_output("Out", torch.zeros_like(ctx.input("X")))


@register_op("shape", no_grad=True)
def shape_op(ctx):
    """Input's shape as an int32 vector."""
    x = ctx.input("Input")
    dims = tuple(x.shape)
    ctx.set_output("Out", _staged(ctx, f"shape_{dims}", lambda: torch.tensor(
        dims, dtype=torch.int32)))


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


def _xshape(x):
    """The `*2` ops' XShape: [0, *X.shape], no elements."""
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2")
def reshape2(ctx):
    reshape(ctx)
    ctx.set_output("XShape", _xshape(ctx.input("X")))


@register_op("transpose")
def transpose(ctx):
    ctx.set_output("Out", ctx.input("X").permute(list(ctx.attr("axis"))))


@register_op("transpose2")
def transpose2(ctx):
    transpose(ctx)
    ctx.set_output("XShape", _xshape(ctx.input("X")))


@register_op("split")
def split(ctx):
    """X cut along `axis` into the `sections` sizes, else into `num`
    equal parts."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    sections = list(ctx.attr("sections", []) or [])
    if not sections:
        num = ctx.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {x.shape[axis]} is not divisible "
                             f"into {num} parts")
        sections = [x.shape[axis] // num] * num
    ctx.set_outputs("Out", list(torch.split(x, sections, dim=axis)))


@register_op("squeeze")
def squeeze(ctx):
    """The `axes` of size 1 dropped (others named there are kept), or
    every size-1 dim when `axes` is empty."""
    x = ctx.input("X")
    axes = ctx.attr("axes", [])
    if axes:
        dims = tuple(a for a in axes if x.shape[a] == 1)
        ctx.set_output("Out", torch.squeeze(x, dims) if dims else x)
    else:
        ctx.set_output("Out", torch.squeeze(x))


@register_op("squeeze2")
def squeeze2(ctx):
    squeeze(ctx)
    ctx.set_output("XShape", _xshape(ctx.input("X")))


@register_op("unsqueeze")
def unsqueeze(ctx):
    """A size-1 dim inserted at each of `axes`, in ascending order."""
    out = ctx.input("X")
    for ax in sorted(ctx.attr("axes")):
        out = torch.unsqueeze(out, ax)
    ctx.set_output("Out", out)


@register_op("unsqueeze2")
def unsqueeze2(ctx):
    unsqueeze(ctx)
    ctx.set_output("XShape", _xshape(ctx.input("X")))


@register_op("stack")
def stack(ctx):
    xs = [x for x in ctx.inputs("X") if x is not None]
    ctx.set_output("Y", torch.stack(xs, dim=ctx.attr("axis", 0)))


@register_op("unstack")
def unstack(ctx):
    ctx.set_outputs("Y", list(torch.unbind(ctx.input("X"),
                                           dim=ctx.attr("axis", 0))))


@register_op("expand")
def expand(ctx):
    """X tiled `expand_times` along each dim (jnp.tile: a shorter list
    leaves the leading dims alone, a longer one adds dims in front)."""
    x = ctx.input("X")
    times = [int(t) for t in ctx.attr("expand_times")]
    times = [1] * (x.dim() - len(times)) + times
    ctx.set_output("Out", x.repeat(times))


def _torch_pad(pairs):
    """[(lo, hi) per dim, first dim first] -> F.pad's flat list, last dim
    first."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [int(lo), int(hi)]
    return flat


@register_op("pad")
def pad(ctx):
    """Constant padding, `paddings` = [lo0, hi0, lo1, hi1, ...]."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    ctx.set_output("Out", F.pad(x, _torch_pad(pairs),
                                value=ctx.attr("pad_value", 0.0)))


@register_op("pad2d")
def pad2d(ctx):
    """NCHW spatial padding, paddings [top, bottom, left, right], mode
    constant, reflect (the edge not repeated) or edge (reference
    pad2d_op.cc)."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    mode = ctx.attr("mode", "constant")
    flat = [int(p[2]), int(p[3]), int(p[0]), int(p[1])]
    if mode == "constant":
        out = F.pad(x, flat, value=ctx.attr("pad_value", 0.0))
    else:
        out = F.pad(x, flat, mode={"reflect": "reflect",
                                   "edge": "replicate"}[mode])
    ctx.set_output("Out", out)


def _unpad(g, d, lo, hi, n, mode):
    """pad2d's adjoint along dim d: the inner n entries of g, plus, for
    reflect, the mirrored border grads added onto the entries they copied
    (border o of the low side copied entry lo - o), or, for edge, each
    border's sum added onto the edge entry."""
    core = g.narrow(d, lo, n)
    if mode == "constant" or not (lo or hi):
        return core
    core = core.clone()
    if mode == "reflect":
        if lo:
            core.narrow(d, 1, lo).add_(g.narrow(d, 0, lo).flip(d))
        if hi:
            core.narrow(d, n - 1 - hi, hi).add_(g.narrow(d, lo + n, hi)
                                                .flip(d))
    else:
        if lo:
            core.narrow(d, 0, 1).add_(g.narrow(d, 0, lo).sum(d, keepdim=True))
        if hi:
            core.narrow(d, n - 1, 1).add_(g.narrow(d, lo + n, hi).sum(
                d, keepdim=True))
    return core


@register_grad("pad2d")
def pad2d_grad(ctx):
    """X's grad, one axis at a time (`_unpad`), by slices and adds in a
    fixed order: the autograd backward of a reflect or edge pad adds the
    border grads with atomics on the card, in an order a replay need not
    keep."""
    x, gy = ctx.input("X"), ctx.input("Out@GRAD").to(ctx.input("X").dtype)
    top, bottom, left, right = (int(v) for v in ctx.attr("paddings"))
    mode = ctx.attr("mode", "constant")
    g = _unpad(gy, 3, left, right, x.shape[3], mode)
    ctx.set_output("X@GRAD", _unpad(g, 2, top, bottom, x.shape[2], mode))


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


@register_op("scatter")
def scatter(ctx):
    """Out = X with rows Ids replaced by Updates (reference
    scatter_op.cc).  Which update wins for a repeated id is undefined, in
    the JAX package as on the card."""
    x, ids, upd = ctx.input("X"), ctx.input("Ids"), ctx.input("Updates")
    ctx.set_output("Out", x.index_copy(0, ids.reshape(-1), upd.to(x.dtype)))


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


@register_op("arg_max", no_grad=True)
def arg_max(ctx):
    """int64 index of the largest entry along `axis`, the first of equal
    ones (jnp.argmax)."""
    ctx.set_output("Out", torch.argmax(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)))


@register_op("arg_min", no_grad=True)
def arg_min(ctx):
    ctx.set_output("Out", torch.argmin(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)))


@register_op("argsort", no_grad=True)
def argsort(ctx):
    """Ascending along `axis`; equal entries keep their order (a stable
    sort, as jnp.argsort).  Out holds the sorted values, Indices their
    int64 positions."""
    vals, idx = torch.sort(ctx.input("X"), dim=ctx.attr("axis", -1),
                           stable=True)
    ctx.set_output("Indices", idx)
    ctx.set_output("Out", vals)


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


def _host_scalar(t):
    """A one-element tensor's value as a numpy scalar of its dtype (read
    on the host: the op runs between the jit path's segments)."""
    return t.detach().reshape(()).cpu().numpy()


@register_op("range", no_grad=True, no_jit=True)
def range_op(ctx):
    """start + step * [0, 1, ..., n), n = ceil((end - start) / step)
    computed on the host in the inputs' dtype, as the JAX lowering."""
    start = ctx.input("Start").reshape(())
    end, step = ctx.input("End").reshape(()), ctx.input("Step").reshape(())
    n = int(np.ceil((_host_scalar(end) - _host_scalar(start))
                    / _host_scalar(step)))
    ctx.set_output("Out", start + step * torch.arange(
        n, dtype=start.dtype, device=start.device))


@register_op("linspace", no_grad=True, no_jit=True)
def linspace(ctx):
    start = ctx.input("Start").reshape(())
    stop = ctx.input("Stop").reshape(())
    num = int(_host_scalar(ctx.input("Num")))
    ctx.set_output("Out", torch.linspace(
        float(_host_scalar(start)), float(_host_scalar(stop)), num,
        dtype=start.dtype, device=start.device))


@register_op("where", no_grad=True, no_jit=True)
def where_op(ctx):
    """The int64 coordinates of Condition's true entries, one row each,
    in row-major order."""
    ctx.set_output("Out", torch.nonzero(ctx.input("Condition")))


@register_op("select")
def select_op(ctx):
    """Out = Condition ? X : Y per element (the untaken side's NaN or Inf
    never leaks, nor its gradient).  A per-row condition ([B] or [B, 1])
    that does not right-align with X is reshaped to [B, 1, ...], as the
    JAX lowering reshapes it."""
    cond = ctx.input("Condition").to(torch.bool)
    x, y = ctx.input("X"), ctx.input("Y")
    aligns = (cond.dim() <= x.dim()
              and tuple(cond.shape) == tuple(x.shape[x.dim() - cond.dim():]))
    if not aligns and x.dim() >= 1 and cond.numel() == x.shape[0]:
        cond = cond.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    ctx.set_output("Out", torch.where(cond, x, y))


@register_op("diag", no_grad=True)
def diag(ctx):
    ctx.set_output("Out", torch.diag(ctx.input("Diagonal")))


@register_op("reverse")
def reverse(ctx):
    axis = ctx.attr("axis")
    if isinstance(axis, int):
        axis = [axis]
    ctx.set_output("Out", torch.flip(ctx.input("X"), dims=list(axis)))


@register_op("increment")
def increment(ctx):
    x = ctx.input("X")
    step = torch.tensor(ctx.attr("step", 1.0), dtype=x.dtype).item()
    ctx.set_output("Out", x + step)


@register_op("rc_barrier", no_grad=True)
def rc_barrier(ctx):
    """The recompute pass's barrier (recompute.py): Out is X, the same
    tensors.  In the JAX package an optimization barrier keeps XLA's CSE
    from folding the recomputed clones back into the forward's values, and
    Trigger (an incoming gradient) orders the recompute after the backward
    reaches the segment.  Eager torch merges nothing and runs ops in
    program order, so Trigger is read for ordering only; the op exists so
    that the port runs the JAX package's rewritten program as it is."""
    ctx.set_outputs("Out", [v for v in ctx.inputs("X") if v is not None])
