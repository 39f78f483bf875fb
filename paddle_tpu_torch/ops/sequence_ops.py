"""Sequence ops over padded batches + lengths (paddle_tpu/ops/
sequence_ops.py).  Each op takes the dense [B, T, ...] batch plus an
optional int `SeqLen [B]` input and masks with `step < len`: static
shapes, no host read.  Without SeqLen every row is full length.

sequence_pool has its six pool types, AVERAGE, SUM, SQRT, LAST, FIRST
and MAX (with its MaxIndex output); the others are sequence_conv,
_softmax, _expand, _expand_as, _reverse, _slice, _mask, _pad, _unpad,
_concat, _enumerate, _erase, _reshape, _scatter and lod_reset, each the
JAX lowering's arithmetic in the same order.  Their grads are the
registry's generic one; _mask, _enumerate, _erase and _scatter have none,
as in the JAX package.
"""

from __future__ import annotations

import torch

from ..framework.core_types import dtype_to_torch
from .registry import register_op

# masked steps of a MAX pool, the JAX lowering's fill
_NEG_INF = -1e9


def _mask_bt(b, t, lengths, dtype, device):
    """[B, T] validity mask in `dtype`; all ones without lengths."""
    if lengths is None:
        return torch.ones((b, t), dtype=dtype, device=device)
    steps = torch.arange(t, device=device).reshape(1, t)
    return (steps < lengths.reshape(b, 1).to(torch.int64)).to(dtype)


def _expand(m, ndim):
    """[B, T] -> [B, T, 1, ...] broadcastable over `ndim`-dim features."""
    return m.reshape(tuple(m.shape) + (1,) * (ndim - 2))


def _mask(x, lengths):
    """[B, T, 1, ...] validity mask in X's dtype (all ones without
    lengths), broadcastable over X's feature dims."""
    return _expand(_mask_bt(x.shape[0], x.shape[1], lengths, x.dtype,
                            x.device), x.dim())


def _steps(b, t, device):
    return torch.arange(t, device=device).reshape(1, t).expand(b, t)


def _take_steps(x, idx):
    """x[b, idx[b, j], ...]: a gather along the time dim by [B, T'] ints."""
    full = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, full)


@register_op("sequence_pool")
def sequence_pool(ctx):
    """X [B, T, ...] (+ SeqLen [B]) -> Out [B, ...]; empty rows pool to
    0.  AVERAGE, SUM and SQRT sum the valid steps and divide by n, 1 and
    sqrt(n) (n at least 1); MAX fills masked steps with -1e9 first and
    writes the argmax step to MaxIndex (int32)."""
    x, lengths = ctx.input("X"), ctx.input("SeqLen")
    ptype = str(ctx.attr("pooltype", "AVERAGE")).upper()
    m = _mask(x, lengths)
    n_valid = m.sum(dim=1)
    if lengths is None:
        n_valid = torch.full_like(n_valid, x.shape[1])
    if ptype == "MAX":
        filled = torch.where(m > 0, x, torch.full_like(x, _NEG_INF))
        # amax: tied maxima share the grad, as jax.vjp of jnp.max
        out = torch.amax(filled, dim=1)
        out = torch.where(n_valid > 0, out, torch.zeros_like(out))
        ctx.set_output("MaxIndex", torch.argmax(filled, dim=1).to(
            torch.int32))
    elif ptype in ("AVERAGE", "SUM", "SQRT"):
        out = (x * m).sum(dim=1)
        safe_n = torch.clamp_min(n_valid, 1.0)
        if ptype == "AVERAGE":
            out = out / safe_n
        elif ptype == "SQRT":
            out = out / torch.sqrt(safe_n)
    elif ptype == "FIRST":
        out = x[:, 0]
        if lengths is not None:
            out = out * (n_valid > 0).to(x.dtype)
    elif ptype == "LAST":
        if lengths is None:
            out = x[:, -1]
        else:
            idx = torch.clamp(lengths.to(torch.int64) - 1, 0,
                              x.shape[1] - 1)
            idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2))
            idx = idx.expand((x.shape[0], 1) + tuple(x.shape[2:]))
            out = torch.gather(x, 1, idx)[:, 0]
            out = torch.where(n_valid > 0, out, torch.zeros_like(out))
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    ctx.set_output("Out", out)


@register_op("sequence_conv")
def sequence_conv(ctx):
    """A context-window conv over time (the JAX lowering :78-101): X
    [B, T, D] masked, shifted by each offset of the window (zeros outside
    [0, T)), concatenated to [B, T, contextLength*D] and multiplied by
    Filter [contextLength*D, F]; steps past a row's length give 0."""
    x, filt, lengths = ctx.input("X"), ctx.input("Filter"), \
        ctx.input("SeqLen")
    ctx_len = int(ctx.attr("contextLength", 3))
    ctx_start = int(ctx.attr("contextStart", -((ctx_len - 1) // 2)))
    b, t, _ = x.shape
    m = _mask_bt(b, t, lengths, x.dtype, x.device).reshape(b, t, 1)
    xm = x * m
    steps = _steps(b, t, x.device)
    cols = []
    for j in range(ctx_len):
        off = ctx_start + j
        valid = ((steps + off >= 0) & (steps + off < t)).to(x.dtype)
        cols.append(torch.roll(xm, -off, dims=1) * valid.reshape(b, t, 1))
    col = torch.cat(cols, dim=-1)
    ctx.set_output("Out", torch.matmul(col, filt) * m)


@register_op("sequence_softmax")
def sequence_softmax(ctx):
    """Softmax over each row's valid prefix (in float32, or in X's dtype
    where that is wider); padding gets probability 0."""
    x, lengths = ctx.input("X"), ctx.input("SeqLen")
    m = _mask(x, lengths)
    ct = torch.promote_types(x.dtype, torch.float32)
    logits = torch.where(m > 0, x.to(ct), torch.full_like(x, _NEG_INF,
                                                          dtype=ct))
    out = torch.softmax(logits, dim=1) * m.to(ct)
    ctx.set_output("Out", out.to(x.dtype))


def _expand_rows(ctx):
    """X [B, ...] broadcast along Y's time dim, masked by SeqLen."""
    x, y, lengths = ctx.input("X"), ctx.input("Y"), ctx.input("SeqLen")
    t = y.shape[1]
    out = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    m = _expand(_mask_bt(x.shape[0], t, lengths, x.dtype, x.device),
                out.dim())
    ctx.set_output("Out", out * m)


@register_op("sequence_expand")
def sequence_expand(ctx):
    """ref_level 0 in the padded form: row i of X repeated along Y's time
    axis, masked by Y's lengths."""
    _expand_rows(ctx)


@register_op("sequence_expand_as")
def sequence_expand_as(ctx):
    _expand_rows(ctx)


@register_op("sequence_reverse")
def sequence_reverse(ctx):
    """Each row's valid prefix reversed, padding kept in place:
    y[i, j] = x[i, len_i - 1 - j] for j < len_i."""
    x, lengths = ctx.input("X"), ctx.input("SeqLen")
    if lengths is None:
        ctx.set_output("Y", torch.flip(x, dims=[1]))
        return
    b, t = x.shape[0], x.shape[1]
    steps = _steps(b, t, x.device)
    ln = lengths.reshape(b, 1).to(torch.int64)
    ctx.set_output("Y", _take_steps(x, torch.where(steps < ln,
                                                   ln - 1 - steps, steps)))


@register_op("sequence_slice")
def sequence_slice(ctx):
    """Each row's [offset, offset + length) window moved to the front,
    the steps past it 0."""
    x = ctx.input("X")
    b, t = x.shape[0], x.shape[1]
    off = ctx.input("Offset").reshape(b, 1).to(torch.int64)
    ln = ctx.input("Length").reshape(b, 1).to(torch.int64)
    steps = _steps(b, t, x.device)
    gathered = _take_steps(x, torch.clamp(steps + off, 0, t - 1))
    ctx.set_output("Out", gathered * _expand((steps < ln).to(x.dtype),
                                             x.dim()))


@register_op("sequence_mask", no_grad=True)
def sequence_mask(ctx):
    """lengths [B] -> Y [B, maxlen]: step < length, in out_dtype.  maxlen
    must be a static attr (the output's shape)."""
    x = ctx.input("X")
    maxlen = int(ctx.attr("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen attr (the "
                         "output shape may not depend on the data)")
    b = x.shape[0]
    m = _steps(b, maxlen, x.device) < x.reshape(b, 1).to(torch.int64)
    ctx.set_output("Y", m.to(dtype_to_torch(ctx.attr("out_dtype",
                                                      "float32"))))


@register_op("sequence_pad")
def sequence_pad(ctx):
    """The time axis cut or zero-extended to padded_length (T when <= 0),
    PadValue past each row's length; Length: the row lengths (int64),
    at most padded_length."""
    x, lengths = ctx.input("X"), ctx.input("SeqLen")
    pad_value = ctx.input("PadValue")
    target = int(ctx.attr("padded_length", -1))
    b, t = x.shape[0], x.shape[1]
    target = t if target <= 0 else target
    pv = (torch.zeros((), dtype=x.dtype, device=x.device) if pad_value is None
          else pad_value.reshape(()).to(x.dtype))
    if target > t:
        x = torch.cat([x, torch.zeros((b, target - t) + tuple(x.shape[2:]),
                                      dtype=x.dtype, device=x.device)], 1)
    elif target < t:
        x = x[:, :target]
    m = _mask(x, lengths)
    ctx.set_output("Out", x * m + pv * (1 - m))
    ln = (lengths.to(torch.int64) if lengths is not None
          else torch.full((b,), t, dtype=torch.int64, device=x.device))
    ctx.set_output("Length", torch.clamp_max(ln, target))


@register_op("sequence_unpad")
def sequence_unpad(ctx):
    """The padding zeroed (dense + lengths is already the native form)."""
    x = ctx.input("X")
    ctx.set_output("Out", x * _mask(x, ctx.input("Length")))


@register_op("sequence_concat")
def sequence_concat(ctx):
    """Row i: the valid prefix of each input in turn, then zeros; OutLen
    the summed lengths (int64)."""
    xs, lens = ctx.inputs("X"), ctx.inputs("SeqLen")
    b = xs[0].shape[0]
    t_total = sum(x.shape[1] for x in xs)
    dev = xs[0].device
    running = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = torch.zeros((b, t_total) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=dev)
    steps = _steps(b, t_total, dev)
    for k, x in enumerate(xs):
        ln = (lens[k].to(torch.int32) if k < len(lens) and lens[k] is not None
              else torch.full((b,), x.shape[1], dtype=torch.int32,
                              device=dev))
        xp = torch.cat([x, torch.zeros((b, t_total - x.shape[1])
                                       + tuple(x.shape[2:]), dtype=x.dtype,
                                       device=dev)], 1)
        start = running.reshape(b, 1)
        shifted = _take_steps(xp, torch.clamp(steps - start, 0, t_total - 1))
        valid = (steps >= start) & (steps < (running + ln).reshape(b, 1))
        out = out + shifted * _expand(valid.to(x.dtype), out.dim())
        running = running + ln
    ctx.set_output("Out", out)
    ctx.set_output("OutLen", running.to(torch.int64))


@register_op("sequence_enumerate", no_grad=True)
def sequence_enumerate(ctx):
    """Out [B, T, win_size]: the window of ids starting at each step,
    pad_value past the row's length."""
    x, lengths = ctx.input("X"), ctx.input("SeqLen")
    win = int(ctx.attr("win_size", 2))
    pad = ctx.attr("pad_value", 0)
    b, t = x.shape[0], x.shape[1]
    steps = _steps(b, t, x.device)
    ln = (lengths.reshape(b, 1).to(torch.int64) if lengths is not None
          else torch.full((b, 1), t, dtype=torch.int64, device=x.device))
    outs = []
    for j in range(win):
        shifted = torch.roll(x, -j, dims=1)
        outs.append(torch.where(steps + j < ln, shifted,
                                torch.full_like(shifted, pad)))
    ctx.set_output("Out", torch.stack(outs, dim=-1))


@register_op("sequence_erase", no_grad=True)
def sequence_erase(ctx):
    """The listed tokens dropped and each row compacted to the left, in
    a [B, T] output whose freed tail is 0; OutLen the new lengths
    (int64)."""
    x, lengths = ctx.input("X"), ctx.input("SeqLen")
    b, t = x.shape[0], x.shape[1]
    steps = _steps(b, t, x.device)
    ln = (lengths.reshape(b, 1).to(torch.int64) if lengths is not None
          else torch.full((b, 1), t, dtype=torch.int64, device=x.device))
    keep = steps < ln
    for tok in ctx.attr("tokens", []) or []:
        keep = keep & (x != tok)
    # a kept element goes to cumsum(keep) - 1, a dropped one adds 0 at
    # slot t - 1: the positions of kept elements are distinct
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    safe = torch.where(keep, pos, torch.full_like(pos, t - 1))
    vals = torch.where(keep, x, torch.zeros_like(x))
    ctx.set_output("Out", torch.zeros_like(x).scatter_add_(1, safe, vals))
    ctx.set_output("OutLen", keep.sum(dim=1).to(torch.int64))


@register_op("sequence_reshape")
def sequence_reshape(ctx):
    """X [B, T, M] -> Out [B, T*M/new_dim, new_dim]; OutLen = SeqLen * M
    / new_dim."""
    x = ctx.input("X")
    new_dim = int(ctx.attr("new_dim"))
    b, t, m = x.shape
    ctx.set_output("Out", x.reshape(b, t * m // new_dim, new_dim))
    if ctx.has_input("SeqLen"):
        ctx.set_output("OutLen", torch.div(ctx.input("SeqLen") * m, new_dim,
                                           rounding_mode="floor"))


@register_op("sequence_scatter", no_grad=True)
def sequence_scatter(ctx):
    """Out = X with X[i, Ids[i, j]] += Updates[i, j]; an update past the
    row's SeqLen, or whose id lies outside [0, T), is dropped."""
    x = ctx.input("X")
    ids = ctx.input("Ids").to(torch.int64)
    upd = ctx.input("Updates")
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    keep = (ids >= 0) & (ids < x.shape[1])
    if ctx.has_input("SeqLen"):
        live = _steps(ids.shape[0], ids.shape[1], ids.device) \
            < ctx.input("SeqLen").reshape(-1, 1).to(torch.int64)
        keep = keep & live
    ids = torch.where(keep, ids, torch.zeros_like(ids))
    upd = upd * _expand(keep.to(upd.dtype), upd.dim())
    idx = ids.reshape(tuple(ids.shape) + (1,) * (upd.dim() - 2)).expand(
        upd.shape)
    ctx.set_output("Out", x.clone().scatter_add_(1, idx, upd.to(x.dtype)))


@register_op("lod_reset")
def lod_reset(ctx):
    """Out is X; OutLen: the lengths Y holds (int32), or those of the
    offsets attr target_lod."""
    ctx.set_output("Out", ctx.input("X"))
    if ctx.has_input("Y"):
        ctx.set_output("OutLen",
                       ctx.input("Y").reshape(-1).to(torch.int32))
        return
    target = ctx.attr("target_lod", None)
    if target:
        offs = torch.as_tensor(target, dtype=torch.int32,
                               device=ctx.input("X").device)
        ctx.set_output("OutLen", offs[1:] - offs[:-1])

