"""Fused recurrent ops: `fused_lstm` and `fused_gru` over a whole sequence.

Counterparts of paddle_tpu/ops/rnn_ops.py:27-130, where each op is one
`lax.scan`.  Here each is a Python loop over time, which the Executor's
jit path captures with the rest of the step into one CUDA graph: the
input projection for every time step is hoisted out of the loop (one
[B*S, D] x [D, kH] product, float32 accumulation, cast back to X's dtype,
plus the bias), and only `h @ WeightH` and the gates stay inside.

The functions are the JAX package's, not torch.nn's: the LSTM's gates are
i, f, g (the cell candidate), o with one bias; the GRU's are u, r, c with
`h = u * cand + (1 - u) * h_prev` and r applied to h before the
candidate's product, `(r * h) @ WeightH[:, 2H:]` (torch.nn.GRU applies r
after the product and weights h_prev by z).

Layout: batch-major [B, S, D] in and out; `is_reverse` runs the sequence
backwards and flips the output back.  Gradients are the registry's
generic ones (the forward replayed under autograd), as the JAX package
takes `jax.vjp` of the scan.
"""

from __future__ import annotations

import torch

from .registry import register_op


def _mm(a, b):
    """a @ b over the promoted dtype (jnp's `@`)."""
    common = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(common), b.to(common))


def _project_input(x, wx, b, reverse, width):
    """[B, S, D] @ [D, kH] for every step at once -> time-major [S, B, kH]:
    float32 accumulation cast to X's dtype, then the bias."""
    if reverse:
        x = torch.flip(x, dims=[1])
    bsz, steps, d = x.shape
    # time-major rows, so that each step's slice is contiguous
    rows = x.transpose(0, 1).reshape(steps * bsz, d)
    if x.dtype == wx.dtype:
        xw = torch.matmul(rows, wx)        # accumulates in float32
    else:
        xw = _mm(rows.float(), wx.float()).to(x.dtype)
    xw = xw.reshape(steps, bsz, -1)
    if b is not None:
        xw = xw + b.reshape(-1)[:width]
    return xw


def _initial(ctx, name, like, hidden):
    if ctx.has_input(name):
        return ctx.input(name)
    return torch.zeros((like.shape[0], hidden), dtype=like.dtype,
                       device=like.device)


def _time_major_out(hs, reverse):
    out = torch.stack(hs, dim=1)           # [B, S, H]
    return torch.flip(out, dims=[1]) if reverse else out


@register_op("fused_lstm")
def fused_lstm(ctx):
    """X [B, S, D], WeightX [D, 4H], WeightH [H, 4H], Bias [4H], optional
    H0/C0 [B, H] -> Out [B, S, H], LastH, LastC [B, H]."""
    x, wh = ctx.input("X"), ctx.input("WeightH")
    reverse = bool(ctx.attr("is_reverse", False))
    hidden = wh.shape[0]
    xw = _project_input(x, ctx.input("WeightX"), ctx.input("Bias"), reverse,
                        4 * hidden)
    h = _initial(ctx, "H0", x, hidden)
    c = _initial(ctx, "C0", x, hidden)
    hs = []
    # unbind, not xw[t]: its grad is one stack, not a zero-filled xw a step
    for xt in xw.unbind(0):
        gates = xt + _mm(h, wh)
        # sigmoid over all four gates in one kernel; g's share is unused
        i, f, _, o = torch.sigmoid(gates).chunk(4, dim=1)
        g = torch.tanh(gates.chunk(4, dim=1)[2])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    ctx.set_output("Out", _time_major_out(hs, reverse))
    ctx.set_output("LastH", h)
    ctx.set_output("LastC", c)


@register_op("fused_gru")
def fused_gru(ctx):
    """X [B, S, D], WeightX [D, 3H], WeightH [H, 3H], Bias [3H], optional
    H0 [B, H] -> Out [B, S, H], LastH [B, H]."""
    x, wh = ctx.input("X"), ctx.input("WeightH")
    reverse = bool(ctx.attr("is_reverse", False))
    hidden = wh.shape[0]
    xw = _project_input(x, ctx.input("WeightX"), ctx.input("Bias"), reverse,
                        3 * hidden)
    wh_uz, wh_c = wh[:, :2 * hidden], wh[:, 2 * hidden:]
    h = _initial(ctx, "H0", x, hidden)
    hs = []
    for xt in xw.unbind(0):
        x_uz, x_c = xt.split([2 * hidden, hidden], dim=1)
        u, r = torch.sigmoid(x_uz + _mm(h, wh_uz)).chunk(2, dim=1)
        cand = torch.tanh(x_c + _mm(r * h, wh_c))
        h = u * cand + (1.0 - u) * h
        hs.append(h)
    ctx.set_output("Out", _time_major_out(hs, reverse))
    ctx.set_output("LastH", h)
