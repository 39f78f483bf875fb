"""Sequence ops over padded batches + lengths: sequence_pool
(paddle_tpu/ops/sequence_ops.py:34-74) with its six pool types, AVERAGE,
SUM, SQRT, LAST, FIRST and MAX (with its MaxIndex output).  Its grad is
the registry's generic one.
"""

from __future__ import annotations

import torch

from .registry import register_op

# masked steps of a MAX pool, the JAX lowering's fill
_NEG_INF = -1e9


def _mask(x, lengths):
    """[B, T, 1, ...] validity mask in X's dtype (all ones without
    lengths), broadcastable over X's feature dims."""
    b, t = x.shape[0], x.shape[1]
    if lengths is None:
        m = torch.ones((b, t), dtype=x.dtype, device=x.device)
    else:
        steps = torch.arange(t, device=x.device).reshape(1, t)
        m = (steps < lengths.reshape(b, 1).to(torch.int64)).to(x.dtype)
    return m.reshape((b, t) + (1,) * (x.dim() - 2))


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
