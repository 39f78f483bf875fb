"""Sequence ops over padded batches + lengths: sequence_pool
(paddle_tpu/ops/sequence_ops.py:34), LAST pooling only — the one the
serving slice's prefill uses (sequence_last_step on the ragged prefix).
"""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("sequence_pool")
def sequence_pool(ctx):
    """X [B, T, ...] (+ SeqLen [B]) -> Out [B, ...]: each row's last valid
    step; empty rows pool to 0."""
    x, lengths = ctx.input("X"), ctx.input("SeqLen")
    ptype = str(ctx.attr("pooltype", "AVERAGE")).upper()
    if ptype != "LAST":
        raise NotImplementedError(
            f"sequence_pool pooltype {ptype}: the port has LAST only so far "
            "(the rest land with the sequence op family, ROADMAP A)")
    if lengths is None:
        ctx.set_output("Out", x[:, -1])
        return
    t = x.shape[1]
    idx = torch.clamp(lengths.to(torch.int64) - 1, 0, t - 1)
    idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2))
    idx = idx.expand((x.shape[0], 1) + tuple(x.shape[2:]))
    out = torch.gather(x, 1, idx)[:, 0]
    live = (lengths > 0).reshape((-1,) + (1,) * (out.dim() - 1))
    ctx.set_output("Out", torch.where(live, out, torch.zeros_like(out)))
