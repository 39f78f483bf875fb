"""Loss ops: softmax_with_cross_entropy (paddle_tpu/ops/loss_ops.py:45).

Fused and numerically stable, computed in float32 whatever the logits'
dtype; the Loss output stays float32 (per-token losses feed reductions).
With `label_smooth_eps` > 0 and hard labels, uniform label smoothing is
fused in: loss = lse - (1 - eps) * logit_y - eps * mean(logits), so the
[N, V] smoothed one-hot is never built.  The gradient is the registry's
generic one.
"""

from __future__ import annotations

import torch

from .registry import register_op


def _picked(lf, label):
    """logits[..., label] per row; out-of-range labels (ignore_index) are
    clipped before the gather, and the mask zeroes their loss later."""
    lab = label.reshape(label.shape[:-1]).long()
    safe = lab.clamp(0, lf.shape[-1] - 1)
    return torch.gather(lf, -1, safe[..., None])


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(ctx):
    logits, label = ctx.input("Logits"), ctx.input("Label")
    soft_label = ctx.attr("soft_label", False)
    eps = float(ctx.attr("label_smooth_eps", 0.0) or 0.0)
    ignore = ctx.attr("ignore_index", -100)
    out_dtype = logits.dtype
    lf = logits.float()
    if not soft_label and eps > 0.0:
        lse = torch.logsumexp(lf, dim=-1, keepdim=True)
        loss = (lse - (1.0 - eps) * _picked(lf, label)
                - eps * lf.mean(dim=-1, keepdim=True))
        loss = loss * (label != ignore).to(loss.dtype)
        ctx.set_output("Softmax", torch.exp(lf - lse).to(out_dtype))
        ctx.set_output("Loss", loss)
        return
    logp = torch.log_softmax(lf, dim=-1)
    ctx.set_output("Softmax", torch.exp(logp).to(out_dtype))
    if soft_label:
        loss = -(label.float() * logp).sum(dim=-1, keepdim=True)
    else:
        loss = -_picked(logp, label)
        loss = loss * (label != ignore).to(loss.dtype)
    ctx.set_output("Loss", loss)
