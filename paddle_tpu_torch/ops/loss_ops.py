"""Loss and metric ops: cross_entropy, softmax_with_cross_entropy,
square_error_cost and accuracy (paddle_tpu/ops/loss_ops.py:26, :45, :98,
:191).

softmax_with_cross_entropy is fused and numerically stable, computed in
float32 whatever the logits' dtype; its Loss output stays float32
(per-token losses feed reductions).  With `label_smooth_eps` > 0 and hard
labels, uniform label smoothing is fused in: loss = lse - (1 - eps) *
logit_y - eps * mean(logits), so the [N, V] smoothed one-hot is never
built.  cross_entropy takes probabilities (after a softmax).  The
gradients are the registry's generic ones; accuracy has none.
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


@register_op("cross_entropy")
def cross_entropy(ctx):
    """X are probabilities; Label is [..., 1] integer (or a soft
    distribution); Y = -log p(label), [..., 1], clipped at 1e-20."""
    x, label = ctx.input("X"), ctx.input("Label")
    if ctx.attr("soft_label", False):
        y = -torch.xlogy(label, x.clamp_min(1e-20)).sum(dim=-1, keepdim=True)
    else:
        y = -torch.log(_picked(x, label).clamp_min(1e-20))
        y = y * (label != ctx.attr("ignore_index", -100)).to(y.dtype)
    ctx.set_output("Y", y)


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


@register_op("square_error_cost")
def square_error_cost(ctx):
    """Out = (X - Y)^2, elementwise."""
    ctx.set_output("Out", torch.square(ctx.input("X") - ctx.input("Y")))


@register_op("accuracy", no_grad=True)
def accuracy(ctx):
    """Indices [N, k] from top_k and Label [N, 1] -> the fraction of rows
    whose k predictions hit the label (float32 [1]), and the int32 counts
    Correct and Total."""
    indices, label = ctx.input("Indices"), ctx.input("Label")
    hits = (indices == label.reshape(-1, 1)).any(dim=1)
    correct = hits.sum(dtype=torch.int32).reshape(1)
    n = indices.shape[0]
    ctx.set_output("Accuracy", (correct / n).to(torch.float32))
    ctx.set_output("Correct", correct)
    ctx.set_output("Total", torch.full((1,), n, dtype=torch.int32,
                                       device=indices.device))
