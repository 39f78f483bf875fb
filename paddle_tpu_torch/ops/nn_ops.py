"""Normalization ops: layer_norm and its recomputing grad
(paddle_tpu/ops/nn_ops.py:361, :387)."""

from __future__ import annotations

import torch

from .registry import register_op, register_remat_grad


@register_op("layer_norm")
def layer_norm(ctx):
    """Normalise over dims [begin_norm_axis:), statistics in float32
    whatever the storage dtype."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    axis = ctx.attr("begin_norm_axis", 1)
    axes = tuple(range(axis, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
    norm_shape = (1,) * axis + tuple(x.shape[axis:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    lead = tuple(x.shape[:axis])
    ctx.set_output("Y", y)
    ctx.set_output("Mean", mean.reshape(lead).to(x.dtype))
    ctx.set_output("Variance", var.reshape(lead).to(x.dtype))


# the grad replays the normalisation from X instead of keeping x_hat alive
# from the forward to the backward
register_remat_grad("layer_norm")
