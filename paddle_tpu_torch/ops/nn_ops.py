"""NN ops: conv2d and depthwise_conv2d with a grad that does not replay
the forward, pool2d, batch_norm with its hand-written grad, layer_norm
and its recomputing grad, lrn.

Counterparts of paddle_tpu/ops/nn_ops.py (conv2d :49-75 with the
conv1x1_as_dot branch :33-46, depthwise_conv2d :78-96, pool2d :153-193,
batch_norm :219-267, its grad maker :270 and batch_norm_grad :298-358,
layer_norm :361, lrn :413-429).  Layouts are the JAX package's: NCHW
inputs, OIHW filters.  A convolution is a library call (`F.conv2d`, cuDNN on the
card), as the JAX package leaves it to XLA outside any Pallas kernel.

cuDNN rounds float32 convolutions through TF32 unless
`torch.backends.cudnn.allow_tf32` is off (its default is on, unlike
matmul's), so every conv lowering turns it off around its call: a float32
conv runs in full float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .. import flags
from ..framework.framework import grad_var_name
from .registry import (
    register_grad,
    register_grad_maker,
    register_op,
    register_remat_grad,
)


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


@contextlib.contextmanager
def cudnn_fp32_exact():
    """cuDNN convolutions in full float32 (no TF32) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv_attrs(ctx, x):
    """(strides, paddings, dilations, groups).  A groups attr of 0 or None
    means 1 for conv2d and X's channels for depthwise_conv2d."""
    groups = ctx.attr("groups", 1) or (
        x.shape[1] if ctx.op_type.startswith("depthwise_conv2d") else 1)
    return (_pair(ctx.attr("strides", [1, 1])),
            _pair(ctx.attr("paddings", [0, 0])),
            _pair(ctx.attr("dilations", [1, 1])),
            groups)


def _conv1x1_as_dot(x, w, strides):
    """1x1 conv as a channel matmul over [B, C, H*W]; a strided one
    subsamples first.  Returned in X's dtype over the promoted operands,
    as the JAX package's einsum with preferred_element_type=x.dtype."""
    if strides[0] > 1 or strides[1] > 1:
        x = x[:, :, ::strides[0], ::strides[1]]
    b, c, h, wd = x.shape
    wk = w.reshape(w.shape[0], w.shape[1])            # OIHW 1x1 -> [K, C]
    common = torch.promote_types(x.dtype, w.dtype)
    out = torch.matmul(wk.to(common), x.reshape(b, c, h * wd).to(common))
    return out.reshape(b, wk.shape[0], h, wd).to(x.dtype)


@register_op("conv2d")
def conv2d(ctx):
    """Input NCHW, Filter OIHW, strides/paddings/dilations/groups."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    strides, pads, dilations, groups = _conv_attrs(ctx, x)
    if (w.shape[2] == 1 and w.shape[3] == 1 and pads == [0, 0]
            and groups == 1 and flags.get("conv1x1_as_dot")):
        out = _conv1x1_as_dot(x, w, strides)
    else:
        with cudnn_fp32_exact():
            out = F.conv2d(x, w, None, strides, pads, dilations, groups)
    if ctx.attr("fuse_relu", False):   # the inference transpiler's fold
        out = torch.relu(out)
    ctx.set_output("Output", out)


@register_op("depthwise_conv2d")
def depthwise_conv2d(ctx):
    """conv2d with groups defaulting to the input channels; always
    cuDNN's grouped convolution (the 1x1 dot form holds for groups 1
    only)."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    strides, pads, dilations, groups = _conv_attrs(ctx, x)
    with cudnn_fp32_exact():
        out = F.conv2d(x, w, None, strides, pads, dilations, groups)
    ctx.set_output("Output", out)


@register_grad("conv2d")
def conv2d_grad(ctx):
    """The default grad desc (Input, Filter, Output, Output@GRAD), lowered
    by one convolution backward: dInput and dFilter are computed directly
    from Input and Filter, only those the desc asks for; the forward is
    not run again.  fuse_relu masks the output grad where the relu'd
    Output is 0.  depthwise_conv2d's grad is the same lowering."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    gy = ctx.input("Output@GRAD").to(x.dtype)
    if ctx.attr("fuse_relu", False):
        gy = gy * (ctx.input("Output") > 0).to(gy.dtype)
    strides, pads, dilations, groups = _conv_attrs(ctx, x)
    mask = [ctx.wants("Input@GRAD"), ctx.wants("Filter@GRAD"), False]
    with cudnn_fp32_exact():
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, strides, pads, dilations, False, [0, 0], groups,
            mask)
    if mask[0]:
        ctx.set_output("Input@GRAD", gx)
    if mask[1]:
        ctx.set_output("Filter@GRAD", gw)


register_grad("depthwise_conv2d")(conv2d_grad)


def _pool_window(ctx, x):
    """(ksize, strides, low pads, high pads) as the JAX lowering resolves
    them: global pooling takes the whole map; ceil_mode pads the bottom
    and right so the last partial window counts."""
    ksize = _pair(ctx.attr("ksize", [1, 1]))
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    if ctx.attr("global_pooling", False) or (ctx.attr("adaptive", False)
                                             and ksize == [1, 1]):
        ksize = [x.shape[2], x.shape[3]]
        strides, pads = [1, 1], [0, 0]
    pad_hi = list(pads)
    if ctx.attr("ceil_mode", False):
        for d, (inp, k, s, p) in enumerate(
                zip((x.shape[2], x.shape[3]), ksize, strides, pads)):
            rem = (inp + 2 * p - k) % s
            if rem:
                pad_hi[d] = p + (s - rem)
    return ksize, strides, pads, pad_hi


@register_op("pool2d")
def pool2d(ctx):
    """NCHW max pooling (padding reads as -inf) or avg pooling (padding
    reads as 0; `exclusive` divides by the window's in-bounds count).  The
    grad is the registry's generic one: the replay is one pooling op."""
    x = ctx.input("X")
    ksize, strides, pads, pad_hi = _pool_window(ctx, x)
    padded = pad_hi != pads or pads[0] or pads[1]
    pad4 = (pads[1], pad_hi[1], pads[0], pad_hi[0])
    if ctx.attr("pooling_type", "max") == "max":
        if pad_hi == pads and all(p <= k // 2 for p, k in zip(pads, ksize)):
            out = F.max_pool2d(x, ksize, strides, pads)
        else:   # asymmetric or wide padding: pad with -inf explicitly
            out = F.max_pool2d(F.pad(x, pad4, value=-math.inf), ksize,
                               strides)
        ctx.set_output("Out", out)
        return
    xp = F.pad(x, pad4) if padded else x
    summed = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
    if ctx.attr("exclusive", True) and padded:
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                device=x.device), pad4)
        counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        out = summed / counts
    else:
        out = summed / (ksize[0] * ksize[1])
    ctx.set_output("Out", out)


def _bn_axes(ctx, x):
    c_axis = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = tuple(x.shape[c_axis] if i == c_axis else 1
                   for i in range(x.dim()))
    return c_axis, axes, bshape


def _batch_stats(xf, axes):
    """Batch mean and E[x^2] - E[x]^2 variance in float32, the JAX
    lowering's formula (not torch's two-pass variance)."""
    mean = xf.mean(dim=axes)
    return mean, xf.square().mean(dim=axes) - mean.square()


@register_op("batch_norm")
def batch_norm(ctx):
    """Train mode: batch statistics and the running-stat update
    (MeanOut/VarianceOut are the running-stat vars themselves); test mode
    or use_global_stats: the running stats.  Statistics in float32
    whatever the storage dtype; SavedVariance holds 1/sqrt(var + eps); the
    optional fused act "relu" applies after the affine."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean, var = ctx.input("Mean"), ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    _, axes, bshape = _bn_axes(ctx, x)
    xf = x.float()
    if ctx.attr("is_test", False) or ctx.attr("use_global_stats", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        use_mean, use_var = _batch_stats(xf, axes)
        mean_out = momentum * mean + (1.0 - momentum) * use_mean
        var_out = momentum * var + (1.0 - momentum) * use_var
    rstd = 1.0 / torch.sqrt(use_var.float() + eps)
    y = ((xf - use_mean.float().reshape(bshape)) * rstd.reshape(bshape)
         * scale.float().reshape(bshape) + bias.float().reshape(bshape))
    if ctx.attr("act") == "relu":
        y = torch.relu(y)
    ctx.set_output("Y", y.to(x.dtype))
    # running stats keep their storage dtype (float32 under AMP)
    ctx.set_output("MeanOut", mean_out.to(mean.dtype))
    ctx.set_output("VarianceOut", var_out.to(var.dtype))
    ctx.set_output("SavedMean", use_mean.to(mean.dtype))
    ctx.set_output("SavedVariance", rstd.to(var.dtype))


@register_grad_maker("batch_norm")
def _batch_norm_grad_maker(op, block, no_grad_set):
    """Grads flow only to X, Scale and Bias (the running stats are state);
    the grad op reads the forward's saved statistics."""
    outs = {}
    for p in ("X", "Scale", "Bias"):
        n = op.input(p)[0]
        outs[p + "@GRAD"] = [None if n in no_grad_set else grad_var_name(n)]
    return [{
        "type": "batch_norm_grad",
        "inputs": {
            "X": list(op.input("X")),
            "Scale": list(op.input("Scale")),
            "Bias": list(op.input("Bias")),
            "Mean": list(op.input("Mean")),
            "Variance": list(op.input("Variance")),
            "SavedMean": list(op.output("SavedMean") or []),
            "SavedVariance": list(op.output("SavedVariance") or []),
            "Y@GRAD": [grad_var_name(op.output("Y")[0])],
        },
        "outputs": outs,
        "attrs": dict(op.attrs),
    }]


@register_op("batch_norm_grad", no_grad=True)
def batch_norm_grad(ctx):
    """BN backward from the forward's saved statistics, not a replay of
    the forward (which would reduce mean and variance from X again):

      x_hat = (x - mu) * rstd
      dBias = sum(gy);  dScale = sum(gy * x_hat)
      dX    = scale * rstd * (gy - (dBias + x_hat * dScale) / m)   [train]
      dX    = scale * rstd * gy                     [test, global stats]

    A grad op without saved statistics (standalone) reduces them from X.
    With act "relu" the pre-activation is recomputed from X and the
    statistics and masks the incoming grad; Y is never read."""
    x, scale, gy = ctx.input("X"), ctx.input("Scale"), ctx.input("Y@GRAD")
    eps = ctx.attr("epsilon", 1e-5)
    use_global = (ctx.attr("is_test", False)
                  or ctx.attr("use_global_stats", False))
    c_axis, axes, bshape = _bn_axes(ctx, x)
    saved_mean = ctx.input("SavedMean")
    saved_inv_std = ctx.input("SavedVariance")
    xf = x.float()
    if use_global:
        mu = ctx.input("Mean").float()
        rstd = 1.0 / torch.sqrt(ctx.input("Variance").float() + eps)
    elif saved_mean is not None and saved_inv_std is not None:
        mu, rstd = saved_mean.float(), saved_inv_std.float()
    else:
        mu, v = _batch_stats(xf, axes)
        rstd = 1.0 / torch.sqrt(v + eps)
    gyf = gy.float()
    x_hat = (xf - mu.reshape(bshape)) * rstd.reshape(bshape)
    if ctx.attr("act") == "relu":
        pre = (x_hat * scale.float().reshape(bshape)
               + ctx.input("Bias").float().reshape(bshape))
        gyf = torch.where(pre > 0.0, gyf, 0.0)
    dbias = gyf.sum(dim=axes)
    dscale = (gyf * x_hat).sum(dim=axes)
    coeff = (scale.float() * rstd).reshape(bshape)
    if use_global:
        gx = coeff * gyf
    else:
        m = xf.numel() // xf.shape[c_axis]
        gx = coeff * (gyf - (dbias.reshape(bshape)
                             + x_hat * dscale.reshape(bshape)) / m)
    ctx.set_output("X@GRAD", gx.to(x.dtype))
    ctx.set_output("Scale@GRAD", dscale.to(scale.dtype))
    ctx.set_output("Bias@GRAD", dbias.to(scale.dtype))


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


@register_op("lrn")
def lrn(ctx):
    """Local response normalisation across the channels of NCHW X
    (reference lrn_op.cc): MidOut = k + alpha * (the sum of x^2 over a
    window of n channels, zero-padded at the edges), Out = X /
    MidOut^beta.  The grad is the registry's generic one."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    half, c = n // 2, x.shape[1]
    sq = F.pad(x.square(), (0, 0, 0, 0, half, n - 1 - half))
    acc = sq[:, 0:c]
    for i in range(1, n):
        acc = acc + sq[:, i:i + c]
    mid = ctx.attr("k", 1.0) + ctx.attr("alpha", 1e-4) * acc
    ctx.set_output("MidOut", mid)
    ctx.set_output("Out", x / torch.pow(mid, ctx.attr("beta", 0.75)))
