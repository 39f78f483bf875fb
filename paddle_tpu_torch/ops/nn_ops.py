"""NN ops: the convolutions (conv2d, depthwise_conv2d, conv3d and the
transposed conv2d_transpose, depthwise_conv2d_transpose,
conv3d_transpose), each with a grad that does not replay the forward,
the pools (pool2d, pool3d, max_pool2d_with_index, max_pool3d_with_index,
unpool, spp), batch_norm with its hand-written grad, layer_norm and its
recomputing grad, group_norm, lrn, norm, the resizes (bilinear_interp,
nearest_interp), im2sequence, label_smooth and cos_sim.

Counterparts of paddle_tpu/ops/nn_ops.py (conv2d :49-75 with the
conv1x1_as_dot branch :33-46, depthwise_conv2d :78-96, conv3d :99,
conv2d_transpose :118-150, pool2d :153-193, pool3d :196, batch_norm
:219-267, its grad maker :270 and batch_norm_grad :298-358, layer_norm
:361, group_norm :390, lrn :413-429, bilinear_interp/nearest_interp
:432-457, im2sequence :459, norm :489, label_smooth :500, cos_sim :511,
conv3d_transpose :524, depthwise_conv2d_transpose :555,
max_pool2d_with_index :567, max_pool3d_with_index :601, unpool :640,
spp :664).  Layouts are the JAX package's: NCHW/NCDHW inputs, OIHW
filters, IOHW for the transposed convolutions.  A convolution is a
library call (cuDNN on the card), as the JAX package leaves it to XLA
outside any Pallas kernel; a transposed one is `aten.convolution` with
`transposed`, which computes what the JAX package's lhs-dilated
convolution with the flipped, regrouped filter computes.

cuDNN rounds float32 convolutions through TF32 unless
`torch.backends.cudnn.allow_tf32` is off (its default is on, unlike
matmul's), so every conv lowering turns it off around its call, and the
grads are hand-written `convolution_backward` calls under the same
guard (an autograd replay would run the backward convolutions outside
it): a float32 conv runs in full float32.

The resizes follow `jax.image.resize`, the JAX lowering, not Fluid 1.0's
align-corners op: half-pixel centres, and a bilinear downscale is
antialiased (the triangle kernel widened by the inverse scale, each
output's weights renormalised); nearest takes input floor((i + 0.5) *
in / out).  `F.interpolate` differs on a bilinear downscale, so the
weights are built here, as JAX builds them, and applied as two
products.
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


# ----------------------------------------------- 3-D and transposed convs

# op type -> (spatial dims, transposed)
_CONV_ND = {
    "conv3d": (3, False),
    "conv2d_transpose": (2, True),
    "conv3d_transpose": (3, True),
    "depthwise_conv2d_transpose": (2, True),
}


def _conv_nd_args(ctx):
    """(spatial dims, transposed, strides, paddings, dilations, groups)
    of the conv op behind `ctx` (its grad's included); a groups attr of 0
    or None means 1, as the JAX lowerings read it."""
    op_type = ctx.op_type[:-len("_grad")] if ctx.op_type.endswith(
        "_grad") else ctx.op_type
    nd, transposed = _CONV_ND[op_type]
    return (nd, transposed, _pair(ctx.attr("strides", [1] * nd), nd),
            _pair(ctx.attr("paddings", [0] * nd), nd),
            _pair(ctx.attr("dilations", [1] * nd), nd),
            ctx.attr("groups", 1) or 1)


def conv_nd(ctx):
    """Input NC(D)HW; Filter OI(D)HW, or I(O/g)(D)HW when transposed (the
    output size (in - 1) * stride - 2 * pad + dilation * (k - 1) + 1)."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    nd, transposed, strides, pads, dilations, groups = _conv_nd_args(ctx)
    with cudnn_fp32_exact():
        out = torch.ops.aten.convolution(x, w, None, strides, pads,
                                         dilations, transposed, [0] * nd,
                                         groups)
    ctx.set_output("Output", out)


def conv_nd_grad(ctx):
    """dInput and dFilter of `conv_nd` by one convolution backward, only
    those the desc asks for; the forward is not run again."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    gy = ctx.input("Output@GRAD").to(x.dtype)
    nd, transposed, strides, pads, dilations, groups = _conv_nd_args(ctx)
    mask = [ctx.wants("Input@GRAD"), ctx.wants("Filter@GRAD"), False]
    with cudnn_fp32_exact():
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, strides, pads, dilations, transposed, [0] * nd,
            groups, mask)
    if mask[0]:
        ctx.set_output("Input@GRAD", gx)
    if mask[1]:
        ctx.set_output("Filter@GRAD", gw)


for _op in _CONV_ND:
    register_op(_op)(conv_nd)
    register_grad(_op)(conv_nd_grad)


# ------------------------------------------------------------------ pools


def _window(ctx, x, nd):
    """(ksize, strides, pads) with global pooling resolved."""
    ksize = _pair(ctx.attr("ksize", [1] * nd), nd)
    strides = _pair(ctx.attr("strides", [1] * nd), nd)
    pads = _pair(ctx.attr("paddings", [0] * nd), nd)
    if ctx.attr("global_pooling", False):
        return list(x.shape[2:]), [1] * nd, [0] * nd
    return ksize, strides, pads


def _sym_pad(pads):
    """Symmetric pads, first spatial dim first -> F.pad's list."""
    flat = []
    for p in reversed(pads):
        flat += [p, p]
    return flat


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


@register_op("pool3d")
def pool3d(ctx):
    """NCDHW max pooling (padding reads as -inf) or average pooling
    (padding reads as 0, always divided by the whole window)."""
    x = ctx.input("X")
    ksize, strides, pads = _window(ctx, x, 3)
    if ctx.attr("pooling_type", "max") == "max":
        out = F.max_pool3d(F.pad(x, _sym_pad(pads), value=-math.inf), ksize,
                           strides)
    else:
        out = F.avg_pool3d(F.pad(x, _sym_pad(pads)), ksize, strides)
    ctx.set_output("Out", out)


def _max_pool_with_index(ctx, nd):
    """Max pooling and, as int32 Mask, each maximum's flat index within
    its input plane (volume) of the unpadded X (reference
    pool_with_index_op.cc)."""
    x = ctx.input("X")
    ksize, strides, pads = _window(ctx, x, nd)
    xp = F.pad(x, _sym_pad(pads), value=-math.inf)
    out, idx = _MAX_POOL[nd](xp, ksize, strides, return_indices=True)
    # a flat index of the padded plane -> the unpadded plane's
    coords, rest = [], idx
    for d in reversed(range(nd)):
        size = xp.shape[2 + d]
        coords.append(rest % size - pads[d])
        rest = torch.div(rest, size, rounding_mode="floor")
    flat = torch.zeros_like(idx)
    for d, c in zip(range(nd), reversed(coords)):
        flat = flat * x.shape[2 + d] + c
    ctx.set_output("Out", out)
    ctx.set_output("Mask", flat.to(torch.int32))


@register_op("max_pool2d_with_index")
def max_pool2d_with_index(ctx):
    _max_pool_with_index(ctx, 2)


@register_op("max_pool3d_with_index")
def max_pool3d_with_index(ctx):
    _max_pool_with_index(ctx, 3)


@register_op("unpool")
def unpool(ctx):
    """Max unpooling: each pooled value written at the flat position its
    Indices entry names in the [H_out, W_out] plane (unpooled_size, or
    the pool's inverse size), zeros elsewhere; an index outside the
    plane writes nothing (reference unpool_op.cc)."""
    x, mask = ctx.input("X"), ctx.input("Indices")
    out_hw = list(ctx.attr("unpooled_size", []) or [])
    if not out_hw:
        ksize = _pair(ctx.attr("ksize", [1, 1]))
        strides = _pair(ctx.attr("strides", [1, 1]))
        pads = _pair(ctx.attr("paddings", [0, 0]))
        out_hw = [(x.shape[2 + i] - 1) * strides[i] - 2 * pads[i] + ksize[i]
                  for i in range(2)]
    n, c = x.shape[0], x.shape[1]
    size = out_hw[0] * out_hw[1]
    idx = mask.reshape(n, c, -1).long()
    idx = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size))     # a spare slot
    flat = torch.zeros((n, c, size + 1), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, idx, x.reshape(n, c, -1))
    ctx.set_output("Out", flat[:, :, :size].reshape(n, c, *out_hw))


@register_op("spp")
def spp(ctx):
    """Spatial pyramid pooling: level l pools X into 2^l x 2^l bins (the
    window ceil(H / 2^l), the padding split around the map), each level
    flattened, all joined along the features (reference spp_op.cc); the
    average counts only the map's own elements."""
    x = ctx.input("X")
    height = int(ctx.attr("pyramid_height"))
    ptype = str(ctx.attr("pooling_type", "max"))
    n, _, h, w = x.shape
    outs = []
    for level in range(height):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pad4 = (pw, kw * bins - w - pw, ph, kh * bins - h - ph)
        if ptype == "max":
            o = F.max_pool2d(F.pad(x, pad4, value=-math.inf), (kh, kw))
        else:
            s = F.avg_pool2d(F.pad(x, pad4), (kh, kw), divisor_override=1)
            ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype,
                                    device=x.device), pad4)
            o = s / F.avg_pool2d(ones, (kh, kw), divisor_override=1)
        outs.append(o.reshape(n, -1))
    ctx.set_output("Out", torch.cat(outs, dim=1))


# ---------------------------------------------------------- normalisation


@register_op("group_norm")
def group_norm(ctx):
    """NCHW normalised over each group of channels and the spatial dims,
    in X's dtype, then Scale and Bias per channel; Mean and Variance
    [N, groups]."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    g = ctx.attr("groups")
    eps = ctx.attr("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = torch.square(xg - mean).mean(dim=axes, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    ctx.set_output("Y", y)
    ctx.set_output("Mean", mean.reshape(n, g))
    ctx.set_output("Variance", var.reshape(n, g))


@register_op("norm")
def norm(ctx):
    """X / sqrt(sum(X^2 along axis) + epsilon); Norm is the divisor."""
    x = ctx.input("X")
    n = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr("axis", 1),
                             keepdim=True) + ctx.attr("epsilon", 1e-10))
    ctx.set_output("Norm", n)
    ctx.set_output("Out", x / n)


# ---------------------------------------------------------------- resizes


def _out_hw(ctx):
    """OutSize (read on the host: not for a captured segment; the layers
    never emit it) or the out_h / out_w attrs."""
    if ctx.has_input("OutSize"):
        return [int(s) for s in ctx.input("OutSize").reshape(-1).tolist()]
    return [int(ctx.attr("out_h")), int(ctx.attr("out_w"))]


def _bilinear_weights(m, n, device):
    """jax.image's weight matrix [m, n] (compute_weight_mat with the
    triangle kernel, antialiased, translation 0) in float32."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    dist = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(dist), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@register_op("bilinear_interp")
def bilinear_interp(ctx):
    """NCHW resized to (out_h, out_w) as jax.image.resize(method=
    "bilinear") resizes it; a dim whose size does not change is left
    alone; computed in float32 for an integer X, returned in X's
    dtype."""
    x = ctx.input("X")
    size = _out_hw(ctx)
    y = x if x.is_floating_point() else x.float()
    for d, n in zip((2, 3), size):
        m = y.shape[d]
        if m == n:
            continue
        w = _bilinear_weights(m, n, y.device).to(y.dtype)
        y = torch.movedim(torch.matmul(torch.movedim(y, d, -1), w), -1, d)
    ctx.set_output("Out", y.to(x.dtype))


@register_op("nearest_interp")
def nearest_interp(ctx):
    """NCHW resized by nearest neighbour as jax.image.resize(method=
    "nearest"): output i reads input floor((i + 0.5) * in / out), in
    float32."""
    x = ctx.input("X")
    out = x
    for d, n in zip((2, 3), _out_hw(ctx)):
        m = out.shape[d]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32,
                                        device=x.device) + 0.5) * m / n)
        # an index, not index_select: its backward accumulates repeated
        # sources by a sort, in a fixed order (index_select's by atomics)
        idx = [slice(None)] * out.dim()
        idx[d] = src.to(torch.int64)
        out = out[tuple(idx)]
    ctx.set_output("Out", out)


@register_op("im2sequence")
def im2sequence(ctx):
    """Every kernels-sized patch of the padded NCHW map (paddings [top,
    left, bottom, right]) as one row of C * kh * kw, rows ordered by
    image, then patch row and column (reference im2sequence_op.cc)."""
    x = ctx.input("X")
    kh, kw = ctx.attr("kernels")
    sh, sw = ctx.attr("strides", [1, 1])
    p = ctx.attr("paddings", [0, 0, 0, 0])
    n, c = x.shape[0], x.shape[1]
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    hh = (xp.shape[2] - kh) // sh + 1
    ww = (xp.shape[3] - kw) // sw + 1
    patches = [xp[:, :, i:i + hh * sh:sh, j:j + ww * sw:sw]
               for i in range(kh) for j in range(kw)]
    stacked = torch.stack(patches, dim=2).reshape(n, c * kh * kw, hh, ww)
    ctx.set_output("Out", stacked.permute(0, 2, 3, 1).reshape(n * hh * ww,
                                                              -1))


@register_op("label_smooth")
def label_smooth(ctx):
    """(1 - epsilon) X + epsilon * PriorDist, the prior uniform over the
    last dim by default."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 0.1)
    prior = ctx.input("PriorDist")
    k = x.shape[-1]
    smooth = prior if prior is not None else torch.full(
        (k,), 1.0 / k, dtype=x.dtype, device=x.device)
    ctx.set_output("Out", (1.0 - eps) * x + eps * smooth)


@register_op("cos_sim")
def cos_sim(ctx):
    """Row-wise cosine similarity; Y may be one row against all of X's;
    XNorm and YNorm are the rows' norms."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    prod = torch.sum(x * y, dim=-1, keepdim=True)
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)
    ctx.set_output("Out", prod / (xn * yn))
