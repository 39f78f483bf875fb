"""The long tail of tensor and math ops (paddle_tpu/ops/misc_ops.py:24-
334): flatten, flatten2, crop, multiplex, random_crop,
pad_constant_like, is_empty, minus, l1_norm, squared_l2_distance,
modified_huber_loss, mean_iou, affine_channel, bilinear_tensor_product,
row_conv, ctc_align, conv_shift, polygon_box_transform, fc,
fused_elemwise_activation and check_prefix_mask.

Each is the JAX package's lowering in torch, its grad the registry's
generic one.  The LoD-bearing reference ops (row_conv, ctc_align) take
the JAX package's dense form: [B, T, ...] batches and an int SeqLen.
Offsets read from a tensor (crop's Offsets, random_crop's draw) stay on
the device: the slice is an index_select with the start clamped into
range, as lax.dynamic_slice clamps it, so no value is read back.

check_prefix_mask: BERT reduces its [B, S] 0/1 input_mask to per-row key
lengths for the attention kernels' length masks, which cannot represent
a hole in the middle of a row.  This op is the identity and checks that
every row is a prefix mask (non-increasing along S).  The JAX package
checks only when the value is concrete (its interpret executor), not
under tracing (:341-346).  The port checks whenever the op runs eagerly:
on the mask's device, reading back one boolean, and only on a failure
the first bad row.  Inside a CUDA graph capture (the Executor's jit path)
it does not check, since reading a value back is a host sync a capture
cannot hold.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op


@register_op("fc")
def fc(ctx):
    """Input @ W + Bias as one op, the inference transpiler's fc_fuse of
    mul + bias add: Input flattened to [prod(dims[:in_num_col_dims]),
    rest], the product accumulated in float32 (torch.matmul; no TF32 in
    float32) and cast to Input's dtype, then the bias added with torch's
    promotion (the JAX lowering's jnp.matmul with
    preferred_element_type=float32, then + bias)."""
    x, w = ctx.input("Input"), ctx.input("W")
    bias = ctx.input("Bias")
    ncd = int(ctx.attr("in_num_col_dims", 1))
    lead = tuple(x.shape[:ncd])
    x2 = x.reshape(math.prod(lead), -1)
    common = torch.promote_types(x.dtype, w.dtype)
    out = torch.matmul(x2.to(common), w.to(common)).to(x.dtype)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    ctx.set_output("Out", out.reshape(lead + (w.shape[1],)))


def _capturing(x):
    return x.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


@register_op("check_prefix_mask", no_grad=True)
def check_prefix_mask(ctx):
    x = ctx.input("X")
    if x.device.type != "meta" and not _capturing(x):
        m = x != 0
        bad = m[..., 1:] & ~m[..., :-1]      # a real token after padding
        if bool(bad.any()):
            row = int(bad.reshape(bad.shape[0], -1).any(-1).nonzero()[0, 0])
            raise ValueError(
                f"input_mask row {row} is not a prefix mask: found a real "
                "token after padding (mask must be non-increasing along the "
                "sequence axis — BERT pads at the end). use_input_mask "
                "reduces the mask to per-row lengths, so a mid-sequence hole "
                "would silently mis-attend.")
    ctx.set_output("Out", x)


def _flat2d(x, axis):
    rows = math.prod(x.shape[:axis])
    return x.reshape(rows, -1 if x.numel() else 0)


@register_op("flatten")
def flatten(ctx):
    """X as 2-D: the dims before `axis` as rows, the rest as columns
    (reference flatten_op.cc)."""
    ctx.set_output("Out", _flat2d(ctx.input("X"), int(ctx.attr("axis", 1))))


@register_op("flatten2")
def flatten2(ctx):
    """flatten, and the zero-size XShape [0, *X.shape] (no gradient flows
    through it)."""
    x = ctx.input("X")
    ctx.set_output("Out", _flat2d(x, int(ctx.attr("axis", 1))))
    ctx.set_output("XShape", torch.zeros((0,) + tuple(x.shape),
                                         dtype=x.dtype, device=x.device))


def _dynamic_slice(x, starts, sizes):
    """x[starts[d] : starts[d] + sizes[d]] in every dim, each start a
    0-d tensor clamped into [0, dim - size] (lax.dynamic_slice)."""
    for d, (st, size) in enumerate(zip(starts, sizes)):
        if size == x.shape[d]:
            continue
        st = torch.clamp(st.to(torch.int64), 0, x.shape[d] - size)
        idx = st + torch.arange(size, device=x.device)
        x = x.index_select(d, idx)
    return x


@register_op("crop")
def crop(ctx):
    """X sliced at offsets (the `offsets` attr, or the Offsets input) to
    `shape` (the attr, or Y's shape) (reference crop_op.cc)."""
    x = ctx.input("X")
    y = ctx.input("Y")
    shape = list(y.shape) if y is not None else list(ctx.attr("shape"))
    offs = ctx.input("Offsets")
    if offs is not None:
        offs = offs.reshape(-1)
        out = _dynamic_slice(x, [offs[i] for i in range(x.dim())], shape)
    else:
        offsets = list(ctx.attr("offsets") or [0] * x.dim())
        out = x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]
    ctx.set_output("Out", out)


@register_op("multiplex")
def multiplex(ctx):
    """Out row i = X[Ids[i]] row i (reference multiplex_op.cc)."""
    ids = ctx.input("Ids").reshape(-1).long()
    stacked = torch.stack(list(ctx.inputs("X")), dim=0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    ctx.set_output("Out", stacked[ids, rows])


@register_op("random_crop", stateful=True, no_grad=True)
def random_crop(ctx):
    """The trailing len(shape) dims cropped to `shape` at one uniform
    random offset (the leading dims are kept whole; reference
    random_crop_op.cc)."""
    x = ctx.input("X")
    shape = [int(s) for s in ctx.attr("shape")]
    k = len(shape)
    lead = x.dim() - k
    gen = None if x.device.type == "meta" else ctx.rng()
    draw = torch.randint(0, 1 << 30, (k,), generator=gen, dtype=torch.int64,
                         device=x.device)
    offs = [draw[i] % (x.shape[lead + i] - shape[i] + 1) for i in range(k)]
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    ctx.set_output("Out", _dynamic_slice(x, [zero] * lead + offs,
                                         list(x.shape[:lead]) + shape))


@register_op("pad_constant_like")
def pad_constant_like(ctx):
    """Y padded at the end of every dim up to X's shape with pad_value
    (reference pad_constant_like_op.cc)."""
    x, y = ctx.input("X"), ctx.input("Y")
    flat = []
    for i in reversed(range(x.dim())):
        flat += [0, x.shape[i] - y.shape[i]]
    ctx.set_output("Out", F.pad(y, flat, value=ctx.attr("pad_value", 0.0)))


@register_op("is_empty", no_grad=True)
def is_empty(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.full((1,), x.numel() == 0, dtype=torch.bool,
                                     device=x.device))


@register_op("minus")
def minus(ctx):
    ctx.set_output("Out", ctx.input("X") - ctx.input("Y"))


@register_op("l1_norm")
def l1_norm(ctx):
    ctx.set_output("Out", torch.sum(torch.abs(ctx.input("X"))).reshape(1))


@register_op("squared_l2_distance")
def squared_l2_distance(ctx):
    """Row-wise ||x - y||^2 as [N, 1]; Y may have one row (broadcast)."""
    sub = ctx.input("X") - ctx.input("Y")
    ctx.set_output("sub_result", sub)
    ctx.set_output("Out", torch.sum(torch.square(sub), dim=tuple(
        range(1, sub.dim()))).reshape(-1, 1))


@register_op("modified_huber_loss")
def modified_huber_loss(ctx):
    """z = (2y - 1) x for labels y in {0, 1}; loss max(0, 1 - z)^2 where
    z >= -1, else -4z, as [N, 1]."""
    x, y = ctx.input("X"), ctx.input("Y")
    z = (2.0 * y.to(x.dtype) - 1.0) * x
    inter = torch.clamp(1.0 - z, min=0.0)
    loss = torch.where(z >= -1.0, torch.square(inter), -4.0 * z)
    ctx.set_output("IntermediateVal", inter)
    ctx.set_output("Out", loss.reshape(-1, 1))


def _count_into(n, idx, values):
    """An int32 [n] of `values` summed at `idx`; an index outside [0, n)
    adds nothing (the JAX lowering's mode="drop")."""
    ok = (idx >= 0) & (idx < n)
    out = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return out.index_add(0, torch.where(ok, idx, torch.zeros_like(idx)),
                         (values & ok).to(torch.int32))


@register_op("mean_iou", no_grad=True)
def mean_iou(ctx):
    """Per-class correct and wrong counts (streamed through InCorrects,
    InWrongs, InMeanIou) and the mean IoU over the classes with a
    nonzero denominator (reference mean_iou_op.h)."""
    pred = ctx.input("Predictions").reshape(-1).long()
    label = ctx.input("Labels").reshape(-1).long()
    nc = int(ctx.attr("num_classes"))
    hit = pred == label
    correct = _count_into(nc, pred, hit)
    wrong = _count_into(nc, label, ~hit) + _count_into(nc, pred, ~hit)
    for arr in ctx.inputs("InWrongs"):
        if arr is not None:
            wrong = wrong + arr.to(torch.int32)
    for arr in ctx.inputs("InCorrects"):
        if arr is not None:
            correct = correct + arr.to(torch.int32)
    denom = wrong + correct
    valid = torch.sum((denom > 0).to(torch.int32))
    iou = correct.to(torch.float32) / torch.clamp(denom, min=1).to(
        torch.float32)
    mean = torch.sum(iou) / torch.clamp(valid, min=1).to(torch.float32)
    for arr in ctx.inputs("InMeanIou"):
        if arr is not None:
            mean = mean + arr.reshape(())
    ctx.set_output("OutMeanIou", mean.reshape(1))
    ctx.set_output("OutWrong", wrong)
    ctx.set_output("OutCorrect", correct)


@register_op("affine_channel")
def affine_channel(ctx):
    """y = x * Scale[c] + Bias[c] per channel, NCHW or NHWC (a frozen
    batch norm)."""
    x = ctx.input("X")
    c_axis = 1 if str(ctx.attr("data_layout", "NCHW")) == "NCHW" else (
        x.dim() - 1)
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    ctx.set_output("Out", x * ctx.input("Scale").reshape(shape)
                   + ctx.input("Bias").reshape(shape))


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx):
    """Out[n, k] = X[n] W_k Y[n]^T (+ Bias[k]), accumulated in float32
    and returned in X's dtype."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("nd,kde,ne->nk", x.float(), w.float(),
                       y.float()).to(x.dtype)
    b = ctx.input("Bias")
    if b is not None:
        out = out + b.reshape(1, -1)
    ctx.set_output("Out", out)


@register_op("row_conv")
def row_conv(ctx):
    """Look-ahead convolution over time: out[t] = sum_j x[t + j] *
    Filter[j] within each sequence, X [B, T, D], the tail past SeqLen
    read as zeros (reference row_conv_op.cc)."""
    x, w = ctx.input("X"), ctx.input("Filter")
    lengths = ctx.input("SeqLen")
    fc_len, t = w.shape[0], x.shape[1]
    if lengths is not None:
        live = torch.arange(t, device=x.device)[None, :, None] < \
            lengths.reshape(-1, 1, 1)
        x = x * live.to(x.dtype)
    padded = F.pad(x, (0, 0, 0, fc_len - 1))
    out = torch.zeros_like(x)
    for j in range(fc_len):
        out = out + padded[:, j:j + t, :] * w[j]
    ctx.set_output("Out", out)


@register_op("ctc_align", no_grad=True)
def ctc_align(ctx):
    """CTC decoding's merge: repeats between blanks merged (with
    merge_repeated), blanks dropped, the kept tokens packed to the front
    of each [T] row with zeros behind, and OutLength [B] (reference
    ctc_align_op.cc in the dense form; [B, T, 1] input stays 3-D)."""
    x = ctx.input("Input")
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    if squeeze:
        x = x[..., 0]
    lengths = ctx.input("SeqLen")
    blank = int(ctx.attr("blank", 0))
    b, t = x.shape
    prev = torch.cat([torch.full((b, 1), -1, dtype=x.dtype, device=x.device),
                      x[:, :-1]], dim=1)
    keep = x != blank
    if bool(ctx.attr("merge_repeated", True)):
        keep = keep & (x != prev)
    if lengths is not None:
        keep = keep & (torch.arange(t, device=x.device)[None, :]
                       < lengths.reshape(-1, 1))
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    pos = torch.where(keep, pos, torch.full_like(pos, t))  # off the end
    out = torch.zeros((b, t + 1), dtype=x.dtype, device=x.device)
    out = out.scatter(1, pos, x)[:, :t]
    ctx.set_output("Output", out[..., None] if squeeze else out)
    ctx.set_output("OutLength", torch.sum(keep.to(torch.int32), dim=1,
                                          dtype=torch.int32))


@register_op("conv_shift")
def conv_shift(ctx):
    """Circular convolution of each row of X [B, M] with Y [B, N] (N odd):
    Out[b, i] = sum_j X[b, (i + j - (N - 1) / 2) mod M] Y[b, j]."""
    x, y = ctx.input("X"), ctx.input("Y")
    m, n = x.shape[1], y.shape[1]
    half = (n - 1) // 2
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(n, device=x.device)[None, :] - half) % m
    ctx.set_output("Out", torch.einsum("bmn,bn->bm", x[:, idx], y))


@register_op("polygon_box_transform", no_grad=True)
def polygon_box_transform(ctx):
    """EAST's geometry offsets to absolute quad coordinates on the 4x
    grid: Input [N, 2n, H, W], even channels 4w - in, odd 4h - in."""
    x = ctx.input("Input")
    _, c, h, w = x.shape
    xs = (4.0 * torch.arange(w, dtype=x.dtype, device=x.device)).reshape(
        1, 1, 1, w)
    ys = (4.0 * torch.arange(h, dtype=x.dtype, device=x.device)).reshape(
        1, 1, h, 1)
    even = (torch.arange(c, device=x.device) % 2 == 0).reshape(1, c, 1, 1)
    ctx.set_output("Output", torch.where(even, xs - x, ys - x))


@register_op("fused_elemwise_activation")
def fused_elemwise_activation(ctx):
    """One binary functor (elementwise_add, elementwise_mul) and one unary
    (relu, scale) as one op: functor_list [f0, f1] is f0(f1(X, Y)) when
    f1 is the binary, else f0(X, f1(Y)); IntermediateOut is the inner
    result (reference fused_elemwise_activation_op.cc)."""
    x, y = ctx.input("X"), ctx.input("Y")
    f0, f1 = [str(f) for f in ctx.attr("functor_list")]
    scale = ctx.attr("scale", 1.0)

    def unary(name, v):
        if name == "relu":
            return torch.clamp(v, min=0.0)
        if name == "scale":
            return v * scale
        raise ValueError(f"unsupported unary functor {name}")

    def binary(name, a, b):
        if b.dim() < a.dim():   # aligned at the leading dims (axis -1)
            b = b.reshape(tuple(b.shape) + (1,) * (a.dim() - b.dim()))
        if name == "elementwise_add":
            return a + b
        if name == "elementwise_mul":
            return a * b
        raise ValueError(f"unsupported binary functor {name}")

    if f1 in ("elementwise_add", "elementwise_mul"):
        inter = binary(f1, x, y)
        out = unary(f0, inter)
    else:
        inter = unary(f1, y)
        out = binary(f0, x, inter)
    ctx.set_output("Out", out)
    ctx.set_output("IntermediateOut", inter)
