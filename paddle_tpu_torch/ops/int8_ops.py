"""Int8 inference ops: quantized_matmul and quantized_conv2d
(paddle_tpu/ops/int8_ops.py:60, :92), the deployed form that
`contrib.quantize.QuantizeTranspiler.freeze_int8(as_int8=True)` writes.

X/Y (Input/Filter) hold values on the int grid, as float storage straight
out of freeze_int8 or as int8 after convert_to_int8; both are rounded to
int8 (`_grid_to_int8`), multiplied with int32 accumulation, and dequantized
in the op's output:

    out = acc.float() * (a_scale * w_scale / float32(aq_range * wq_range))

in that order (the JAX package's `_dequant_const`), then `alpha` for a
`matmul`, relu after the dequant for a conv with `fuse_relu`.

The int8 x int8 -> int32 product is where the two devices part:

  * on the card, `torch._int_mm` (cuBLASLt's int8 path on the tensor
    cores; the JAX package leaves the same product to XLA with
    preferred_element_type=int32, outside any Pallas kernel).  It takes
    2-D operands only, more than 16 rows and K, N multiples of 8: rows are
    padded with zeros up to 32 and K, N up to multiples of 8 (exact), and
    the result sliced back.  The weight operand is passed column-major (A
    row-major, B column-major: the layout every cuBLASLt int8 kernel
    takes).  A conv with groups == 1 is an im2col of the int8 grid (a
    strided view, one copy) and one `_int_mm`; groups > 1 runs one
    `_int_mm` a group, exact but slow at depthwise widths (ROADMAP B);
  * the plain version, which the CPU runs and chip_smoke.py holds the card
    to: the same product in float64 over the grid values, rounded to
    int32.  It is exact while |acc| < 2^53; 127 * 127 * K stays far below.

There is no float32 product of grid values anywhere: at VGG-19's K = 4608
the worst case, 127^2 * 4608 = 74M, exceeds float32's 2^24.  A shape that
`_int_mm` refuses raises; nothing swaps paths quietly.  `launches` counts
`_int_mm` calls.  Both ops are inference only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .nn_ops import _pair
from .registry import register_op

_INT8_GRAD_ERROR = (
    "quantized int8 ops are inference-only (deployed freeze_int8(as_int8) "
    "form); rebuild the training program with QuantizeTranspiler."
    "training_transpile for QAT gradients"
)

# torch._int_mm calls on the card
launches = 0

_MIN_ROWS = 32   # _int_mm takes more than 16 rows; padded to 32


def _grid_to_int8(v):
    """Grid values -> int8 storage: round, then cast (lossless on what
    freeze_int8 writes, integers in [-127, 127]; int8 passes through)."""
    if v.dtype == torch.int8:
        return v
    return torch.round(v).to(torch.int8)


def _dequant_const(ctx):
    """a_scale * w_scale / float32(aq_range * wq_range), a 0-d float32."""
    a_scale = ctx.input("Scale").reshape(()).float()
    w_scale = ctx.input("WScale").reshape(()).float()
    aq = float(ctx.attr("aq_range", 127.0))
    wq = float(ctx.attr("wq_range", 127.0))
    # a 0-d tensor on the device, not a python scalar: CUDA divides by a
    # host scalar as a multiply by its reciprocal
    return a_scale * w_scale / torch.full((), aq * wq, dtype=torch.float32,
                                          device=a_scale.device)


# ---------------------------------------------------------------------------
# int8 x int8 -> int32
# ---------------------------------------------------------------------------


def int8_matmul_reference(a, b):
    """The plain version: torch.matmul semantics (1-D promotion,
    broadcast batch dims) over int8 operands, in float64, rounded to
    int32."""
    return torch.round(torch.matmul(a.double(), b.double())).to(torch.int32)


def _pad_to(t, rows, cols):
    r, c = t.shape
    if r == rows and c == cols:
        return t
    return F.pad(t, (0, cols - c, 0, rows - r))


def _int_mm_2d(a, b):
    """[M, K] x [K, N] int8 -> [M, N] int32 through torch._int_mm, padded
    with zeros to M >= 32 and K, N multiples of 8."""
    global launches
    m, k = a.shape
    n = b.shape[1]
    mp = max(m, _MIN_ROWS)
    kp = -(-k // 8) * 8
    np_ = -(-n // 8) * 8
    ap = _pad_to(a, mp, kp).contiguous()
    # B column-major: its transpose [N, K] row-major
    bt = _pad_to(b.t(), np_, kp).contiguous()
    out = torch._int_mm(ap, bt.t())
    launches += 1
    if mp != m or np_ != n:
        out = out[:m, :n]
    return out


def _int_mm_nd(a, b):
    """torch.matmul semantics over int8 operands with one _int_mm per
    batch element (one call when Y is 2-D: X's rows are flattened)."""
    squeeze_a = a.dim() == 1
    squeeze_b = b.dim() == 1
    if squeeze_a:
        a = a.unsqueeze(0)
    if squeeze_b:
        b = b.unsqueeze(1)
    if b.dim() == 2:
        lead = a.shape[:-1]
        out = _int_mm_2d(a.reshape(-1, a.shape[-1]), b)
        out = out.reshape(tuple(lead) + (b.shape[1],))
    else:
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        ab = a.expand(tuple(batch) + tuple(a.shape[-2:])).reshape(
            -1, *a.shape[-2:])
        bb = b.expand(tuple(batch) + tuple(b.shape[-2:])).reshape(
            -1, *b.shape[-2:])
        out = torch.stack([_int_mm_2d(x, y) for x, y in zip(ab, bb)])
        out = out.reshape(tuple(batch) + tuple(out.shape[-2:]))
    if squeeze_b:
        out = out.squeeze(-1)
    if squeeze_a:
        out = out.squeeze(-2)
    return out


def int8_matmul(a, b):
    """int8 x int8 -> int32 with torch.matmul semantics: `_int_mm` on the
    card, the plain version for tensors on the CPU (and the meta device of
    shape inference)."""
    if a.device.type == "cuda":
        return _int_mm_nd(a, b)
    if a.device.type in ("cpu", "meta"):
        return int8_matmul_reference(a, b)
    raise RuntimeError(f"int8_matmul: no path for device {a.device}")


def _im2col(x, kh, kw, strides, pads, dilations):
    """[B, C, H, W] -> ([B*OH*OW, C*kh*kw], OH, OW): every output
    position's receptive field, in the filter's (C, kh, kw) order, by a
    strided view of the zero-padded input and one copy (any dtype)."""
    sh, sw = strides
    dh, dw = dilations
    x = F.pad(x, (pads[1], pads[1], pads[0], pads[0]))
    eh, ew = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    cols = x.unfold(2, eh, sh).unfold(3, ew, sw)   # [B, C, OH, OW, eh, ew]
    if dh > 1 or dw > 1:
        cols = cols[..., ::dh, ::dw]
    b, c, oh, ow = cols.shape[:4]
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(b * oh * ow, c * kh * kw)
    return cols, oh, ow


def conv_by_gemm(xi, wi, strides, pads, dilations, groups, mm):
    """An int8 NCHW/OIHW conv as im2col + `mm` (one product a group),
    int32 [B, O, OH, OW]."""
    b, c = xi.shape[:2]
    o, cg, kh, kw = wi.shape
    og = o // groups
    outs = []
    for g in range(groups):
        cols, oh, ow = _im2col(xi[:, g * cg:(g + 1) * cg], kh, kw, strides,
                               pads, dilations)
        wg = wi[g * og:(g + 1) * og].reshape(og, cg * kh * kw)
        outs.append(mm(cols, wg.t()))                 # [B*OH*OW, og]
    out = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, oh, ow, o).permute(0, 3, 1, 2)


def int8_conv2d_reference(xi, wi, strides, pads, dilations, groups):
    """The plain version: the conv in float64 over the grid values,
    rounded to int32."""
    return torch.round(F.conv2d(xi.double(), wi.double(), None, strides,
                                pads, dilations, groups)).to(torch.int32)


def int8_conv2d(xi, wi, strides, pads, dilations, groups):
    """int8 conv -> int32: im2col + `_int_mm` on the card, the plain
    version on the CPU and the meta device."""
    if xi.device.type == "cuda":
        return conv_by_gemm(xi, wi, strides, pads, dilations, groups,
                            _int_mm_2d)
    if xi.device.type in ("cpu", "meta"):
        return int8_conv2d_reference(xi, wi, strides, pads, dilations,
                                     groups)
    raise RuntimeError(f"int8_conv2d: no path for device {xi.device}")


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


@register_op("quantized_matmul", no_grad=True, grad_error=_INT8_GRAD_ERROR)
def quantized_matmul(ctx):
    """Int8 mul/matmul.  orig_type "mul" flattens X/Y at
    {x,y}_num_col_dims (mul_op.cc); "matmul" takes the transpose flags
    and alpha (matmul_op.cc)."""
    x, y = ctx.input("X"), ctx.input("Y")
    xi, yi = _grid_to_int8(x), _grid_to_int8(y)
    if ctx.attr("orig_type", "mul") == "matmul":
        if xi.dim() > 1 and ctx.attr("transpose_X", False):
            xi = xi.transpose(-1, -2)
        if yi.dim() > 1 and ctx.attr("transpose_Y", False):
            yi = yi.transpose(-1, -2)
        out = int8_matmul(xi, yi).float() * _dequant_const(ctx)
        alpha = ctx.attr("alpha", 1.0)
        if alpha != 1.0:
            out = out * float(torch.tensor(alpha, dtype=torch.float32))
    else:
        xn = ctx.attr("x_num_col_dims", 1)
        yn = ctx.attr("y_num_col_dims", 1)
        xm = xi.reshape(math.prod(x.shape[:xn]), -1)
        ym = yi.reshape(math.prod(y.shape[:yn]), -1)
        out = int8_matmul(xm, ym).float() * _dequant_const(ctx)
        out = out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))
    ctx.set_output("Out", out)


@register_op("quantized_conv2d", no_grad=True, grad_error=_INT8_GRAD_ERROR)
def quantized_conv2d(ctx):
    """Int8 conv2d/depthwise_conv2d (orig_type keeps the name): conv_op.cc's
    geometry attrs, int32 accumulation, the dequant, then relu when
    `fuse_relu` (relu commutes with the positive scale)."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    dilations = _pair(ctx.attr("dilations", [1, 1]))
    groups = ctx.attr("groups", 1) or 1
    if ctx.attr("orig_type") == "depthwise_conv2d" and not ctx.attr("groups"):
        groups = x.shape[1]
    acc = int8_conv2d(_grid_to_int8(x), _grid_to_int8(w), strides, pads,
                      dilations, groups)
    out = acc.float() * _dequant_const(ctx)
    if ctx.attr("fuse_relu", False):
        out = torch.relu(out)
    ctx.set_output("Output", out)
