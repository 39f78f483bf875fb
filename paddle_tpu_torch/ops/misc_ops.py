"""check_prefix_mask (paddle_tpu/ops/misc_ops.py:334-357) and fc
(:283-296).

BERT reduces its [B, S] 0/1 input_mask to per-row key lengths for the
attention kernels' length masks, which cannot represent a hole in the
middle of a row.  This op is the identity and checks that every row is a
prefix mask (non-increasing along S).  The JAX package checks only when
the value is concrete (its interpret executor), not under tracing
(:341-346).  The port checks whenever the op runs eagerly: on the mask's
device, reading back one boolean, and only on a failure the first bad
row.  Inside a CUDA graph capture (the Executor's jit path) it does not
check, since reading a value back is a host sync a capture cannot hold.
"""

from __future__ import annotations

import math

import torch

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
