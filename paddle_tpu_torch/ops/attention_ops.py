"""Fused attention op and its kernel gate.

Counterpart of paddle_tpu/ops/attention_ops.py.  Layout: Q [B, Sq, H*D],
K/V [B, Sk, H*D]; optional SeqLen [B] key-padding lengths and an additive
Bias broadcastable to [B, H, Sq, Sk]; attrs num_heads, causal, scale
(0 => 1/sqrt(D)).

The gate (`_kernel_choice`, `_decode_choice`, `_backend_choice`) is the
JAX package's, with the same flags and defaults, and returns the same
tier names: "mha_block" | "flash" | "mha_decode" | "flash_decode" |
"composite".  Where the JAX package asks "is this a TPU?", the port asks
"is this tensor on the card?"; flag "interpret" routes CPU tensors to the
kernel wrappers too, which run their plain versions there.

This slice ports two kernels, mha_block and flash_decode.  The streaming
"flash" tier (kernel #3), the paged KV pool and the `seq_len_ramp`
verify/chunk window raise NotImplementedError; the sequence-parallel ring
has no branch, since the port has no device mesh yet.  All are later
slices in ROADMAP.md.
"""

from __future__ import annotations

import collections

import torch

from .. import flags
from .cuda import flash_decode as _fd
from .cuda import mha_block as _mha
from .registry import register_op

# calls routed to each tier (not counting shape inference on meta tensors)
TIER_CALLS = collections.Counter()


def _split_heads(x, num_heads):
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads)


def attention_reference(q, k, v, bias, *, num_heads, causal, scale):
    """Plain-torch attention; the numerical reference for every tier
    (attention_ops.py:33)."""
    qh = _split_heads(q, num_heads)
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    head_dim = qh.shape[-1]
    if not scale:
        scale = 1.0 / (head_dim ** 0.5)
    # scale q before the matmul, in q's dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", (qh * scale).float(), kh.float())
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        idx_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        idx_k = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(idx_k <= idx_q, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vh.dtype).float(),
                       vh.float())
    b, sq = q.shape[0], q.shape[1]
    return out.to(q.dtype).reshape(b, sq, -1)


def _seq_len_bias(seq_len, b, sk):
    """[B] lengths -> [B,1,1,Sk] additive key mask for the composite."""
    pos = torch.arange(sk, device=seq_len.device)[None, :]
    mask = pos < seq_len.reshape(b, 1).to(pos.dtype)
    zero = torch.zeros((), dtype=torch.float32, device=seq_len.device)
    return torch.where(mask, zero, -1e30).reshape(b, 1, 1, sk)


def flash_supported(q, k, num_heads, causal=False):
    """Shape gate of the streaming flash tier (flash_attention.py:78) —
    kept for routing parity; the tier itself is not ported yet."""
    if len(q.shape) != 3 or len(k.shape) != 3:
        return False
    if q.dtype not in (torch.float32, torch.bfloat16):
        return False
    head_dim = q.shape[-1] // num_heads
    if head_dim * num_heads != q.shape[-1] or head_dim % 64 != 0:
        return False
    return not (causal and q.shape[1] > k.shape[1])


def _on_card(x):
    return x.device.type == "cuda"


def _kernel_choice(q, k, num_heads, causal):
    """("mha_block" | "flash", "cuda" | "interpret") or None (composite):
    the JAX package's crossover gate (attention_ops.py:80)."""
    flag = flags.get("flash_attention")
    if flag == "0":
        return None
    mha_ok = flag != "flash" and _mha.supported(q, k, num_heads, causal)
    flash_ok = flash_supported(q, k, num_heads, causal)
    if flag == "interpret":
        if mha_ok:
            return "mha_block", "interpret"
        if flash_ok:
            return "flash", "interpret"
        return None
    if not _on_card(q):
        return None
    if mha_ok:
        return "mha_block", "cuda"
    force = flag in ("force", "1", "flash")
    if flash_ok and (force or q.shape[1] * k.shape[1]
                     >= flags.get("attn_flash_min_scores")):
        return "flash", "cuda"
    return None


def _decode_choice(q, k, num_heads):
    """Sq == 1 tier: ("flash_decode" | "mha_decode", mode) or None
    (attention_ops.py:131).  Below attn_decode_min_keys the single-block
    kernel serves the single query; at or above it, or where that kernel's
    gate refuses the shape, flash_decode does."""
    flag = flags.get("flash_attention")
    if flag == "0":
        return None
    if not _fd.decode_supported(q, k, num_heads):
        return None
    # the JAX gate asks its single-block kernel about an 8-row query (its
    # sublane floor); asking the same question keeps the two routings equal
    q8 = torch.empty((q.shape[0], 8, q.shape[2]), dtype=q.dtype,
                     device="meta")
    mha_ok = flag != "flash" and _mha.supported(q8, k, num_heads, False)
    streaming = (flag == "flash" or not mha_ok
                 or k.shape[1] >= flags.get("attn_decode_min_keys"))
    name = "flash_decode" if streaming else "mha_decode"
    if flag == "interpret":
        return name, "interpret"
    if not _on_card(q):
        return None
    return name, "cuda"


def _backend_choice(q, k, num_heads, causal, has_bias, has_seq_len=False):
    """(name, mode): the ONE selection cascade — _apply_attention executes
    what this returns.  A SeqLen mask rides every kernel tier; an additive
    bias takes the composite."""
    if not has_bias and q.shape[1] == 1 and k.shape[1] > 1:
        choice = _decode_choice(q, k, num_heads)
        if choice is not None:
            return choice
    if not has_bias:
        choice = _kernel_choice(q, k, num_heads, causal)
        if choice is not None:
            return choice
    return "composite", None


def backend_choice(q, k, num_heads, causal=False, bias=False, seq_len=False):
    """Which tier _apply_attention picks for these tensors (meta tensors
    work: the gate reads shape, dtype and device only)."""
    return _backend_choice(q, k, num_heads, causal,
                           bias is not None and bias is not False,
                           seq_len is not None and seq_len is not False)[0]


def _apply_attention(q, k, v, bias, *, num_heads, causal, scale,
                     seq_len=None, seq_len_ramp=False):
    """Gate-selected attention forward.  On meta tensors (shape inference)
    it is always the composite, never a kernel wrapper."""
    if seq_len_ramp:
        raise NotImplementedError(
            "fused_attention seq_len_ramp (the speculative-verify and "
            "chunked-prefill window) is not ported yet: it lands with the "
            "serving Scheduler slice (ROADMAP.md A)")
    name = "composite"
    if q.device.type != "meta":
        name, _ = _backend_choice(q, k, num_heads, causal, bias is not None,
                                  seq_len is not None)
        TIER_CALLS[name] += 1
    if name == "mha_block":
        return _mha.mha_attention(q, k, v, num_heads, causal, scale,
                                  key_len=seq_len)
    if name == "mha_decode":
        # Sq == 1 goes straight to the kernel: the JAX package's 8-row
        # padding (attention_ops.py:366) is a TPU sublane artifact; causal
        # is vacuous for the single query
        return _mha.mha_attention(q, k, v, num_heads, False, scale,
                                  key_len=seq_len)
    if name == "flash_decode":
        return _fd.flash_decode(q, k, v, num_heads, scale, kv_len=seq_len)
    if name == "flash":
        raise NotImplementedError(
            f"attention shape q {tuple(q.shape)} k {tuple(k.shape)} selects "
            "the streaming flash tier, whose kernel (flash_attention.py:"
            "_fwd_kernel, kernel #3) is not ported yet (ROADMAP.md B); set "
            "flags 'flash_attention' to '0' for the composite")
    if seq_len is not None:
        lb = _seq_len_bias(seq_len, q.shape[0], k.shape[1])
        bias = lb if bias is None else bias + lb
    return attention_reference(q, k, v, bias, num_heads=num_heads,
                               causal=causal, scale=scale)


@register_op("fused_attention")
def fused_attention(ctx):
    if ctx.has_input("BlockTable"):
        raise NotImplementedError(
            "fused_attention over a paged KV pool (BlockTable) is not "
            "ported yet: it lands with the serving Scheduler and the "
            "flash_decode_paged kernel (ROADMAP.md A, B)")
    ctx.set_output("Out", _apply_attention(
        ctx.input("Q"), ctx.input("K"), ctx.input("V"),
        ctx.input("Bias") if ctx.has_input("Bias") else None,
        num_heads=int(ctx.attr("num_heads")),
        causal=bool(ctx.attr("causal", False)),
        scale=float(ctx.attr("scale", 0.0)),
        seq_len=ctx.input("SeqLen") if ctx.has_input("SeqLen") else None,
        seq_len_ramp=bool(ctx.attr("seq_len_ramp", False)),
    ))
