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

The gradient (`fused_attention_grad`, attention_ops.py:411-488) takes the
same gate: the mha_block tiers call the backward kernel's entry
(`mha_block_bwd`) directly, so no forward kernel runs again; the flash
tier recomputes (out, lse) with kernel #3, as the JAX vjp replay does,
and calls `flash_attention_bwd` (kernels #4 and #5); the composite takes
autograd over `attention_reference`.

The paged decode form (`BlockTable` input, serving/paged.py's rewrite of
the step program) takes `_apply_attention_paged`: the flash_decode_paged
kernel when `_paged_decode_choice` says so, `paged_attention_reference`
(the pool gathered to a dense view, then the composite) otherwise.

The `seq_len_ramp` window (speculative verify and chunked prefill:
query t sees keys < seq_len[b] + t) folds the ramp into an additive bias
and so always takes the composite, as in the JAX package: every kernel
tier's in-kernel mask has a single limit per row.  Its paged form, and
any paged call with Sq != 1, takes `paged_attention_reference`.

Ported kernels: mha_block (forward and backward), flash_decode,
flash_decode_paged, and the streaming "flash" tier (kernel #3 forward,
kernels #4 and #5 backward, `flash_attention`), which takes every window
the gate sends there (a causal prefill past 1024 keys at transformer-base
widths, BERT-base at 2048 tokens, or a window off the 128 grid).  The
gradient of the flash_decode tier pulls dOut back through the composite
with the kv_len mask, as the JAX rule does.

Under a device mesh (the Executor's mesh mode, parallel/spmd.py) the op's
inputs are DTensors.  With a live `sp` axis and Sq == Sk dividing over it
(`_sp_mesh`, attention_ops.py:62-77) the gate's first tier is "ring"
(:272): the forward and the grad take parallel/ring_attention.py, whose
rotations run kernel #3 (and #4/#5 in the grad) when the local block
passes #3's gate.  Any other DTensor call runs the tier the gate picks on
this rank's blocks (`spmd.local_attention`): q, k and v in one layout,
batch over the data axes and heads over `tp`, with the LOCAL head count
given to the kernels.
"""

from __future__ import annotations

import collections

import torch

from .. import flags
from ..framework.framework import grad_var_name
from .cuda import flash_attention as _fa
from .cuda import flash_decode as _fd
from .cuda import flash_decode_paged as _fdp
from .cuda import mha_block as _mha
from .registry import register_grad, register_grad_maker, register_op

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


def _seq_len_bias_ramp(seq_len, b, sq, sk):
    """[B] lengths -> [B,1,Sq,Sk] per-query key mask (attention_ops.py:301):
    query t sees keys at positions < seq_len[b] + t.  At Sq == 1 the ramp
    term is 0 and this is `_seq_len_bias` bitwise: the same compare, the
    same where, the same -1e30."""
    pos = torch.arange(sk, device=seq_len.device)[None, None, :]
    lim = (seq_len.reshape(b, 1).to(pos.dtype)
           + torch.arange(sq, device=seq_len.device)[None, :])[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=seq_len.device)
    return torch.where(pos < lim, zero, -1e30).reshape(b, 1, sq, sk)


def _fold_ramp(q, k, bias, seq_len, seq_len_ramp):
    """(bias, seq_len) with a ramp folded into the bias and the single
    limit dropped (attention_ops.py:326), so the gate picks the
    composite."""
    if seq_len_ramp and seq_len is not None:
        lb = _seq_len_bias_ramp(seq_len, q.shape[0], q.shape[1], k.shape[1])
        return (lb if bias is None else bias + lb), None
    return bias, seq_len


def _on_card(x):
    return x.device.type == "cuda"


def _kernel_choice(q, k, num_heads, causal):
    """("mha_block" | "flash", "cuda" | "interpret") or None (composite):
    the JAX package's crossover gate (attention_ops.py:80)."""
    flag = flags.get("flash_attention")
    if flag == "0":
        return None
    mha_ok = flag != "flash" and _mha.supported(q, k, num_heads, causal)
    flash_ok = _fa.supported(q, k, num_heads, causal)
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


def _is_dtensor(x):
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sp_mesh(q, k):
    """Sequence-parallel ring path (attention_ops.py:62): DTensor inputs
    under a mesh whose `sp` axis is live, Sq == Sk, divisible over it.
    Rectangular attention (decoder cross-attention with Sq != Sk) stays
    off the ring."""
    from ..parallel.mesh import get_current_mesh

    mesh = get_current_mesh()
    if mesh is None or not _is_dtensor(q):
        return None
    sp = mesh.axis_size("sp", 1)
    if sp <= 1:
        return None
    if q.shape[1] != k.shape[1] or q.shape[1] % sp:
        return None
    return mesh


def _backend_choice(q, k, num_heads, causal, has_bias, has_seq_len=False):
    """(name, mode): the ONE selection cascade — _apply_attention executes
    what this returns.  A SeqLen mask rides every kernel tier; an additive
    bias takes the composite."""
    if not has_bias and q.shape[1] == 1 and k.shape[1] > 1:
        choice = _decode_choice(q, k, num_heads)
        if choice is not None:
            return choice
    if not has_bias and _sp_mesh(q, k) is not None:
        return "ring", None
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


def _composite(q, k, v, bias, *, num_heads, causal, scale, seq_len):
    if seq_len is not None:
        lb = _seq_len_bias(seq_len, q.shape[0], k.shape[1])
        bias = lb if bias is None else bias + lb
    return attention_reference(q, k, v, bias, num_heads=num_heads,
                               causal=causal, scale=scale)


def _apply_attention(q, k, v, bias, *, num_heads, causal, scale,
                     seq_len=None, seq_len_ramp=False):
    """Gate-selected attention forward.  On meta tensors (shape inference)
    it is always the composite, never a kernel wrapper.  On DTensors: the
    ring, or the gate's tier on this rank's blocks (module docstring)."""
    if _is_dtensor(q):
        return _apply_attention_mesh(q, k, v, bias, num_heads=num_heads,
                                     causal=causal, scale=scale,
                                     seq_len=seq_len,
                                     seq_len_ramp=seq_len_ramp)
    bias, seq_len = _fold_ramp(q, k, bias, seq_len, seq_len_ramp)
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
        return _fa.flash_attention(q, k, v, num_heads, causal, scale,
                                   kv_len=seq_len)
    return _composite(q, k, v, bias, num_heads=num_heads, causal=causal,
                      scale=scale, seq_len=seq_len)


def _apply_attention_mesh(q, k, v, bias, *, num_heads, causal, scale,
                          seq_len, seq_len_ramp):
    from ..parallel import spmd

    mesh = _sp_mesh(q, k)
    if mesh is not None and bias is None and not (seq_len_ramp
                                                  and seq_len is not None):
        from ..parallel.ring_attention import ring_attention

        TIER_CALLS["ring"] += 1
        return ring_attention(q, k, v, mesh, num_heads=num_heads,
                              causal=causal, scale=scale, seq_len=seq_len)
    from ..parallel.mesh import get_current_mesh

    def local(ql, kl, vl, bl, sl, heads):
        return _apply_attention(ql, kl, vl, bl, num_heads=heads,
                                causal=causal, scale=scale, seq_len=sl,
                                seq_len_ramp=seq_len_ramp)

    return spmd.local_attention(local, q, k, v, bias, seq_len, num_heads,
                                get_current_mesh())


def _paged_decode_choice(q, k_blocks, num_heads):
    """Paged single-query tier: ("flash_decode_paged", "cuda" |
    "interpret") or None (the paged gather reference), with
    _decode_choice's flag protocol (attention_ops.py:169): "0" gives None,
    a refusing gate gives None, "interpret" routes to the kernel wrapper
    (which runs its plain version on the CPU), a tensor on the card gets
    the kernel.  There is no mha sibling: the pool never exists densely,
    so the only kernel that can read it is the one that follows the block
    table in place."""
    flag = flags.get("flash_attention")
    if flag == "0":
        return None
    if not _fdp.paged_decode_supported(q, k_blocks, num_heads):
        return None
    if flag == "interpret":
        return "flash_decode_paged", "interpret"
    if not _on_card(q):
        return None
    return "flash_decode_paged", "cuda"


def paged_backend_choice(q, k_blocks, num_heads):
    """'flash_decode_paged' | 'paged_reference': what the paged decode
    path runs for these tensors (meta tensors work)."""
    choice = _paged_decode_choice(q, k_blocks, num_heads)
    return choice[0] if choice is not None else "paged_reference"


def paged_attention_reference(q, k_blocks, v_blocks, block_table, lengths,
                              *, num_heads, scale, max_len,
                              seq_len_ramp=False):
    """Reference paged decode (attention_ops.py:204): gather the table
    (clipped into [0, N)) back to a dense [B, max_len, H*D] view on the
    pool's device and run the composite under the SeqLen mask, or under
    the per-query ramp for the Sq = k verify and chunk windows.  Sliced to
    exactly max_len so its score shapes match the dense-gather path's."""
    b = q.shape[0]
    n, bs, hd = k_blocks.shape
    tab = block_table.to(device=k_blocks.device,
                         dtype=torch.int64).clamp(0, n - 1)
    m = tab.shape[1]
    flat = tab.reshape(-1)
    k = k_blocks[flat].reshape(b, m * bs, hd)[:, :max_len]
    v = v_blocks[flat].reshape(b, m * bs, hd)[:, :max_len]
    if seq_len_ramp:
        bias = _seq_len_bias_ramp(lengths, b, q.shape[1], max_len)
        return attention_reference(q, k, v, bias, num_heads=num_heads,
                                   causal=False, scale=scale)
    return _composite(q, k, v, None, num_heads=num_heads, causal=False,
                      scale=scale, seq_len=lengths)


def _apply_attention_paged(q, k_blocks, v_blocks, block_table, lengths, *,
                           num_heads, scale, max_len, seq_len_ramp=False):
    """Paged decode forward (attention_ops.py:232): q [B, 1, H*D] against
    the shared block pool through each row's block table.  The kernel
    when the gate says so, the paged gather reference otherwise; a ramp
    window (q [B, k, H*D]) always takes the reference, since the kernel
    is single-query by contract.  On meta tensors (shape inference) it is
    shape-only, never a kernel wrapper."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    choice = (None if seq_len_ramp or q.shape[1] != 1
              else _paged_decode_choice(q, k_blocks, num_heads))
    TIER_CALLS["paged_reference" if choice is None
               else "flash_decode_paged"] += 1
    if choice is not None:
        return _fdp.flash_decode_paged(q, k_blocks, v_blocks, block_table,
                                       lengths, num_heads, scale)
    return paged_attention_reference(
        q, k_blocks, v_blocks, block_table, lengths, num_heads=num_heads,
        scale=scale, max_len=max_len, seq_len_ramp=seq_len_ramp)


@register_op("fused_attention")
def fused_attention(ctx):
    if ctx.has_input("BlockTable"):
        # paged decode form (serving's step-program rewrite): K/V are the
        # shared [N, block_size, H*D] pools, BlockTable routes each batch
        # row, SeqLen is the live length, paged_max_len bounds the dense
        # reference view.  causal is vacuous at Sq == 1; bias never rides
        # the decode step.
        ctx.set_output("Out", _apply_attention_paged(
            ctx.input("Q"), ctx.input("K"), ctx.input("V"),
            ctx.input("BlockTable"), ctx.input("SeqLen"),
            num_heads=int(ctx.attr("num_heads")),
            scale=float(ctx.attr("scale", 0.0)),
            max_len=int(ctx.attr("paged_max_len")),
            seq_len_ramp=bool(ctx.attr("seq_len_ramp", False))))
        return
    ctx.set_output("Out", _apply_attention(
        ctx.input("Q"), ctx.input("K"), ctx.input("V"),
        ctx.input("Bias") if ctx.has_input("Bias") else None,
        num_heads=int(ctx.attr("num_heads")),
        causal=bool(ctx.attr("causal", False)),
        scale=float(ctx.attr("scale", 0.0)),
        seq_len=ctx.input("SeqLen") if ctx.has_input("SeqLen") else None,
        seq_len_ramp=bool(ctx.attr("seq_len_ramp", False)),
    ))


@register_grad_maker("fused_attention")
def _fused_attention_grad_maker(op, block, no_grad_set):
    """Lean grad decl: Q/K/V(/Bias/SeqLen) and dOut only.  Out is not an
    input of the grad op, so nothing of the forward's internals has to
    live until the backward."""
    if op.input("BlockTable"):
        raise NotImplementedError(
            "fused_attention with BlockTable (paged decode) is "
            "inference-only — serving's step programs never take grads")
    out = op.output("Out")[0]
    ins = {"Q": list(op.input("Q")), "K": list(op.input("K")),
           "V": list(op.input("V")),
           "Out@GRAD": [grad_var_name(out)]}
    if op.input("Bias"):
        ins["Bias"] = list(op.input("Bias"))
    if op.input("SeqLen"):
        ins["SeqLen"] = list(op.input("SeqLen"))
    outs = {}
    emitted = False
    for p in ("Q", "K", "V", "Bias"):
        names = op.input(p)
        if not names:
            continue
        gs = [None if n in no_grad_set else grad_var_name(n) for n in names]
        emitted = emitted or any(g is not None for g in gs)
        outs[p + "@GRAD"] = gs
    if not emitted:
        return []
    return [{"type": "fused_attention_grad", "inputs": ins,
             "outputs": outs, "attrs": dict(op.attrs)}]


@register_grad("fused_attention")
def fused_attention_grad(ctx):
    """dQ, dK, dV (and dBias) through the tier the forward took: the
    mha_block tiers call the backward kernel's entry on q, k, v and dOut
    (no forward kernel runs); the flash tier recomputes out and lse with
    kernel #3 (the grad op takes no Out) and runs kernels #4 and #5 with
    no lse cotangent; the composite pulls dOut back through
    `attention_reference` with autograd, and so does the flash_decode
    tier, whose JAX rule is that composite with the kv_len bias
    (flash_attention.py:_decode_bwd_rule).  A ramp window folds into a
    constant bias and takes the composite, as its forward does (the JAX
    grad replays `_apply_attention`, attention_ops.py:459).  On DTensors
    the ring's backward (parallel/ring_attention.py), or the same tiers on
    this rank's blocks (module docstring)."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    bias = ctx.input("Bias") if ctx.has_input("Bias") else None
    seq_len = ctx.input("SeqLen") if ctx.has_input("SeqLen") else None
    dout = ctx.input("Out@GRAD")
    num_heads = int(ctx.attr("num_heads"))
    causal = bool(ctx.attr("causal", False))
    scale = float(ctx.attr("scale", 0.0))
    ramp = bool(ctx.attr("seq_len_ramp", False))
    if _is_dtensor(q):
        grads = _attention_grad_mesh(q, k, v, bias, seq_len, dout,
                                     num_heads, causal, scale, ramp)
    else:
        grads = _attention_grad(q, k, v, bias, seq_len, dout, num_heads,
                                causal, scale, ramp)
    ctx.set_output("Q@GRAD", grads[0])
    ctx.set_output("K@GRAD", grads[1])
    ctx.set_output("V@GRAD", grads[2])
    if bias is not None and ctx.num_outputs("Bias@GRAD"):
        ctx.set_output("Bias@GRAD", grads[3])


def _attention_grad_mesh(q, k, v, bias, seq_len, dout, num_heads, causal,
                         scale, ramp):
    from ..parallel import spmd
    from ..parallel.mesh import get_current_mesh

    mesh = _sp_mesh(q, k)
    if mesh is not None and bias is None and not (ramp
                                                  and seq_len is not None):
        from ..parallel.ring_attention import ring_attention_grad

        TIER_CALLS["ring"] += 1
        return ring_attention_grad(q, k, v, dout, mesh, num_heads=num_heads,
                                   causal=causal, scale=scale,
                                   seq_len=seq_len) + [None]

    def local(ql, kl, vl, bl, sl, dl, heads):
        return _attention_grad(ql, kl, vl, bl, sl, dl, heads, causal, scale,
                               ramp)

    return spmd.local_attention_grad(local, q, k, v, bias, seq_len, dout,
                                     num_heads, get_current_mesh())


def _attention_grad(q, k, v, bias, seq_len, dout, num_heads, causal, scale,
                    seq_len_ramp):
    """(dq, dk, dv, dbias or None) of `_apply_attention` on plain tensors
    (fused_attention_grad's tiers)."""
    dout = dout.to(q.dtype)
    ramp, seq_len = _fold_ramp(q, k, None, seq_len, seq_len_ramp)
    name, _ = _backend_choice(q, k, num_heads, causal,
                              bias is not None or ramp is not None,
                              seq_len is not None)
    if name in ("mha_block", "mha_decode"):
        # causal is vacuous for the single query of mha_decode
        dq, dk, dv = _mha.mha_block_bwd(
            q, k, v, dout.contiguous(), num_heads,
            causal and name == "mha_block", scale, key_len=seq_len)
        return dq, dk, dv, None
    if name == "flash":
        out, lse = _fa.flash_attention_lse(q, k, v, num_heads, causal, scale,
                                           kv_len=seq_len)
        dq, dk, dv = _fa.flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), num_heads, causal, scale,
            kv_len=seq_len)
        return dq, dk, dv, None
    # the flash_decode tier's grad is the composite's with the kv_len
    # bias, as the JAX rule computes it (flash_attention.py:_decode_bwd_rule)
    leaves = [x.detach().requires_grad_(True)
              for x in ((q, k, v) if bias is None else (q, k, v, bias))]
    with torch.enable_grad():
        full = leaves[3] if bias is not None else None
        if ramp is not None:
            full = ramp if full is None else full + ramp
        out = _composite(*leaves[:3], full, num_heads=num_heads,
                         causal=causal, scale=scale, seq_len=seq_len)
        grads = torch.autograd.grad(out, leaves, dout, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return grads[0], grads[1], grads[2], (grads[3] if bias is not None
                                          else None)
