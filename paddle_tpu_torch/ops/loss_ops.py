"""Loss and metric ops: cross_entropy, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, square_error_cost, accuracy and
linear_softmax_ce with its grad (paddle_tpu/ops/loss_ops.py:26, :45, :89,
:98, :191, :435-550).

softmax_with_cross_entropy is fused and numerically stable, computed in
float32 whatever the logits' dtype; its Loss output stays float32
(per-token losses feed reductions).  With `label_smooth_eps` > 0 and hard
labels, uniform label smoothing is fused in: loss = lse - (1 - eps) *
logit_y - eps * mean(logits), so the [N, V] smoothed one-hot is never
built.  cross_entropy takes probabilities (after a softmax).  The
gradients are the registry's generic ones, but for linear_softmax_ce's
hand-written one; accuracy has none.

linear_softmax_ce is the vocabulary projection fused with that loss, in
row chunks: the [N, V] logits and their grad exist one [N / chunks, V]
tile at a time.  Its products are plain matmuls that the JAX package
leaves to XLA (`preferred_element_type=float32`): here `torch.mm`
accumulating in float32, a bfloat16 pair through cuBLAS's bfloat16 ->
float32 product on the card (`out_dtype`), in float32 on the CPU.
"""

from __future__ import annotations

import torch

from ..framework.framework import grad_var_name
from .registry import register_grad, register_grad_maker, register_op


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


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ctx):
    """Out = max(x, 0) - x * label + log1p(exp(-|x|)), elementwise (the
    stable form of the logistic loss), zero where label == ignore_index."""
    x, label = ctx.input("X"), ctx.input("Label")
    loss = (torch.clamp_min(x, 0.0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = ctx.attr("ignore_index", -100)
    ctx.set_output("Out", torch.where(label == ignore,
                                      torch.zeros_like(loss), loss))


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


# ---------------------------------------------------------------------------
# linear_softmax_ce: vocab projection fused with softmax cross entropy
# ---------------------------------------------------------------------------


def _lce_chunks(n, want):
    """The largest chunk count <= want that divides n."""
    want = max(1, int(want))
    while n % want:
        want -= 1
    return want


def _mm_f32(a, b):
    """a @ b accumulated and returned in float32 (jnp.matmul's
    preferred_element_type=float32): bfloat16 products are exact in
    float32, so the CPU's float32 product computes the same function as
    the card's bfloat16 tensor-core one."""
    common = torch.promote_types(a.dtype, b.dtype)
    if common != torch.float32 and a.device.type == "cuda":
        return torch.mm(a.to(common), b.to(common), out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _mm(a, b):
    """a @ b in the operands' promoted dtype (jnp.matmul's default)."""
    common = torch.promote_types(a.dtype, b.dtype)
    return torch.mm(a.to(common), b.to(common))


def _lce_logits(xc, w, transpose_w):
    """[m, d] @ W -> [m, V] float32; transpose_w reads W as [V, d] (the
    tied word-embedding layout) through a transposed view, no copy."""
    return _mm_f32(xc, w.t() if transpose_w else w)


def _lce_loss_chunk(xc, labc, w, eps, ignore, transpose_w):
    logits = _lce_logits(xc, w, transpose_w)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    safe = labc.clamp(0, logits.shape[-1] - 1)
    loss = lse - (1.0 - eps) * torch.gather(logits, 1, safe[:, None])
    if eps > 0.0:
        loss = loss - eps * logits.mean(dim=-1, keepdim=True)
    return loss * (labc != ignore).to(loss.dtype)[:, None]


def _lce_args(ctx):
    x, w = ctx.input("X"), ctx.input("W")
    eps = float(ctx.attr("label_smooth_eps", 0.0) or 0.0)
    tw = bool(ctx.attr("transpose_w", False))
    n = x.shape[0]
    chunks = _lce_chunks(n, ctx.attr("chunks", 8))
    lab = ctx.input("Label").reshape(-1).long()
    return x, w, lab, eps, ctx.attr("ignore_index", -100), tw, n, chunks


@register_op("linear_softmax_ce")
def linear_softmax_ce(ctx):
    """X [N, d], W [d, V] (or [V, d] with transpose_w), Label [N, 1] hard
    labels -> Loss [N, 1] float32: mul + softmax_with_cross_entropy
    (label_smooth_eps, ignore_index) computed chunk by chunk."""
    x, w, lab, eps, ignore, tw, n, chunks = _lce_args(ctx)
    m = n // chunks
    losses = [_lce_loss_chunk(x[i * m:(i + 1) * m], lab[i * m:(i + 1) * m],
                              w, eps, ignore, tw) for i in range(chunks)]
    ctx.set_output("Loss", torch.cat(losses).reshape(n, 1))


@register_grad_maker("linear_softmax_ce")
def _lce_grad_maker(op, block, no_grad_set):
    x, w = op.input("X")[0], op.input("W")[0]
    loss = op.output("Loss")[0]
    outs = {}
    if x not in no_grad_set:
        outs["X@GRAD"] = [grad_var_name(x)]
    if w not in no_grad_set:
        outs["W@GRAD"] = [grad_var_name(w)]
    if not outs:
        return []
    return [{
        "type": "linear_softmax_ce_grad",
        "inputs": {"X": [x], "W": [w], "Label": list(op.input("Label")),
                   "Loss@GRAD": [grad_var_name(loss)]},
        "outputs": outs,
        "attrs": dict(op.attrs),
    }]


@register_grad("linear_softmax_ce")
def linear_softmax_ce_grad(ctx):
    """Per chunk: the logits tile recomputed, dlogits = mask * dLoss *
    (softmax - (1 - eps) * onehot - eps / V) (the one-hot by comparing an
    arange, no scatter), cast to X's dtype; the dX tile, and dW accumulated
    in float32."""
    x, w, lab, eps, ignore, tw, n, chunks = _lce_args(ctx)
    d = x.shape[1]
    v = w.shape[0] if tw else w.shape[1]
    m = n // chunks
    dloss = ctx.input("Loss@GRAD").float().reshape(n, 1)
    cols = torch.arange(v, device=x.device)[None, :]
    dw = torch.zeros((v, d) if tw else (d, v), dtype=torch.float32,
                     device=x.device)
    dxs = []
    for i in range(chunks):
        xc, labc = x[i * m:(i + 1) * m], lab[i * m:(i + 1) * m]
        logits = _lce_logits(xc, w, tw)
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(logits - lse)
        base = probs - eps / v if eps > 0.0 else probs
        onehot = cols == labc.clamp(0, v - 1)[:, None]
        base = base - (1.0 - eps) * onehot.float()
        coeff = dloss[i * m:(i + 1) * m] * (labc != ignore).float()[:, None]
        dlogits = (base * coeff).to(x.dtype)
        if tw:
            dxs.append(_mm(dlogits, w))                 # [m, V] @ [V, d]
            dw = dw + _mm_f32(dlogits.t(), xc)          # [V, m] @ [m, d]
        else:
            dxs.append(_mm(dlogits, w.t()))
            dw = dw + _mm_f32(xc.t(), dlogits)
    if ctx.wants("X@GRAD"):
        ctx.set_output("X@GRAD", torch.cat(dxs).reshape(n, d))
    if ctx.wants("W@GRAD"):
        ctx.set_output("W@GRAD", dw.to(w.dtype))
