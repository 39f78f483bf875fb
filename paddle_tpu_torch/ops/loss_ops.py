"""Loss and metric ops: cross_entropy, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, square_error_cost, the loss tail
(smooth_l1_loss, huber_loss, log_loss, hinge_loss, rank_loss,
margin_rank_loss, mse_loss, kldiv_loss), the metric ops (accuracy, auc,
chunk_eval, precision_recall, positive_negative_pair) and
linear_softmax_ce with its grad (paddle_tpu/ops/loss_ops.py:26, :45, :89,
:98, :104-186, :191, :204-430, :435-550).

softmax_with_cross_entropy is fused and numerically stable, computed in
float32 whatever the logits' dtype; its Loss output stays float32
(per-token losses feed reductions).  With `label_smooth_eps` > 0 and hard
labels, uniform label smoothing is fused in: loss = lse - (1 - eps) *
logit_y - eps * mean(logits), so the [N, V] smoothed one-hot is never
built.  cross_entropy takes probabilities (after a softmax).  The
gradients are the registry's generic ones, but for linear_softmax_ce's
hand-written one; the metric ops have none.  The metric ops are the JAX
package's vectorised redesigns of the reference's host loops (no host
read, so they run inside a captured segment): `auc` keeps its confusion
counts in two int64 persistables and integrates in float64;
`chunk_eval`'s counts are int32, as the JAX package's runtime dtype.

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


@register_op("smooth_l1_loss")
def smooth_l1_loss(ctx):
    """Diff = (X - Y) * InsideWeight; Out [N, 1] sums over the rest of
    each row 0.5 sigma^2 d^2 where |d| < 1 / sigma^2, else |d| - 0.5 /
    sigma^2, times OutsideWeight."""
    x, y = ctx.input("X"), ctx.input("Y")
    sigma = ctx.attr("sigma", 1.0)
    inw, outw = ctx.input("InsideWeight"), ctx.input("OutsideWeight")
    d = x - y
    if inw is not None:
        d = d * inw
    s2 = sigma * sigma
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if outw is not None:
        loss = loss * outw
    ctx.set_output("Diff", d)
    ctx.set_output("Out", torch.sum(loss, dim=tuple(range(1, loss.dim())))
                   .reshape(-1, 1))


@register_op("huber_loss")
def huber_loss(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    delta = ctx.attr("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    ctx.set_output("Residual", r)
    ctx.set_output("Out", torch.where(ar <= delta, 0.5 * r * r,
                                      delta * (ar - 0.5 * delta)))


@register_op("log_loss")
def log_loss(ctx):
    p, label = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -label * torch.log(p + eps)
                   - (1.0 - label) * torch.log(1.0 - p + eps))


@register_op("hinge_loss")
def hinge_loss(ctx):
    logits, labels = ctx.input("Logits"), ctx.input("Labels")
    ctx.set_output("Loss", torch.relu(1.0 - (2.0 * labels - 1.0) * logits))


@register_op("rank_loss")
def rank_loss(ctx):
    label = ctx.input("Label")
    d = ctx.input("Left") - ctx.input("Right")
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - label * d)


@register_op("margin_rank_loss")
def margin_rank_loss(ctx):
    label = ctx.input("Label")
    x1, x2 = ctx.input("X1"), ctx.input("X2")
    out = torch.relu(-label * (x1 - x2) + ctx.attr("margin", 0.0))
    ctx.set_output("Activated", (out > 0).to(x1.dtype))
    ctx.set_output("Out", out)


@register_op("mse_loss")
def mse_loss(ctx):
    ctx.set_output("Out", torch.square(ctx.input("X") - ctx.input("Y")))


@register_op("kldiv_loss")
def kldiv_loss(ctx):
    """Target * (log Target - X), zero where Target <= 0, reduced by
    `reduction` (mean, sum, batchmean or none)."""
    x, target = ctx.input("X"), ctx.input("Target")
    loss = target * (torch.log(torch.clamp(target, min=1e-20)) - x)
    loss = torch.where(target > 0, loss, torch.zeros_like(loss))
    red = ctx.attr("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss).reshape(1)
    elif red == "sum":
        loss = torch.sum(loss).reshape(1)
    elif red == "batchmean":
        loss = (torch.sum(loss) / x.shape[0]).reshape(1)
    ctx.set_output("Loss", loss)


@register_op("auc", no_grad=True)
def auc(ctx):
    """Streaming ROC AUC (reference auc_op.cc): each row's positive
    probability Predict[:, 1] falls into one of num_thresholds + 1
    buckets, whose positive and negative counts accumulate in StatPos and
    StatNeg (StatPosOut / StatNegOut are those vars); the AUC is the
    trapezoid area under the (fp, tp) curve walked from the highest
    bucket down, over tot_pos * tot_neg, in float64."""
    predict, label = ctx.input("Predict"), ctx.input("Label")
    stat_pos, stat_neg = ctx.input("StatPos"), ctx.input("StatNeg")
    nt = ctx.attr("num_thresholds", 4095)
    bucket = torch.clamp((predict[:, 1] * nt).to(torch.int32), 0, nt).long()
    lab = label.reshape(-1).to(torch.int32)
    stat_pos = stat_pos.index_add(0, bucket, (lab == 1).to(stat_pos.dtype))
    stat_neg = stat_neg.index_add(0, bucket, (lab == 0).to(stat_neg.dtype))
    tp = torch.cumsum(torch.flip(stat_pos, [0]), 0).to(torch.float64)
    fp = torch.cumsum(torch.flip(stat_neg, [0]), 0).to(torch.float64)
    tot_pos, tot_neg = tp[-1], fp[-1]
    zero = torch.zeros(1, dtype=torch.float64, device=tp.device)
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    auc_val = torch.where((tot_pos > 0) & (tot_neg > 0),
                          area / (tot_pos * tot_neg + 1e-12),
                          torch.zeros_like(area))
    ctx.set_output("AUC", auc_val.reshape(1))
    ctx.set_output("StatPosOut", stat_pos)
    ctx.set_output("StatNegOut", stat_neg)


_CHUNK_SCHEMES = {
    # scheme -> (num_tag_types, tag_begin, tag_inside, tag_end, tag_single);
    # -1 = the scheme has no such tag (never matches a real tag id)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _shifted(a, fill, right):
    """a [B, T] moved one step along T (right: a[t-1] at t), `fill` in the
    vacated column."""
    col = torch.full_like(a[:, :1], fill)
    return (torch.cat([col, a[:, :-1]], 1) if right
            else torch.cat([a[:, 1:], col], 1))


def _chunk_marks(labels, scheme, num_chunk_types):
    """[B, T] label ids -> (begin, end, type) [B, T]: the JAX package's
    vectorised form of the reference's GetSegments walk
    (chunk_eval_op.h:83-96): Begin depends on (prev, cur), End on (cur,
    next), and a position is in a chunk iff its type is not Other."""
    ntag, t_beg, t_in, t_end, t_sgl = _CHUNK_SCHEMES[scheme]
    other = num_chunk_types
    pad = other * ntag
    tag, typ = labels % ntag, labels // ntag
    p_tag, p_typ = (_shifted(tag, pad % ntag, True),
                    _shifted(typ, pad // ntag, True))
    n_tag, n_typ = (_shifted(tag, pad % ntag, False),
                    _shifted(typ, pad // ntag, False))
    same = (tag == t_beg) | (tag == t_sgl) | (
        ((tag == t_in) | (tag == t_end))
        & ((p_tag == t_end) | (p_tag == t_sgl)))
    false = torch.zeros_like(same)
    begin = torch.where(
        p_typ == other, typ != other,
        torch.where(typ == other, false,
                    torch.where(typ != p_typ, ~false, same)))
    ends_here = (((tag == t_beg) | (tag == t_in))
                 & ((n_tag == t_beg) | (n_tag == t_sgl))) | (
        tag == t_end) | (tag == t_sgl)
    end = torch.where(
        typ == other, false,
        torch.where(n_typ == other, ~false,
                    torch.where(n_typ != typ, ~false, ends_here)))
    return begin, end & (typ != other), typ


@register_op("chunk_eval", no_grad=True)
def chunk_eval(ctx):
    """Precision, recall and F1 of chunk detection under the IOB, IOE,
    IOBES or plain scheme (reference chunk_eval_op.cc), over dense [B, T]
    label ids and optional SeqLen: a correct chunk begins at the same
    position in both streams, with the same type, and ends at the same
    position (the next End at or after it, by a reversed running
    minimum)."""
    inf = ctx.input("Inference")
    inf = inf.reshape(inf.shape[:2])
    lab = ctx.input("Label")
    lab = lab.reshape(lab.shape[:2])
    lens = ctx.input("SeqLen")
    scheme = str(ctx.attr("chunk_scheme", "IOB"))
    if scheme not in _CHUNK_SCHEMES:
        raise ValueError(f"unknown chunk scheme {scheme!r}")
    nct = int(ctx.attr("num_chunk_types"))
    excluded = list(ctx.attr("excluded_chunk_types", None) or [])
    b, t = inf.shape
    iota = torch.arange(t, dtype=torch.int32, device=inf.device).expand(b, t)
    limit = (torch.full((b, 1), t, dtype=torch.int32, device=inf.device)
             if lens is None else lens.reshape(b, 1).to(torch.int32))
    valid = iota < limit
    other_id = nct * _CHUNK_SCHEMES[scheme][0]
    inf = torch.where(valid, inf, torch.full_like(inf, other_id))
    lab = torch.where(valid, lab, torch.full_like(lab, other_id))
    i_beg, i_end, i_typ = _chunk_marks(inf, scheme, nct)
    l_beg, l_end, l_typ = _chunk_marks(lab, scheme, nct)

    def keep(typ):
        m = torch.ones(typ.shape, dtype=torch.bool, device=typ.device)
        for e in excluded:
            m = m & (typ != e)
        return m

    def next_end(end_mask):
        marks = torch.where(end_mask, iota, torch.full_like(iota, t + 1))
        return torch.flip(torch.cummin(torch.flip(marks, [1]), 1).values,
                          [1])

    n_inf = torch.sum((i_beg & keep(i_typ)).to(torch.int32), dtype=torch.int32)
    n_lab = torch.sum((l_beg & keep(l_typ)).to(torch.int32), dtype=torch.int32)
    match = (i_beg & l_beg & (i_typ == l_typ) & keep(i_typ)
             & (next_end(i_end) == next_end(l_end)))
    n_cor = torch.sum(match.to(torch.int32), dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=inf.device)
    prec = torch.where(n_inf > 0, n_cor / torch.clamp(n_inf, min=1), zero)
    rec = torch.where(n_lab > 0, n_cor / torch.clamp(n_lab, min=1), zero)
    f1 = torch.where(n_cor > 0, 2.0 * prec * rec / (prec + rec + 1e-30),
                     zero)
    ctx.set_output("Precision", prec.to(torch.float32).reshape(1))
    ctx.set_output("Recall", rec.to(torch.float32).reshape(1))
    ctx.set_output("F1-Score", f1.to(torch.float32).reshape(1))
    ctx.set_output("NumInferChunks", n_inf.reshape(1))
    ctx.set_output("NumLabelChunks", n_lab.reshape(1))
    ctx.set_output("NumCorrectChunks", n_cor.reshape(1))


def _pr_metrics(states):
    """states [C, 4] (TP, FP, TN, FN) -> [macro P, macro R, macro F1,
    micro P, micro R, micro F1] (precision_recall_op.h ComputeMetrics; a
    class with nothing predicted or labelled scores 1.0)."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]

    def p_of(tp_, fp_):
        return torch.where(tp_ + fp_ > 0,
                           tp_ / torch.clamp(tp_ + fp_, min=1e-30),
                           torch.ones_like(tp_))

    def f1_of(p, r):
        return torch.where(p + r > 0,
                           2.0 * p * r / torch.clamp(p + r, min=1e-30),
                           torch.zeros_like(p))

    mp, mr = torch.mean(p_of(tp, fp)), torch.mean(p_of(tp, fn))
    up, ur = p_of(tp.sum(), fp.sum()), p_of(tp.sum(), fn.sum())
    return torch.stack([mp, mr, f1_of(mp, mr), up, ur, f1_of(up, ur)])


def _one_hot_f32(ids, n):
    return (ids[:, None] == torch.arange(n, device=ids.device)).to(
        torch.float32)


@register_op("precision_recall", no_grad=True)
def precision_recall(ctx):
    """Per-class streaming confusion states [C, 4] (TP, FP, TN, FN) and
    macro/micro precision, recall and F1 of the batch and of the
    accumulated states, in float32 (reference precision_recall_op.cc;
    one-hot products in place of its per-sample loop)."""
    idx = ctx.input("Indices").reshape(-1)
    lab = ctx.input("Labels").reshape(-1)
    cls = int(ctx.attr("class_number"))
    w = (ctx.input("Weights").reshape(-1).to(torch.float32)
         if ctx.has_input("Weights")
         else torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    oh_idx, oh_lab = _one_hot_f32(idx, cls), _one_hot_f32(lab, cls)
    hit = (idx == lab).to(torch.float32)
    miss = w * (1.0 - hit)
    tp = (w * hit) @ oh_idx
    fp = miss @ oh_idx
    fn = miss @ oh_lab
    tn = torch.sum(w) - w @ oh_idx - miss @ oh_lab
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    accum = (batch + ctx.input("StatesInfo").to(torch.float32)
             if ctx.has_input("StatesInfo") else batch)
    ctx.set_output("BatchMetrics", _pr_metrics(batch))
    ctx.set_output("AccumMetrics", _pr_metrics(accum))
    ctx.set_output("AccumStatesInfo", accum)


@register_op("positive_negative_pair", no_grad=True)
def positive_negative_pair(ctx):
    """Rank-order pair counts over the doc pairs (i < j) of one query with
    different labels, each weighted by the mean of the two rows' weights
    (reference positive_negative_pair_op.cc, as one [N, N] pair mask): a
    pair is positive where score and label order agree, else negative;
    a score tie counts as neutral and as negative, as in the
    reference."""
    score = ctx.input("Score")
    lab = ctx.input("Label").reshape(-1).to(torch.float32)
    qid = ctx.input("QueryID").reshape(-1)
    s = score[:, int(ctx.attr("column", -1))].to(torch.float32)
    n = s.shape[0]
    w = (ctx.input("Weight").reshape(-1).to(torch.float32)
         if ctx.has_input("Weight")
         else torch.ones((n,), dtype=torch.float32, device=s.device))
    pair = (qid[:, None] == qid[None, :]) & (lab[:, None] != lab[None, :])
    pair = pair & torch.ones((n, n), dtype=torch.bool,
                             device=s.device).triu(1)
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    pw = torch.where(pair, (w[:, None] + w[None, :]) * 0.5, zero)
    ds = s[:, None] - s[None, :]
    dl = lab[:, None] - lab[None, :]
    agree = ds * dl > 0
    pos = torch.sum(torch.where(agree, pw, zero))
    neg = torch.sum(torch.where(agree, zero, pw))
    neu = torch.sum(torch.where(ds == 0, pw, zero))

    def acc(name, v):
        if ctx.has_input(name):
            v = ctx.input(name).reshape(()).to(torch.float32) + v
        return v.reshape(1)

    ctx.set_output("PositivePair", acc("AccumulatePositivePair", pos))
    ctx.set_output("NegativePair", acc("AccumulateNegativePair", neg))
    ctx.set_output("NeutralPair", acc("AccumulateNeutralPair", neu))


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
