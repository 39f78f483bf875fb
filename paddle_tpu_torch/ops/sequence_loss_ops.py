"""Structured and sampled losses: the linear-chain CRF and its Viterbi
decode, CTC, edit distance, NCE and the hierarchical sigmoid.

Counterpart of paddle_tpu/ops/sequence_loss_ops.py.  Every op works on
the padded batch [B, T, ...] with optional lengths [B] (the reference's
LoD rows), as a loop over the time axis of batched tensor ops, so that
the Executor's jit path captures it with the rest of the step.  Grads
are the registry's generic ones; four grad makers keep them off the
integer inputs (labels, lengths).

Where the JAX package's arithmetic is not the reference's, the port
keeps the JAX package's: the CRF works in log space (its Alpha output is
the log-space alphas), `warpctc` is optax.ctc_loss's recursion (logits
in, infeasible alignments floored at log_epsilon -1e5, so an impossible
row gives a finite loss), and `norm_by_times` scales only the gradient.
"""

from __future__ import annotations

import math

import torch

from .registry import default_grad_maker, register_grad_maker, register_op


def _lens_of(x, lengths):
    b, t = x.shape[0], x.shape[1]
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int64, device=x.device)
    return lengths.reshape(-1).to(torch.int64)


def _squeeze_label(label):
    """[B, T] or [B, T, 1] integer labels -> [B, T] int64."""
    if label.dim() == 3:
        label = label[..., 0]
    return label.to(torch.int64)


def _steps(b, t, device):
    return torch.arange(t, device=device)[None, :].expand(b, t)


def _keep_grads(op_type, allowed):
    """A grad maker that writes only the grads of `allowed` inputs."""

    @register_grad_maker(op_type)
    def maker(op, block, no_grad_set):
        ops = default_grad_maker(op, block, no_grad_set)
        for g in ops:
            g["outputs"] = {k: v for k, v in g["outputs"].items()
                            if k in allowed}
        return ops

    return maker


# ------------------------------------------------ linear_chain_crf, decoding


@register_op("linear_chain_crf")
def linear_chain_crf(ctx):
    """Emission [B, T, D], Transition [(D+2), D] (row 0 the start weights,
    row 1 the end weights, rows 2.. the D x D transitions), Label [B, T(,
    1)], optional SeqLen [B] -> LogLikelihood [B, 1], the negative log
    likelihood (0 for a row of length 0); Alpha (log space),
    EmissionExps and TransitionExps are detached: a grad through
    exp(Emission) would be 0 * inf = NaN past ~88.7."""
    em = ctx.input("Emission").float()
    trans = ctx.input("Transition").float()
    label = _squeeze_label(ctx.input("Label"))
    lens = _lens_of(em, ctx.input("SeqLen"))
    b, t, d = em.shape
    start_w, end_w, w = trans[0], trans[1], trans[2:]
    safe = label.clamp(0, d - 1)
    valid = (_steps(b, t, em.device) < lens[:, None]).float()

    score = (em.gather(2, safe[..., None])[..., 0] * valid).sum(dim=1)
    score = score + start_w[safe[:, 0]]
    last = (lens - 1).clamp(0, t - 1)
    score = score + end_w[safe.gather(1, last[:, None])[:, 0]]
    score = score + (w[safe[:, :-1], safe[:, 1:]] * valid[:, 1:]).sum(dim=1)

    alpha = start_w[None, :] + em[:, 0]
    alphas = [alpha]
    for k in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + w[None, :, :], dim=1) \
            + em[:, k]
        alpha = torch.where(valid[:, k, None] > 0, new, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + end_w[None, :], dim=1)
    nll = (log_z - score) * (lens > 0).float()
    ctx.set_output("LogLikelihood", nll[:, None])
    if ctx.num_outputs("Alpha"):
        ctx.set_output("Alpha", torch.stack(alphas, dim=1).detach())
    if ctx.num_outputs("EmissionExps"):
        ctx.set_output("EmissionExps", torch.exp(em).detach())
    if ctx.num_outputs("TransitionExps"):
        ctx.set_output("TransitionExps", torch.exp(trans).detach())


_keep_grads("linear_chain_crf", {"Emission@GRAD", "Transition@GRAD"})


def _viterbi(em, trans, lens):
    """The best tag path [B, T] (0 past each row's length); ties go to the
    first index, as jnp.argmax's."""
    b, t, d = em.shape
    start_w, end_w, w = trans[0], trans[1], trans[2:]
    delta = start_w[None, :] + em[:, 0]
    back = [None]
    for k in range(1, t):
        cand = delta[:, :, None] + w[None, :, :]           # [B, from, to]
        best = cand.argmax(dim=1)                          # [B, to]
        new = cand.gather(1, best[:, None, :])[:, 0] + em[:, k]
        delta = torch.where((k < lens)[:, None], new, delta)
        back.append(best)
    final = (delta + end_w[None, :]).argmax(dim=1)
    cur = torch.zeros(b, dtype=torch.int64, device=em.device)
    path = [None] * t
    for k in reversed(range(t)):
        cur = torch.where(k == lens - 1, final, cur)
        path[k] = cur
        if k >= 1:
            prev = back[k].gather(1, cur[:, None])[:, 0]
            cur = torch.where(k <= lens - 1, prev, cur)
    path = torch.stack(path, dim=1)
    inside = _steps(b, t, em.device) < lens[:, None]
    return torch.where(inside, path, 0), inside


@register_op("crf_decoding", no_grad=True)
def crf_decoding(ctx):
    """Viterbi over the padded batch: ViterbiPath [B, T] int64, 0 past each
    row's length; with Label, the 0/1 indicator of path == label inside
    the row instead."""
    em = ctx.input("Emission").float()
    trans = ctx.input("Transition").float()
    lens = _lens_of(em, ctx.input("SeqLen"))
    path, inside = _viterbi(em, trans, lens)
    label = ctx.input("Label")
    if label is not None:
        path = (path == _squeeze_label(label)) & inside
    ctx.set_output("ViterbiPath", path.to(torch.int64))


# ------------------------------------------------------------------ warpctc

_LOG_EPSILON = -1e5    # optax.ctc_loss's approximation of log(0)


def _ctc_loss(logits, logit_pad, labels, label_pad, blank):
    """optax.ctc_loss over logits [B, T, K], paddings [B, T] / [B, N] (1.0
    where padded) and labels [B, N] -> [B]."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_pad.sum(dim=1).to(torch.int64)
    repeat = torch.nn.functional.pad(
        (labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    logprobs_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)
    # a product with the labels' one-hot rows, as optax's einsum: its
    # grad is a product too, where a gather's would add repeated labels
    # by atomics on the card
    one_hot = torch.nn.functional.one_hot(
        labels, logits.shape[-1]).to(logprobs.dtype)
    logprobs_emit = torch.einsum("btk,bnk->btn", logprobs,
                                 one_hot).transpose(0, 1)
    phi = torch.full((b, n + 1), _LOG_EPSILON, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), _LOG_EPSILON, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)],
                         dim=-1)

    pads = logit_pad.transpose(0, 1)
    for k in range(t):
        lp_emit, lp_phi, pad = logprobs_emit[k], logprobs_phi[k], pads[k]
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + _LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi,
                              emit + lp_phi + _LOG_EPSILON * (1.0 - repeat))
        pad = pad.reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -last.gather(1, labellens[:, None])[:, 0]


@register_op("warpctc")
def warpctc(ctx):
    """Logits [B, T, C+1], Label [B, S], LogitsLength and LabelLength [B];
    attrs blank (0), norm_by_times -> Loss [B, 1].  norm_by_times divides
    the gradient by the row's length and leaves the loss as it is."""
    logits = ctx.input("Logits").float()
    label = _squeeze_label(ctx.input("Label"))
    b, t, _ = logits.shape
    s = label.shape[1]
    logit_lens = _lens_of(logits, ctx.input("LogitsLength"))
    label_lens = _lens_of(label, ctx.input("LabelLength"))
    logit_pad = (_steps(b, t, logits.device) >= logit_lens[:, None]).float()
    in_label = _steps(b, s, logits.device) < label_lens[:, None]
    # padded label positions read class 0, as optax requires
    loss = _ctc_loss(logits, logit_pad, torch.where(in_label, label, 0),
                     (~in_label).float(), int(ctx.attr("blank", 0)))
    if ctx.attr("norm_by_times", False):
        t_f = logit_lens.float().clamp(min=1.0)
        loss = (loss - loss / t_f).detach() + loss / t_f
    ctx.set_output("Loss", loss[:, None])


_keep_grads("warpctc", {"Logits@GRAD"})


# ------------------------------------------------------------ edit_distance


@register_op("edit_distance", no_grad=True)
def edit_distance(ctx):
    """Levenshtein distance of Hyps [B, T1] to Refs [B, T2] with optional
    lengths: one DP row a hypothesis step, the insertion chain as a
    running minimum (new[j] = j + cummin(base - j)).  Out [B, 1] float32
    (divided by the reference length when `normalized`), SequenceNum [1]
    int64."""
    hyp, ref = ctx.input("Hyps"), ctx.input("Refs")
    if hyp.dim() == 3:
        hyp = hyp[..., 0]
    if ref.dim() == 3:
        ref = ref[..., 0]
    hyp_lens = _lens_of(hyp, ctx.input("HypsLength"))
    ref_lens = _lens_of(ref, ctx.input("RefsLength"))
    b, t1 = hyp.shape
    t2 = ref.shape[1]
    j = torch.arange(t2 + 1, dtype=torch.float32, device=hyp.device)[None, :]
    row = j.expand(b, t2 + 1)
    for i in range(t1):
        sub = row[:, :-1] + (hyp[:, i, None] != ref).float()
        base = torch.minimum(sub, row[:, 1:] + 1.0)
        full = torch.cat([torch.full((b, 1), float(i + 1),
                                     device=hyp.device), base], dim=1)
        new = j + torch.cummin(full - j, dim=1).values
        row = torch.where((i < hyp_lens)[:, None], new, row)
    dist = row.gather(1, ref_lens.clamp(0, t2)[:, None])[:, 0]
    if ctx.attr("normalized", True):
        dist = dist / ref_lens.float().clamp(min=1.0)
    ctx.set_output("Out", dist[:, None].float())
    ctx.set_output("SequenceNum",
                   torch.full((1,), b, dtype=torch.int64, device=hyp.device))


# ---------------------------------------------------------------------- nce


def _sampler_probs(sampler, num_classes, device):
    """The proposal probability q(c) of every class, [C] float32.  The
    log-uniform q(c) = (log(c + 2) - log(c + 1)) / log(C + 1) is taken in
    float64 and rounded once: in float32 the difference of two logs near
    log(4e4) keeps only a few bits (the JAX package's q is off by up to
    ~4% there, ROADMAP C23)."""
    if sampler == "log_uniform":
        c = torch.arange(num_classes, dtype=torch.float64, device=device)
        return ((torch.log(c + 2.0) - torch.log(c + 1.0))
                / math.log(float(num_classes) + 1.0)).float()
    return torch.full((num_classes,), 1.0 / num_classes, device=device)


def _sampler(ctx):
    sampler = str(ctx.attr("sampler", "uniform"))
    if sampler not in ("uniform", "log_uniform"):
        raise ValueError(f"nce sampler {sampler!r} is not supported "
                         "(expected 'uniform' or 'log_uniform')")
    return sampler


def _draw_negatives(ctx, b, s, num_classes, device):
    """[B, S] negative classes from the op's generator: uniform, or the
    log-uniform (Zipfian) proposal by its inverse CDF."""
    gen = None if device.type == "meta" else ctx.rng()
    if _sampler(ctx) == "log_uniform":
        u = torch.rand((b, s), generator=gen, device=device)
        neg = torch.floor(torch.exp(u * math.log(float(num_classes) + 1.0))
                          - 1.0).to(torch.int64)
        return neg.clamp(0, num_classes - 1)
    return torch.randint(0, num_classes, (b, s), generator=gen,
                         device=device)


def nce_cost(ctx, neg):
    """The nce outputs for the negatives `neg` [B, S]: with o =
    sigmoid(logit) and the prior mass b_c = S * q(c), a true class costs
    -log(o / (o + b)) and a sampled one -log(b / (o + b)) (nce_op.h:46-65).
    Cost [B, 1], SampleLogits (o) and SampleLabels [B, num_true + S]."""
    x = ctx.input("Input").float()
    label = ctx.input("Label")
    if label.dim() == 1:
        label = label[:, None]
    weight = ctx.input("Weight").float()
    bias, sample_weight = ctx.input("Bias"), ctx.input("SampleWeight")
    num_classes = int(ctx.attr("num_total_classes"))
    s = int(ctx.attr("num_neg_samples", 10))
    num_true = label.shape[1]
    q = _sampler_probs(_sampler(ctx), num_classes, x.device)
    samples = torch.cat([label.to(torch.int64), neg.to(torch.int64)], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, weight[samples])
    if bias is not None:
        logits = logits + bias.float()[samples]
    o = torch.sigmoid(logits)
    bmass = s * q[samples]
    o_t, b_t = o[:, :num_true], bmass[:, :num_true]
    o_n, b_n = o[:, num_true:], bmass[:, num_true:]
    cost = (-torch.log(o_t / (o_t + b_t))).sum(dim=1) \
        + (-torch.log(b_n / (o_n + b_n))).sum(dim=1)
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1).float()
    ctx.set_output("Cost", cost[:, None])
    if ctx.num_outputs("SampleLogits"):
        ctx.set_output("SampleLogits", o)
    if ctx.num_outputs("SampleLabels"):
        ctx.set_output("SampleLabels", samples)


@register_op("nce", stateful=True)
def nce(ctx):
    """Input [B, D], Label [B, num_true], Weight [C, D], optional Bias [C]
    and SampleWeight [B]; attrs num_total_classes, num_neg_samples (10),
    sampler ("uniform" or "log_uniform").  The negatives come from the
    Executor's generator for the op, which its grad replays with the same
    seed; a captured graph draws anew at every replay."""
    x, label = ctx.input("Input"), ctx.input("Label")
    neg = _draw_negatives(ctx, label.shape[0],
                          int(ctx.attr("num_neg_samples", 10)),
                          int(ctx.attr("num_total_classes")), x.device)
    nce_cost(ctx, neg)


_keep_grads("nce", {"Input@GRAD", "Weight@GRAD", "Bias@GRAD"})


# ----------------------------------------------------- hierarchical_sigmoid


@register_op("hierarchical_sigmoid")
def hierarchical_sigmoid(ctx):
    """matrix_bit_code.h's SimpleCode: class c is code c + num_classes in a
    complete binary tree rooted at node 1; bit j's node row is (code >>
    (j+1)) - 1 and its target bit j of the code.  X [B, D], W
    [num_classes-1, D], Label [B(, 1)], optional Bias -> Out [B, 1] (the
    path's summed BCE) and PreOut [B, L] (the node scores, clipped to
    +-40 with the gradient passing straight through)."""
    x, w = ctx.input("X").float(), ctx.input("W").float()
    bias = ctx.input("Bias")
    num_classes = int(ctx.attr("num_classes"))
    label = ctx.input("Label")
    code = label.reshape(label.shape[0]).to(torch.int64) + num_classes
    max_len = max(int(num_classes - 1).bit_length(), 1)
    # the path length bit_length(code) - 1, in integers (a float log2 is
    # below the true value at codes such as 2^15)
    total_bits = int(2 * num_classes - 1).bit_length()
    shifts = torch.arange(1, total_bits + 1, device=x.device)
    length = ((code[:, None] >> shifts[None, :]) > 0).sum(dim=1)
    j = torch.arange(max_len, device=x.device)[None, :]
    bit_pos = length[:, None] - 1 - j           # root side first
    valid = bit_pos >= 0
    safe_pos = bit_pos.clamp(min=0)
    node = ((code[:, None] >> (safe_pos + 1)) - 1).clamp(0, w.shape[0] - 1)
    target = ((code[:, None] >> safe_pos) & 1).float()
    pre = torch.einsum("bd,bld->bl", x, w[node])
    if bias is not None:
        pre = pre + bias.float().reshape(-1)[node]
    pre = pre + (pre.clamp(-40.0, 40.0) - pre).detach()
    zero = torch.zeros_like(pre)
    path_loss = torch.where(valid, torch.logaddexp(pre, zero) - target * pre,
                            zero)
    ctx.set_output("Out", path_loss.sum(dim=1, keepdim=True))
    ctx.set_output("PreOut", torch.where(valid, pre, zero))


_keep_grads("hierarchical_sigmoid", {"X@GRAD", "W@GRAD", "Bias@GRAD"})
