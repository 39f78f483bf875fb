"""Recurrent ops: `fused_lstm` and `fused_gru` over a whole sequence, and
the recurrent tail (the reference's names and IO: `gru_unit`, `gru`,
`lstm_unit`, `lstm`, `lstmp`, `fusion_lstm`, `fusion_gru`,
`attention_lstm`, `fused_embedding_fc_lstm`, `fusion_seqconv_eltadd_relu`,
`fusion_seqexpand_concat_fc`).

Counterparts of paddle_tpu/ops/rnn_ops.py, where each op is one
`lax.scan`.  Here each is a Python loop over time, which the Executor's
jit path captures with the rest of the step into one CUDA graph: the
input projection for every time step is hoisted out of the loop (one
[B*S, D] x [D, kH] product, float32 accumulation, cast back to X's dtype,
plus the bias), and only `h @ WeightH` and the gates stay inside.

The functions are the JAX package's, not torch.nn's: the LSTM's gates are
i, f, g (the cell candidate), o with one bias; the GRU's are u, r, c with
`h = u * cand + (1 - u) * h_prev` and r applied to h before the
candidate's product, `(r * h) @ WeightH[:, 2H:]` (torch.nn.GRU applies r
after the product and weights h_prev by z).

Layout: batch-major [B, S, D] in and out; `is_reverse` runs the sequence
backwards and flips the output back.  Where an op takes SeqLen [B], a row
past its length holds its last live state; `is_reverse` flips the whole
padded axis, so a reversed scan meets a row's padding first and holds its
initial state there.  The tail's gate orders are the JAX package's, which
differ by op: i, f, g, o for `lstm`, `lstmp` and `fusion_lstm` (peepholes
Wic, Wfc, Woc in Bias[4D:7D]); i, f, o, g for `lstm_unit`; f, i, o, g
for `attention_lstm`.  Gradients are the registry's
generic ones (the forward replayed under autograd), as the JAX package
takes `jax.vjp` of the scan.
"""

from __future__ import annotations

import torch

from .registry import register_op


def _mm(a, b):
    """a @ b over the promoted dtype (jnp's `@`)."""
    common = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(common), b.to(common))


def _project_input(x, wx, b, reverse, width):
    """[B, S, D] @ [D, kH] for every step at once -> time-major [S, B, kH]:
    float32 accumulation cast to X's dtype, then the bias."""
    if reverse:
        x = torch.flip(x, dims=[1])
    bsz, steps, d = x.shape
    # time-major rows, so that each step's slice is contiguous
    rows = x.transpose(0, 1).reshape(steps * bsz, d)
    if x.dtype == wx.dtype:
        xw = torch.matmul(rows, wx)        # accumulates in float32
    else:
        xw = _mm(rows.float(), wx.float()).to(x.dtype)
    xw = xw.reshape(steps, bsz, -1)
    if b is not None:
        xw = xw + b.reshape(-1)[:width]
    return xw


def _initial(ctx, name, like, hidden, batch=None):
    """Input `name`, else zeros [batch (like's rows), hidden] of like's
    dtype."""
    if ctx.has_input(name):
        return ctx.input(name)
    return torch.zeros((like.shape[0] if batch is None else batch, hidden),
                       dtype=like.dtype, device=like.device)


def _lstm_steps(xw, h, c, wh, peepholes=None):
    """The `_lstm_scan` body over time-major xw [S, B, 4H] (bias added):
    gates i, f, g, o, optional (Wic, Wfc, Woc) peepholes -> the h and c
    sequences [S, B, H]."""
    hs, cs = [], []
    # unbind, not xw[t]: its grad is one stack, not a zero-filled xw a step
    for xt in xw.unbind(0):
        gates = xt + _mm(h, wh)
        if peepholes is None:
            # sigmoid over all four gates in one kernel; g's share unused
            i, f, _, o = torch.sigmoid(gates).chunk(4, dim=1)
            c = f * c + i * torch.tanh(gates.chunk(4, dim=1)[2])
        else:
            wic, wfc, woc = peepholes
            i, f, g, o = gates.chunk(4, dim=1)
            c = (torch.sigmoid(f + wfc * c) * c
                 + torch.sigmoid(i + wic * c) * torch.tanh(g))
            o = torch.sigmoid(o + woc * c)
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def _gru_steps(xw, h, wh, hidden):
    """The `_gru_scan` body over time-major xw [S, B, 3H] -> [S, B, H]."""
    wh_uz, wh_c = wh[:, :2 * hidden], wh[:, 2 * hidden:]
    hs = []
    for xt in xw.unbind(0):
        x_uz, x_c = xt.split([2 * hidden, hidden], dim=1)
        u, r = torch.sigmoid(x_uz + _mm(h, wh_uz)).chunk(2, dim=1)
        cand = torch.tanh(x_c + _mm(r * h, wh_c))
        h = u * cand + (1.0 - u) * h
        hs.append(h)
    return torch.stack(hs)


def _batch_major(seq, reverse):
    """time-major [S, B, ...] -> batch-major, in the input's time order."""
    out = seq.transpose(0, 1)
    return torch.flip(out, dims=[1]) if reverse else out


@register_op("fused_lstm")
def fused_lstm(ctx):
    """X [B, S, D], WeightX [D, 4H], WeightH [H, 4H], Bias [4H], optional
    H0/C0 [B, H] -> Out [B, S, H], LastH, LastC [B, H]."""
    x, wh = ctx.input("X"), ctx.input("WeightH")
    reverse = bool(ctx.attr("is_reverse", False))
    hidden = wh.shape[0]
    xw = _project_input(x, ctx.input("WeightX"), ctx.input("Bias"), reverse,
                        4 * hidden)
    hs, cs = _lstm_steps(xw, _initial(ctx, "H0", x, hidden),
                         _initial(ctx, "C0", x, hidden), wh)
    ctx.set_output("Out", _batch_major(hs, reverse))
    ctx.set_output("LastH", hs[-1])
    ctx.set_output("LastC", cs[-1])


@register_op("fused_gru")
def fused_gru(ctx):
    """X [B, S, D], WeightX [D, 3H], WeightH [H, 3H], Bias [3H], optional
    H0 [B, H] -> Out [B, S, H], LastH [B, H]."""
    x, wh = ctx.input("X"), ctx.input("WeightH")
    reverse = bool(ctx.attr("is_reverse", False))
    hidden = wh.shape[0]
    xw = _project_input(x, ctx.input("WeightX"), ctx.input("Bias"), reverse,
                        3 * hidden)
    hs = _gru_steps(xw, _initial(ctx, "H0", x, hidden), wh, hidden)
    ctx.set_output("Out", _batch_major(hs, reverse))
    ctx.set_output("LastH", hs[-1])


# --------------------------------------------------------- the recurrent tail

def _identity(v):
    return v


_ACT_BY_NAME = {"identity": _identity, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "relu": torch.relu}
_ACT_BY_ID = {0: _identity, 1: torch.sigmoid, 2: torch.tanh, 3: torch.relu}


def _act(spec, default):
    """An activation attr: a name, or the reference's integer id."""
    if spec is None:
        return _ACT_BY_NAME[default]
    if isinstance(spec, str):
        return _ACT_BY_NAME[spec]
    return _ACT_BY_ID[int(spec)]


def _optional(ctx, name):
    return ctx.input(name) if ctx.has_input(name) else None




def _hold(live, new, old):
    """A row past its length keeps `old` (the JAX package's arithmetic
    form, live * new + (1 - live) * old)."""
    return live * new + (1.0 - live) * old


def _live(step, lengths, dtype):
    return (step < lengths).to(dtype)[:, None]


def _gru_cell(gate_in, h_prev, weight, gate_act, cand_act):
    """gru_unit_op.h: u, r from gate_in + h_prev @ W[:, :2D], the candidate
    from gate_in[:, 2D:] + (r * h_prev) @ W[:, 2D:], h = u*c + (1-u)*h_prev
    -> (gate, reset_hidden_prev, h)."""
    d = h_prev.shape[-1]
    ur = gate_act(gate_in[:, :2 * d] + _mm(h_prev, weight[:, :2 * d]))
    u, r = ur[:, :d], ur[:, d:]
    rhp = r * h_prev
    c = cand_act(gate_in[:, 2 * d:] + _mm(rhp, weight[:, 2 * d:]))
    h = u * c + (1.0 - u) * h_prev
    return torch.cat([ur, c], dim=-1), rhp, h


@register_op("gru_unit")
def gru_unit(ctx):
    """One GRU step: Input [B, 3D] (projected), HiddenPrev [B, D], Weight
    [D, 3D], optional Bias -> Gate, ResetHiddenPrev, Hidden."""
    x, bias = ctx.input("Input"), _optional(ctx, "Bias")
    gate_in = x + bias.reshape(1, -1) if bias is not None else x
    gate, rhp, h = _gru_cell(
        gate_in, ctx.input("HiddenPrev"), ctx.input("Weight"),
        _act(ctx.attr("gate_activation"), "sigmoid"),
        _act(ctx.attr("activation"), "tanh"))
    ctx.set_output("Gate", gate)
    ctx.set_output("ResetHiddenPrev", rhp)
    ctx.set_output("Hidden", h)


@register_op("gru")
def gru(ctx):
    """A whole-sequence GRU over projected Input [B, T, 3D], optional Bias,
    H0 and SeqLen -> Hidden, BatchGate, BatchResetHiddenPrev [B, T, *]."""
    x, weight = ctx.input("Input"), ctx.input("Weight")
    bias, lengths = _optional(ctx, "Bias"), _optional(ctx, "SeqLen")
    reverse = bool(ctx.attr("is_reverse", False))
    gate_act = _act(ctx.attr("gate_activation"), "sigmoid")
    cand_act = _act(ctx.attr("activation"), "tanh")
    b, t, d3 = x.shape
    if reverse:
        x = torch.flip(x, dims=[1])
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)
    h = _initial(ctx, "H0", x, d3 // 3)
    gates, rhps, hs = [], [], []
    for k, xt in enumerate(x.unbind(1)):
        step = t - 1 - k if reverse else k
        gate, rhp, h_new = _gru_cell(xt, h, weight, gate_act, cand_act)
        if lengths is not None:
            h_new = _hold(_live(step, lengths, x.dtype), h_new, h)
        h = h_new
        gates.append(gate)
        rhps.append(rhp)
        hs.append(h)
    ctx.set_output("Hidden", _batch_major(torch.stack(hs), reverse))
    ctx.set_output("BatchGate", _batch_major(torch.stack(gates), reverse))
    ctx.set_output("BatchResetHiddenPrev",
                   _batch_major(torch.stack(rhps), reverse))


@register_op("lstm_unit")
def lstm_unit(ctx):
    """One LSTM step, lstm_unit_op.h:65-75: X [B, 4D] with gates i, f, o, g;
    C = sigmoid(f + forget_bias) * C_prev + sigmoid(i) * tanh(g), H =
    sigmoid(o) * tanh(C)."""
    x, c_prev = ctx.input("X"), ctx.input("C_prev")
    fb = float(ctx.attr("forget_bias", 0.0))
    i, f, o, g = x.chunk(4, dim=-1)
    c = torch.sigmoid(f + fb) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    ctx.set_output("C", c)
    ctx.set_output("H", torch.sigmoid(o) * torch.tanh(c))


def _lstm_seq(ctx, proj_weight=None):
    """The body of `lstm` and `lstmp`: projected Input [B, T, 4D], Weight
    [D or P, 4D], optional Bias ([4D], or [7D] with the peepholes when
    use_peepholes), H0, C0 and SeqLen -> the h (or projection) and c
    sequences, batch-major."""
    x, weight = ctx.input("Input"), ctx.input("Weight")
    bias, lengths = _optional(ctx, "Bias"), _optional(ctx, "SeqLen")
    reverse = bool(ctx.attr("is_reverse", False))
    peephole = bool(ctx.attr("use_peepholes", False)) and bias is not None
    b, t, d4 = x.shape
    d = d4 // 4
    if reverse:
        x = torch.flip(x, dims=[1])
    wic = wfc = woc = None
    if bias is not None:
        bflat = bias.reshape(-1)
        x = x + bflat[:d4].reshape(1, 1, -1)
        if peephole and bflat.shape[0] >= 7 * d:
            wic, wfc, woc = bflat[4 * d:7 * d].chunk(3)
    h = _initial(ctx, "H0", x, weight.shape[0])
    c = _initial(ctx, "C0", x, d)
    cand_act = _act(ctx.attr("candidate_activation"), "tanh")
    cell_act = _act(ctx.attr("cell_activation"), "tanh")
    gate_act = _act(ctx.attr("gate_activation"), "sigmoid")
    hs, cs = [], []
    for k, xt in enumerate(x.unbind(1)):
        i, f, g, o = (xt + _mm(h, weight)).chunk(4, dim=-1)
        if wic is not None:
            i = i + wic * c
            f = f + wfc * c
        c_new = gate_act(f) * c + gate_act(i) * cand_act(g)
        if woc is not None:
            o = o + woc * c_new
        h_new = gate_act(o) * cell_act(c_new)
        if proj_weight is not None:
            h_new = _mm(h_new, proj_weight)
        if lengths is not None:
            live = _live(t - 1 - k if reverse else k, lengths, x.dtype)
            h_new = _hold(live, h_new, h)
            c_new = _hold(live, c_new, c)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    return (_batch_major(torch.stack(hs), reverse),
            _batch_major(torch.stack(cs), reverse))


@register_op("lstm")
def lstm(ctx):
    h_seq, c_seq = _lstm_seq(ctx)
    ctx.set_output("Hidden", h_seq)
    ctx.set_output("Cell", c_seq)


@register_op("lstmp")
def lstmp(ctx):
    """`lstm` with a recurrent projection: Projection [B, T, P] is the
    recurrent state (Weight [P, 4D], ProjWeight [D, P])."""
    h_seq, c_seq = _lstm_seq(ctx, proj_weight=ctx.input("ProjWeight"))
    ctx.set_output("Projection", h_seq)
    ctx.set_output("Cell", c_seq)


def _peepholes(bias, hidden, what):
    """(Wic, Wfc, Woc) from Bias[4H:7H]; a shorter bias raises."""
    bflat = bias.reshape(-1)
    if bflat.shape[0] < 7 * hidden:
        raise ValueError(f"{what} use_peepholes needs Bias[7H] (got "
                         f"{bflat.shape[0]}, hidden {hidden})")
    return bflat[4 * hidden:7 * hidden].chunk(3)


@register_op("fusion_lstm")
def fusion_lstm(ctx):
    """The reference's fused LSTM IO: X unprojected [B, S, D], WeightX,
    WeightH, Bias ([4H], or [7H] with use_peepholes), H0, C0 -> Hidden,
    Cell and XX (the input projection plus bias), all in X's time order."""
    x, wh = ctx.input("X"), ctx.input("WeightH")
    b = _optional(ctx, "Bias")
    reverse = bool(ctx.attr("is_reverse", False))
    hidden = wh.shape[0]
    peep = None
    if bool(ctx.attr("use_peepholes", False)) and b is not None:
        peep = _peepholes(b, hidden, "fusion_lstm")
    xw = _project_input(x, ctx.input("WeightX"), b, reverse, 4 * hidden)
    hs, cs = _lstm_steps(xw, _initial(ctx, "H0", x, hidden),
                         _initial(ctx, "C0", x, hidden), wh, peep)
    ctx.set_output("Hidden", _batch_major(hs, reverse))
    ctx.set_output("Cell", _batch_major(cs, reverse))
    ctx.set_output("XX", _batch_major(xw, reverse))


@register_op("fusion_gru")
def fusion_gru(ctx):
    """The reference's fused GRU IO: X, WeightX, WeightH, Bias, H0 ->
    Hidden and XX."""
    x, wh = ctx.input("X"), ctx.input("WeightH")
    reverse = bool(ctx.attr("is_reverse", False))
    hidden = wh.shape[0]
    xw = _project_input(x, ctx.input("WeightX"), _optional(ctx, "Bias"),
                        reverse, 3 * hidden)
    hs = _gru_steps(xw, _initial(ctx, "H0", x, hidden), wh, hidden)
    ctx.set_output("Hidden", _batch_major(hs, reverse))
    ctx.set_output("XX", _batch_major(xw, reverse))


def _seq_mask(b, s, lengths, dtype, device):
    """[B, S]: 1 where the step is inside the row's length."""
    if lengths is None:
        return torch.ones((b, s), dtype=dtype, device=device)
    steps = torch.arange(s, device=device)[None, :]
    return (steps < lengths.reshape(b, 1)).to(dtype)


@register_op("attention_lstm")
def attention_lstm(ctx):
    """attention_lstm_op.cc: at each step an additive attention over the
    whole of X [B, S, M], conditioned on the previous cell, pools X into
    one vector that drives an LSTM step.  LSTMWeight [(D+M), 4D] (rows
    [0:D] for h, [D:D+M] for the pooled x), gates f, i, o, g;
    AttentionWeight [(M+D), 1].  A row with no live step pools zeros."""
    x, c = ctx.input("X"), ctx.input("C0")
    lengths = _optional(ctx, "SeqLen")
    aw = ctx.input("AttentionWeight")
    ab = _optional(ctx, "AttentionBias")
    a_scalar = _optional(ctx, "AttentionScalar")
    a_scalar_b = _optional(ctx, "AttentionScalarBias")
    lw = ctx.input("LSTMWeight")
    lb = ctx.input("LSTMBias").reshape(-1)
    b, s, m = x.shape
    d = lw.shape[1] // 4
    h = _initial(ctx, "H0", x, d)
    act_gate = _act(str(ctx.attr("gate_activation", "sigmoid")), "sigmoid")
    act_cell = _act(str(ctx.attr("cell_activation", "tanh")), "tanh")
    act_cand = _act(str(ctx.attr("candidate_activation", "tanh")), "tanh")
    aw_x, aw_c = aw[:m, 0], aw[m:, 0]
    wh, wx = lw[:d], lw[d:]
    mask = _seq_mask(b, s, lengths, torch.bool, x.device)
    atted_x = torch.einsum("bsm,m->bs", x, aw_x)
    if ab is not None:
        atted_x = atted_x + ab.reshape(())
    row_live = mask.any(dim=1, keepdim=True)
    hs, cs = [], []
    for t in range(s):
        score = torch.relu(atted_x + _mm(c, aw_c)[:, None])
        if a_scalar is not None:
            score = score * a_scalar.reshape(())
            if a_scalar_b is not None:
                score = score + a_scalar_b.reshape(())
            score = torch.relu(score)
        score = torch.where(mask, score, float("-inf"))
        alpha = torch.where(row_live, torch.softmax(score, dim=-1), 0.0)
        lstm_x = torch.einsum("bs,bsm->bm", alpha, x)
        f, i, o, g = (_mm(lstm_x, wx) + _mm(h, wh) + lb).chunk(4, dim=-1)
        c_new = act_gate(f) * c + act_gate(i) * act_cand(g)
        h_new = act_cell(c_new) * act_gate(o)
        if lengths is not None:
            live = (t < lengths.reshape(b, 1))
            h_new = torch.where(live, h_new, h)
            c_new = torch.where(live, c_new, c)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    ctx.set_output("Hidden", torch.stack(hs, dim=1))
    ctx.set_output("Cell", torch.stack(cs, dim=1))


def _cifo_to_ifgo(w):
    """The reference's c, i, f, o gate columns -> i, f, g(c), o."""
    c_, i_, f_, o_ = w.chunk(4, dim=-1)
    return torch.cat([i_, f_, c_, o_], dim=-1)


@register_op("fused_embedding_fc_lstm")
def fused_embedding_fc_lstm(ctx):
    """fused_embedding_fc_lstm_op.cc: the fuse pass has folded X @ WeightX
    and the gate bias into the Embeddings rows [V, 4D], so XX is the
    looked-up rows and Bias is read only for the peepholes (Bias[4D:7D]).
    gate_layout "ifgo" (this repo's) or "cifo" (the reference's tables,
    whose looked-up rows and WeightH are permuted on entry; XX is emitted
    in ifgo)."""
    ids, table = ctx.input("Ids"), ctx.input("Embeddings")
    wh = ctx.input("WeightH")
    layout = str(ctx.attr("gate_layout", "ifgo") or "ifgo")
    if layout not in ("ifgo", "cifo"):
        raise ValueError(
            f"gate_layout must be 'ifgo' or 'cifo', got {layout!r}")
    if layout == "cifo":
        wh = _cifo_to_ifgo(wh)
    bias = ctx.input("Bias").reshape(-1)
    reverse = bool(ctx.attr("is_reverse", False))
    ids2 = ids.reshape(ids.shape[0], -1)
    hidden = wh.shape[0]
    peep = None
    if bool(ctx.attr("use_peepholes", False)):
        peep = _peepholes(bias, hidden, "fused_embedding_fc_lstm")
    xx = table[ids2]
    if layout == "cifo":
        xx = _cifo_to_ifgo(xx)
    xw = xx.transpose(0, 1)
    if reverse:
        xw = torch.flip(xw, dims=[0])
    bsz = ids2.shape[0]
    hs, cs = _lstm_steps(xw, _initial(ctx, "H0", table, hidden, bsz),
                         _initial(ctx, "C0", table, hidden, bsz), wh, peep)
    ctx.set_output("Hidden", _batch_major(hs, reverse))
    ctx.set_output("Cell", _batch_major(cs, reverse))
    ctx.set_output("XX", xx)


@register_op("fusion_seqconv_eltadd_relu")
def fusion_seqconv_eltadd_relu(ctx):
    """sequence_conv + bias + relu: the context windows are contextLength
    masked time shifts of X [B, S, M] side by side (ColMat [B, S, cl*M]),
    one product with Filter [cl*M, N], then the bias, the relu and the
    row mask."""
    x, filt = ctx.input("X"), ctx.input("Filter")
    bias = ctx.input("Bias").reshape(-1)
    lengths = _optional(ctx, "SeqLen")
    cl = int(ctx.attr("contextLength"))
    start = int(ctx.attr("contextStart", 0))
    if int(ctx.attr("contextStride", 1)) != 1:
        raise ValueError("fusion_seqconv_eltadd_relu: contextStride must "
                         "be 1 (reference-only constraint)")
    b, s, m = x.shape
    mask = _seq_mask(b, s, lengths, x.dtype, x.device)
    xm = x * mask[..., None]
    steps = torch.arange(s, device=x.device)[None, :]
    cols = []
    for k in range(cl):
        off = start + k
        src = steps + off
        valid = ((src >= 0) & (src < s))[..., None]
        cols.append(torch.where(valid, torch.roll(xm, -off, dims=1), 0.0))
    col = torch.cat(cols, dim=-1)
    out = torch.relu(torch.einsum("bsk,kn->bsn", col, filt) + bias)
    ctx.set_output("Out", out * mask[..., None])
    ctx.set_output("ColMat", col)


@register_op("fusion_seqexpand_concat_fc")
def fusion_seqexpand_concat_fc(ctx):
    """X[0] [B, S, M0] and the per-row vectors X[1:] [B, Mi] broadcast to
    every step, side by side, one FC (+ fc_activation), the row mask."""
    xs = ctx.inputs("X")
    w = ctx.input("FCWeight")
    fc_bias = _optional(ctx, "FCBias")
    lengths = _optional(ctx, "SeqLen")
    act = _act(str(ctx.attr("fc_activation", "identity")), "identity")
    ref = xs[0]
    b, s, _ = ref.shape
    parts = [ref] + [xi[:, None, :].expand(b, s, xi.shape[-1])
                     for xi in xs[1:]]
    out = torch.einsum("bsk,kn->bsn", torch.cat(parts, dim=-1), w)
    if fc_bias is not None:
        out = out + fc_bias.reshape(-1)
    out = act(out) * _seq_mask(b, s, lengths, ref.dtype, ref.device)[..., None]
    ctx.set_output("Out", out)
    ctx.set_output("FCOut", out)
