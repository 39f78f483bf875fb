"""Mixture-of-experts ops: top_k_gating and the fused expert FFN.

Counterpart of paddle_tpu/ops/moe_ops.py, op for op:

  top_k_gating   softmax over [N, E] router logits, the top-k experts of
                 each token (equal probabilities: the lower expert index
                 first, as jax.lax.top_k), GShard capacity (the position
                 of an assignment in its expert ranks every first choice
                 ahead of every second choice, tokens in batch order;
                 assignments past the capacity are DROPPED), and the
                 load-balance loss E * sum_e f_e * P_e.
  moe_expert_ffn dispatch each kept assignment into its own row of an
                 [E, C, d] buffer, run every expert at once (`torch.bmm`
                 over the expert-major weights [E, d, f] / [E, f, d]),
                 and combine back per assignment slot.

Batch invariance (the serving contract, ROADMAP C4): at
capacity_factor <= 0 nothing drops, the dispatch is a SET (each (expert,
position) row is written by one token), the expert product is row-wise
and the combine reads rows back with per-slot gathers, adding
gate_j * term_j for j = 0..k-1 in that order.  No step reduces across
tokens (no index_add_ or scatter_add_, whose atomics would reorder the
sums on the card), so a token's output is the same whether it runs alone
or in a batch, as far as the product itself is.

Capacity is computed in Python from the static shapes (N counts every
row, padding included, as in the JAX package), so both ops capture.
Gradients: moe_expert_ffn takes the registry's generic one; top_k_gating
differentiates only its float outputs (Gates, AuxLoss), a missing
cotangent counting as zeros.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_grad, register_op

__all__ = ["expert_capacity"]


def expert_capacity(num_tokens, num_experts, k, capacity_factor):
    """Static slots per expert, C.  capacity_factor <= 0, None or not
    finite means infinite capacity: C = num_tokens (the top-k experts of a
    token are distinct, so no expert receives more), the decode tier's
    no-drop contract.  Otherwise ceil(cf * N * k / E) clamped to [1, N]."""
    n, e, k = int(num_tokens), int(num_experts), int(k)
    if (capacity_factor is None or not math.isfinite(capacity_factor)
            or capacity_factor <= 0):
        return max(1, n)
    c = int(math.ceil(float(capacity_factor) * n * k / e))
    return max(1, min(n, c))


def _activation(name):
    acts = {"relu": torch.relu,
            # jax.nn.gelu's default is the tanh form
            "gelu": lambda h: F.gelu(h, approximate="tanh"),
            None: lambda h: h, "": lambda h: h}
    if name not in acts:
        raise ValueError(f"moe_expert_ffn: unknown act {name!r}")
    return acts[name]


def _gating_core(logits, k, capacity_factor, renormalize):
    """-> (gates [N, k] capacity-masked, idx int32 [N, k], pos int32 [N, k]
    position in expert, aux [] scalar, load [E] kept assignments a
    expert, dropped [] count); aux, load and dropped in the logits'
    dtype."""
    n, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    # the stable sort keeps equal probabilities in index order
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :k], order[:, :k]
    gates = (gate_vals / gate_vals.sum(dim=-1, keepdim=True)
             if renormalize else gate_vals)
    experts = torch.arange(e, device=logits.device)
    onehot = (expert_idx[..., None] == experts).to(torch.int32)  # [N, k, E]
    # slot-major ranks, every first choice ahead of every second: an
    # exclusive running count in int32 (cumsum would widen) along the k*N
    # assignments, laid out [E, k * N] so that the scan runs along the
    # contiguous dim (a scan down [k * N, E]'s rows walks each of its E
    # columns in one thread)
    flat = onehot.permute(2, 1, 0).reshape(e, k * n)
    ranks = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = torch.gather(ranks, 0, expert_idx.t().reshape(1, k * n))
    pos = pos.reshape(k, n).t()                                  # [N, k]
    cap = expert_capacity(n, e, k, capacity_factor)
    keep = pos < cap
    gates = gates * keep.to(gates.dtype)
    # f_e counts assignments whether kept or not, constant in the logits;
    # P_e is the mean router probability, the differentiable half
    assign_frac = onehot.to(probs.dtype).reshape(n * k, e).mean(dim=0)
    density = probs.mean(dim=0)
    aux = e * (assign_frac * density).sum()
    load = (onehot * keep[..., None].to(torch.int32)).reshape(
        n * k, e).sum(dim=0).to(probs.dtype)
    dropped = torch.full((), n * k, dtype=probs.dtype,
                         device=logits.device) - load.sum()
    return (gates, expert_idx.to(torch.int32), pos.to(torch.int32), aux,
            load, dropped)


class _UniqueRowGather(torch.autograd.Function):
    """rows = table[index] whose backward writes each row's grad back
    with a set (index_copy), not an add: every index but the table's last
    row (the trash row) appears at most once, so no row is summed into,
    and the trash row's grad is discarded by the caller.  The generic
    gather's backward accumulates with a sort."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.rows = table.shape[0]
        return table.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        table_grad = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        return table_grad.index_copy(0, index, grad), None


def _gating_attrs(ctx):
    k = int(ctx.attr("k", 2))
    cf = ctx.attr("capacity_factor", 0.0)
    cf = 0.0 if cf is None else float(cf)
    return k, cf, bool(ctx.attr("renormalize", True))


@register_op("top_k_gating")
def top_k_gating(ctx):
    """Logits [..., E] -> Gates, Indices, Positions [..., k], AuxLoss [1],
    Load [E], Dropped [1].  Leading dims are one token axis inside, so
    [B, S, E] and [B * S, E] route alike."""
    logits = ctx.input("Logits")
    k, cf, renorm = _gating_attrs(ctx)
    lead = tuple(logits.shape[:-1])
    gates, idx, pos, aux, load, dropped = _gating_core(
        logits.reshape(-1, logits.shape[-1]), k, cf, renorm)
    ctx.set_output("Gates", gates.reshape(lead + (k,)))
    ctx.set_output("Indices", idx.reshape(lead + (k,)))
    ctx.set_output("Positions", pos.reshape(lead + (k,)))
    ctx.set_output("AuxLoss", aux.reshape(1))
    ctx.set_output("Load", load)
    ctx.set_output("Dropped", dropped.reshape(1))


@register_grad("top_k_gating")
def _top_k_gating_grad(ctx):
    """The backward of the float outputs alone (Gates, AuxLoss): Indices
    and Positions are integers, Load and Dropped metrics, and their grad
    slots arrive empty.  A missing cotangent counts as zeros."""
    logits = ctx.input("Logits").detach().requires_grad_(True)
    k, cf, renorm = _gating_attrs(ctx)
    with torch.enable_grad():
        gates, _, _, aux, _, _ = _gating_core(
            logits.reshape(-1, logits.shape[-1]), k, cf, renorm)
        gates = gates.reshape(tuple(logits.shape[:-1]) + (k,))
        aux = aux.reshape(1)
        g_gates = ctx.input("Gates@GRAD")
        g_aux = ctx.input("AuxLoss@GRAD")
        g_gates = (torch.zeros_like(gates) if g_gates is None
                   else g_gates.to(gates.dtype))
        g_aux = (torch.zeros_like(aux) if g_aux is None
                 else g_aux.reshape(1).to(aux.dtype))
        (d_logits,) = torch.autograd.grad([gates, aux], [logits],
                                          [g_gates, g_aux])
    ctx.set_output("Logits@GRAD", d_logits)


@register_op("moe_expert_ffn")
def moe_expert_ffn(ctx):
    """Dispatch -> the experts' FFN -> combine.

    X [..., d] and Gates/Indices/Positions [..., k] of top_k_gating (the
    same leading dims, one token axis inside), W1 [E, d, f], B1 [E, f],
    W2 [E, f, d], B2 [E, d].  C comes from the same (N, E, k,
    capacity_factor) as the gating's, so both agree on the drop set.  A
    dropped assignment writes the trash row E * C, never read back, and
    combines with a zero gate: its token keeps only the residual."""
    x = ctx.input("X")
    w1, b1 = ctx.input("W1"), ctx.input("B1")
    w2, b2 = ctx.input("W2"), ctx.input("B2")
    k, cf, _ = _gating_attrs(ctx)
    act = _activation(ctx.attr("act", "relu"))
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    x = x.reshape(-1, d)
    gates = ctx.input("Gates").reshape(-1, k)
    idx = ctx.input("Indices").reshape(-1, k).to(torch.int64)
    pos = ctx.input("Positions").reshape(-1, k).to(torch.int64)
    n, e = x.shape[0], w1.shape[0]
    cap = expert_capacity(n, e, k, cf)

    # dispatch: a set, one (expert, position) row a kept assignment
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos,
                       torch.full_like(pos, e * cap)).reshape(n * k)
    xx = x[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = x.new_zeros((e * cap + 1, d)).index_copy(0, slot, xx)
    expert_in = buf[:e * cap].reshape(e, cap, d)

    h = act(torch.bmm(expert_in, w1) + b1[:, None, :])
    y = torch.bmm(h, w2) + b2[:, None, :]

    # combine: each slot's row gathered back (a dropped slot reads the
    # zero trash row; the JAX package reads a clamped row instead, which
    # its zero gate removes alike), added in slot order, never a
    # cross-token reduction
    table = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    rows = _UniqueRowGather.apply(table, slot).reshape(n, k, d)
    out = x.new_zeros((n, d))
    for j in range(k):
        g = (gates[:, j] * keep[:, j].to(gates.dtype)).to(x.dtype)[:, None]
        out = out + g * rows[:, j]
    ctx.set_output("Out", out.reshape(lead + (d,)))
