"""Beam search: the fused decode over a decoder sub-block
(`beam_search_decode`, paddle_tpu/ops/beam_search_ops.py:24-104) and one
step of it (`beam_search`, :107-191).

`beam_search_decode` runs the whole decode as one op: a loop over
max_len steps (the JAX package's lax.scan), unrolled, with a fixed
[B, K, max_len + 1] token buffer, so that a captured segment replays it
without a host read.  Each step replays the decoder sub-block
(control_flow_ops.replay_ops) on the previous tokens [B*K] and the
recurrent states, takes the log-softmax of its logits, lets a dead beam
extend only with eos at no cost, keeps the top K of the K*V totals a row
(`top_k`: ties to the lower index, as lax.top_k), and reorders the
states by each survivor's source beam.

`beam_search` is the dense form of the reference's LoD op: the source
sentence is a batch dim.  pre_ids [B, beam], pre_scores [B, beam],
candidate ids [B, beam, K] and their accumulated scores [B, beam, K] ->
selected_ids, selected_scores and parent_idx [B, beam] (the source beam
of each selection, which reorders the decode states).  A finished beam
(pre_id == end_id) offers exactly one candidate, (end_id, pre_score); the
top beam_size of the pooled candidates survive per row, ties going to
the lower pooled index as `jax.lax.top_k` breaks them; a row whose beams
all finished stays as it was.  The first step pools beam 0 alone, by
attr `is_first_step` or by the bool input IsFirstStep.
"""

from __future__ import annotations

import torch

from .control_flow_ops import private, replay_ops
from .registry import register_op

_NEG = -1e30


def top_k(x, k):
    """(values, indices) of the k largest along the last dim, equal values
    lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("beam_search_decode", no_grad=True, stateful=True)
def beam_search_decode(ctx):
    """attrs: sub_block, ids_name (the sub-block's previous ids [B*K]),
    logits_name (its logits [B*K, V]), cap_names, state_names and
    state_update_names (the recurrent states before and after a step),
    beam_size K, max_len, bos_id, eos_id, batch_size B.  inputs: Init
    (the states, tiled to [B*K, ...]), Cap (the outer vars the block
    reads).  outputs: Out [B, K, max_len] token ids, Scores [B, K]."""
    block = ctx.attr("sub_block")
    ids_name = ctx.attr("ids_name")
    logits_name = ctx.attr("logits_name")
    state_names = list(ctx.attr("state_names", []) or [])
    upd_names = list(ctx.attr("state_update_names", []) or [])
    k = int(ctx.attr("beam_size"))
    max_len = int(ctx.attr("max_len"))
    bos = int(ctx.attr("bos_id", 0))
    eos = int(ctx.attr("eos_id", 1))
    b = int(ctx.attr("batch_size", 1))
    cap_env = dict(zip(ctx.attr("cap_names", []) or [], ctx.inputs("Cap")))
    states = private(block, ctx.inputs("Init"))
    dev = next((t.device for t in list(cap_env.values()) + states
                if t is not None), ctx.device)

    def reorder(state, src):
        s = state.reshape((b, k) + tuple(state.shape[1:]))
        idx = src.reshape((b, k) + (1,) * (s.dim() - 2)).expand(s.shape)
        return torch.gather(s, 1, idx).reshape(state.shape)

    tokens = torch.full((b, k, max_len + 1), bos, dtype=torch.int64,
                        device=dev)
    # beam 0 starts live, the others at -1e30 so that step 1 fans out
    scores = torch.cat([torch.zeros((b, 1), device=dev),
                        torch.full((b, k - 1), _NEG, device=dev)], dim=1)
    alive = torch.ones((b, k), dtype=torch.bool, device=dev)
    pos = torch.arange(max_len + 1, device=dev)
    eos_only = None
    for t in range(max_len):
        env = dict(cap_env)
        env[ids_name] = tokens[:, :, t].reshape(b * k)
        env.update(zip(state_names, states))
        env = replay_ops(block.ops, env, ctx._rng, dev)
        logp = torch.log_softmax(env[logits_name].float(), dim=-1)
        logp = logp.reshape(b, k, -1)
        v = logp.shape[-1]
        if eos_only is None:
            # a dead beam extends with eos alone, at no cost (with every
            # token -inf when eos lies outside the vocabulary); built on
            # the device, as a capture allows no copy from the host
            eos_only = torch.where(
                torch.arange(v, device=dev) == eos,
                torch.zeros((), device=dev),
                torch.full((), float("-inf"), device=dev))
        logp = torch.where(alive[..., None], logp, eos_only)
        total = scores[..., None] + logp
        scores, top_idx = top_k(total.reshape(b, k * v), k)
        src = torch.div(top_idx, v, rounding_mode="floor")
        new_tok = top_idx % v
        gathered = torch.gather(
            tokens, 1, src[..., None].expand(b, k, max_len + 1))
        tokens = torch.where(pos == t + 1, new_tok[..., None], gathered)
        alive = torch.gather(alive, 1, src) & (new_tok != eos)
        states = [reorder(env[n], src) for n in upd_names]
    ctx.set_output("Out", tokens[..., 1:])
    ctx.set_output("Scores", scores)


@register_op("beam_search", no_grad=True)
def beam_search(ctx):
    pre_ids = ctx.input("pre_ids")
    pre_scores = ctx.input("pre_scores")
    ids = ctx.input("ids")
    scores = ctx.input("scores").float()
    beam_size = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    first = bool(ctx.attr("is_first_step", False))
    b, beam, k = scores.shape
    if beam_size != beam:
        raise ValueError(
            f"beam_search: selected width must equal the beam dim "
            f"(got beam_size={beam_size}, beams={beam})")
    dev = scores.device
    finished = pre_ids == end_id                              # [B, beam]
    # the pool [B, beam, K + 1]: a live beam's K candidates and a -inf
    # slot; a finished beam's (end_id, pre_score) slot alone
    pool_scores = torch.cat([
        torch.where(finished[..., None], _NEG, scores),
        torch.where(finished, pre_scores.float(), _NEG)[..., None]], -1)
    pool_ids = torch.cat([ids, torch.full((b, beam, 1), end_id,
                                          dtype=ids.dtype, device=dev)], -1)
    first_in = (ctx.input("IsFirstStep")
                if ctx.has_input("IsFirstStep") else None)
    if first_in is not None or first:
        if beam_size > k:
            raise ValueError(
                f"beam_search first step needs K >= beam_size candidates "
                f"(got K={k}, beam_size={beam_size})")
        only0 = (torch.arange(beam, device=dev) == 0).reshape(1, beam, 1)
        if first_in is not None:
            fb = first_in.reshape(()).to(device=dev, dtype=torch.bool)
            pool_scores = torch.where(fb & ~only0, _NEG, pool_scores)
        else:
            pool_scores = torch.where(only0, pool_scores, _NEG)
    top_scores, top_pos = top_k(pool_scores.reshape(b, beam * (k + 1)),
                                 beam_size)
    parent = torch.div(top_pos, k + 1, rounding_mode="floor").to(torch.int32)
    sel_ids = torch.gather(pool_ids.reshape(b, beam * (k + 1)), 1, top_pos)
    # an all-finished row would select -inf slots past its finished beams:
    # it keeps its beams as they were
    row_done = finished.all(dim=1, keepdim=True)
    sel_ids = torch.where(row_done, pre_ids.to(sel_ids.dtype), sel_ids)
    top_scores = torch.where(row_done, pre_scores.float(), top_scores)
    parent = torch.where(
        row_done, torch.arange(beam_size, device=dev,
                               dtype=torch.int32)[None, :], parent)
    ctx.set_output("selected_ids", sel_ids)
    ctx.set_output("selected_scores", top_scores.to(pre_scores.dtype))
    ctx.set_output("parent_idx", parent)
