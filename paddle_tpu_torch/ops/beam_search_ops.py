"""One step of beam search (paddle_tpu/ops/beam_search_ops.py:107-191).

The dense form of the reference's LoD op: the source sentence is a batch
dim.  pre_ids [B, beam], pre_scores [B, beam], candidate ids [B, beam, K]
and their accumulated scores [B, beam, K] -> selected_ids,
selected_scores and parent_idx [B, beam] (the source beam of each
selection, which reorders the decode states).  A finished beam (pre_id ==
end_id) offers exactly one candidate, (end_id, pre_score); the top
beam_size of the pooled candidates survive per row, ties going to the
lower pooled index as `jax.lax.top_k` breaks them; a row whose beams all
finished stays as it was.  The first step pools beam 0 alone, by attr
`is_first_step` or by the bool input IsFirstStep.

`beam_search_decode`, the JAX package's fused stateful op over a decoder
sub-block, is not ported yet (ROADMAP A1).
"""

from __future__ import annotations

import torch

from .registry import register_op

_NEG = -1e30


def top_k(x, k):
    """(values, indices) of the k largest along the last dim, equal values
    lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
