"""Per-layer KV cache for autoregressive decode: the dense
`kv_cache_append` op and its functional `append` (paddle_tpu/ops/kv_cache.py
:81 and :100).  The paged pools are the serving Scheduler's slice
(ROADMAP A).

A cache is a preallocated [B, max_len, H*D] buffer; each step's k/v rows
land at per-row write cursors.  The JAX package writes with
`lax.dynamic_update_slice`, which CLAMPS the start so the write fits: a
cursor past L - T writes at L - T.  The port clamps the same way, never
indexes out of range and never truncates.

Unlike the JAX package (immutable arrays), the write is IN PLACE: OutK is
CacheK.  decode.Generator owns its caches and replaces each state with the
op's output every step, so nothing else sees the old value — and a step
neither allocates nor copies a whole [B, max_len, H*D] cache.
"""

from __future__ import annotations

import torch

from .registry import register_infer_shape, register_op


def append(cache, new, lengths):
    """Write `new` [B, T, ...] into `cache` [B, L, ...] at per-row cursors
    `lengths` [B] (clamped into [0, L - T]), in place; returns `cache`.
    Cursors are NOT advanced here — the caller owns them."""
    b, cap = cache.shape[0], cache.shape[1]
    t = new.shape[1]
    start = torch.clamp(lengths.reshape(b).to(torch.int64), 0, cap - t)
    pos = start[:, None] + torch.arange(t, device=cache.device)
    rows = torch.arange(b, device=cache.device)[:, None]
    cache[rows, pos] = new.to(cache.dtype)
    return cache


@register_op("kv_cache_append")
def kv_cache_append(ctx):
    """CacheK/CacheV [B, L, ...] + K/V [B, T, ...] + Lengths [B] ->
    OutK/OutV: both caches with the new rows written at each row's
    cursor."""
    lengths = ctx.input("Lengths")
    ctx.set_output("OutK", append(ctx.input("CacheK"), ctx.input("K"),
                                  lengths))
    ctx.set_output("OutV", append(ctx.input("CacheV"), ctx.input("V"),
                                  lengths))


@register_infer_shape("kv_cache_append")
def _kv_cache_append_shape(op, block):
    """Outputs mirror the cache inputs exactly."""
    for cache_param, out_param in (("CacheK", "OutK"), ("CacheV", "OutV")):
        src = block._var_recursive(op.inputs[cache_param][0])
        dst = block._var_recursive(op.outputs[out_param][0])
        dst.shape = src.shape
        dst.dtype = src.dtype
