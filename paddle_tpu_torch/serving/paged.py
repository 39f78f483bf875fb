"""Paged step-program rewrite: the device-resident KV decode path
(counterpart of paddle_tpu/serving/paged.py).

The dense step program that models emit (models/*.build_decode) feeds
each decoder layer's KV cache as a per-request dense tensor
``cache_k_i [B, max_len, H*D]`` that kv_cache_append writes at the row
cursor and fused_attention reads under the SeqLen mask.  Serving's dense
path satisfies that contract by gathering every request's block table
back to the dense layout EVERY STEP — a host fancy-index plus a full cache
upload per step, the transfer the paged path exists to remove.

`build_paged_step` clones the step program and rewrites that KV path
against the shared device pool:

  * each pool-backed ``kv_cache_append`` becomes ``kv_cache_append_paged``
    (the dense cache feeds become the whole-pool ``[N, block_size, H*D]``
    streams, routed by a new ``kv_block_table [B, M]`` data var);
  * each ``fused_attention`` reading an appended cache gains the
    BlockTable input and a ``paged_max_len`` attr, which puts it on the
    paged decode form (the flash_decode_paged kernel on the card, the
    paged gather reference elsewhere — ops/attention_ops.py).

Var NAMES are kept (``cache_k_i`` still names the k stream, the append's
OutK still names the attention input and the step fetch), so the
GenerationSpec's feed/update wiring holds unchanged — only the tensors
behind the names switch from per-request dense to the shared pool.
Cross-attention constant states (enc_k/enc_v) are not pool-backed and pass
through untouched.
"""

from __future__ import annotations

__all__ = ["BLOCK_TABLE_VAR", "build_paged_step"]

BLOCK_TABLE_VAR = "kv_block_table"


def build_paged_step(spec, block_size, num_blocks, program=None):
    """Clone spec.step_program (or `program`) with its pool-backed KV path
    rewritten to consume the shared block pool through a block table.
    Returns the rewritten Program; raises if the spec has no pool-backed
    cache."""
    if spec.max_len is None:
        raise ValueError("paged step rewrite needs spec.max_len")
    paged_feeds = {s.feed for s in spec.states
                   if (s.update or s.verify_update)
                   and s.pad_to is not None}
    if not paged_feeds:
        raise ValueError("spec has no pool-backed (paged) states")
    table_width = -(-int(spec.max_len) // int(block_size))
    prog = (spec.step_program if program is None else program).clone()
    blk = prog.global_block()
    blk.create_var(name=BLOCK_TABLE_VAR, shape=[-1, table_width],
                   dtype="int64", is_data=True)

    paged_outs = set()
    for op in blk.ops:
        if op.type != "kv_cache_append":
            continue
        ck = op.input("CacheK")
        if not ck or ck[0] not in paged_feeds:
            continue
        op.type = "kv_cache_append_paged"
        op.inputs["KBlocks"] = op.inputs.pop("CacheK")
        op.inputs["VBlocks"] = op.inputs.pop("CacheV")
        op.inputs["BlockTable"] = [BLOCK_TABLE_VAR]
        # the cache vars (and the op's mirrored outputs) now hold the
        # whole pool; infer_shape only runs at append time, so the var
        # metadata is retargeted by hand
        for pool_param, out_param in (("KBlocks", "OutK"),
                                      ("VBlocks", "OutV")):
            src = blk._var_recursive(op.inputs[pool_param][0])
            tail = list(src.shape[2:])
            src.shape = (int(num_blocks), int(block_size), *tail)
            dst = blk._var_recursive(op.outputs[out_param][0])
            dst.shape = tuple(src.shape)
            paged_outs.add(op.outputs[out_param][0])
    if not paged_outs:
        raise ValueError(
            "step program has no kv_cache_append over a paged state — "
            "nothing to rewrite")

    for op in blk.ops:
        if op.type != "fused_attention":
            continue
        k_in = op.input("K")
        if not k_in or k_in[0] not in paged_outs:
            continue
        op.inputs["BlockTable"] = [BLOCK_TABLE_VAR]
        op.attrs["paged_max_len"] = int(spec.max_len)

    return prog
