"""KV storage for autoregressive decode: the dense per-layer cache
(`kv_cache_append`, `append`), its paged counterpart over a shared block
pool (`kv_cache_append_paged`, `append_paged`) and the serving tier's
pools (`BlockPool` on the host, `DeviceBlockPool` on a torch device).
Counterpart of paddle_tpu/ops/kv_cache.py.

A dense cache is a preallocated [B, max_len, H*D] buffer; each step's k/v
rows land at per-row write cursors.  The JAX package writes with
`lax.dynamic_update_slice`, which CLAMPS the start so the write fits: a
cursor past L - T writes at L - T.  The port clamps the same way, never
indexes out of range and never truncates.

Unlike the JAX package (immutable arrays), every write here is IN PLACE:
OutK is CacheK (and, paged, OutK is KBlocks).  decode.Generator owns its
dense caches and replaces each state with the op's output every step, and
the serving Scheduler installs the pool tensor the paged op returns, so
nothing else sees the old value — and a step neither allocates nor copies
a whole cache or pool.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.core_types import as_device, convert_dtype, dtype_to_torch
from .registry import register_infer_shape, register_op

__all__ = ["append", "append_paged", "gather_beams", "BlockPool",
           "DeviceBlockPool", "PoolExhausted"]


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


def gather_beams(cache, parent, batch, beam):
    """Beam-hop reorder (paddle_tpu/ops/kv_cache.py:90-97): the rows of
    `cache` [batch * beam, ...] taken from their parent beams, `parent`
    [batch, beam], by one gather; returns a new tensor."""
    idx = (torch.arange(batch, device=cache.device)[:, None] * beam
           + parent.to(device=cache.device, dtype=torch.int64))
    return cache.index_select(0, idx.reshape(-1))


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
    _mirror_shapes(op, block, (("CacheK", "OutK"), ("CacheV", "OutV")))


def _mirror_shapes(op, block, pairs):
    for src_param, out_param in pairs:
        src = block._var_recursive(op.inputs[src_param][0])
        dst = block._var_recursive(op.outputs[out_param][0])
        dst.shape = src.shape
        dst.dtype = src.dtype


def append_paged(blocks, new, table, lengths):
    """Paged counterpart of `append`: write `new` [B, T, ...] into the
    shared block pool `blocks` [N, block_size, ...] at each row's cursor,
    routed through `table` [B, M] (pool block ids in cursor order), in
    place; returns `blocks`.

    The JAX package's scatter semantics (`.at[blk, off].set(mode="drop")`
    after a fill-mode `take_along_axis`), reproduced exactly: a write whose
    cursor falls past the table's M columns drops, a block id in [-N, 0)
    wraps to id + N (NumPy indexing), and any other id outside [0, N)
    drops.  Duplicate targets (the Scheduler pads a short batch by
    replicating row 0, same table and cursor) write identical values.

    The whole [B, T] window lands in one `index_put_`: a 512-row chunk
    window is one scatter per pool, not 512.  Its shape is static (no
    `nonzero`, no read back to the host, so a CUDA graph can hold it): a
    dropped write is turned into a copy of the first kept one, the same
    target and the same value, or, when nothing is kept, into a write of
    block 0's row 0 over itself."""
    n, bs = blocks.shape[0], blocks.shape[1]
    b, m = table.shape
    t = new.shape[1]
    table = table.to(device=blocks.device, dtype=torch.int64)
    lengths = lengths.reshape(b).to(device=blocks.device, dtype=torch.int64)
    pos = lengths[:, None] + torch.arange(t, device=blocks.device)
    slot = torch.div(pos, bs, rounding_mode="floor")
    in_table = (slot >= 0) & (slot < m)
    blk = torch.gather(table, 1, slot.clamp(0, m - 1))
    blk = torch.where(blk < 0, blk + n, blk)
    keep = (in_table & (blk >= 0) & (blk < n)).reshape(b * t)
    blk, off = blk.reshape(b * t), (pos % bs).reshape(b * t)
    rows = new.reshape((b * t,) + tuple(new.shape[2:])).to(blocks.dtype)
    # the first kept write (0 when none is): a one-element index, since
    # indexing by a 0-d tensor would read it back to the host
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    some = keep.any()
    zero = torch.zeros((), dtype=torch.int64, device=blocks.device)
    blk = torch.where(keep, blk,
                      torch.where(some, blk.index_select(0, first), zero))
    off = torch.where(keep, off,
                      torch.where(some, off.index_select(0, first), zero))
    fill = torch.where(some, rows.index_select(0, first)[0], blocks[0, 0])
    rows = torch.where(keep.reshape((-1,) + (1,) * (rows.dim() - 1)), rows,
                       fill)
    blocks.index_put_((blk, off), rows)
    return blocks


@register_op("kv_cache_append_paged", no_grad=True)
def kv_cache_append_paged(ctx):
    """KBlocks/VBlocks [N, block_size, ...] + K/V [B, T, ...] +
    BlockTable [B, M] + Lengths [B] -> OutK/OutV: both pools with the new
    rows scattered at each row's cursor through its block table (the
    paged rewrite of kv_cache_append that serving/paged.py installs).
    Inference-only, like the dense op."""
    table, lengths = ctx.input("BlockTable"), ctx.input("Lengths")
    ctx.set_output("OutK", append_paged(ctx.input("KBlocks"), ctx.input("K"),
                                        table, lengths))
    ctx.set_output("OutV", append_paged(ctx.input("VBlocks"), ctx.input("V"),
                                        table, lengths))


@register_infer_shape("kv_cache_append_paged")
def _kv_cache_append_paged_shape(op, block):
    """Outputs mirror the pool inputs (the pool's leading dim is static
    while K/V's batch is dynamic)."""
    _mirror_shapes(op, block, (("KBlocks", "OutK"), ("VBlocks", "OutV")))


# ---------------------------------------------------------------------------
# block-granular KV pool (the serving tier's shared cache storage)
# ---------------------------------------------------------------------------


class PoolExhausted(RuntimeError):
    """No free block and nothing idle to evict: the pool is genuinely at
    capacity.  The scheduler turns this into preemption (evict a live
    request's blocks and replay it later) rather than letting it surface
    to a caller."""


def _numpy_dtype(dtype):
    return np.dtype(convert_dtype(dtype))


def _host(rows, dtype):
    """Rows (numpy or a tensor on any device) as a numpy array of
    `dtype`."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    return np.asarray(rows, dtype=dtype)


class BlockPool:
    """Fixed-size-block KV storage shared by every request of a serving
    scheduler — the paged replacement for one dense `[batch, max_len]`
    buffer per `Generator`.

    Logical position ``p`` of a request lives at ``blocks[p // block_size]``
    row ``p % block_size``; a request owns a *block table* (list of block
    ids) covering positions ``[0, cursor)``.  One block id spans every
    registered stream at once (all layers' k AND v share one table), so
    allocation, refcounting and eviction are per-table, not per-layer.

    The attention contract is untouched: `gather` materialises a request's
    rows back into the dense `[max_len, ...]` layout the step programs
    feed, zero beyond the cursor — positions the SeqLen mask never reads.

    Sharing: blocks are refcounted.  `register_prefix` parks a finished
    prompt's chain under a key; `lookup_prefix` hands the chain to a new
    request with every block retained (+1), and the scheduler copy-on-
    writes the partially-filled tail block before appending to it
    (`clone_block`).  When `alloc` finds the free list empty it evicts
    idle prefix chains (held only by the registry, LRU-first) before
    giving up with PoolExhausted.

    Host-side and single-threaded: only the scheduler thread touches the
    pool, and its streams are numpy arrays (`DeviceBlockPool` keeps them
    on a torch device instead)."""

    def __init__(self, num_blocks, block_size):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._streams = {}  # name -> [num_blocks, block_size, *tail]
        # LIFO free list: recently-freed blocks are re-used first (their
        # contents are dead by contract)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._refs = np.zeros(self.num_blocks, np.int32)
        self._prefix = {}    # key -> [blocks, n_rows, aux, last_use]
        self._use_tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- streams ---------------------------------------------------------

    def add_stream(self, name, tail_shape, dtype=np.float32):
        """Register one cached tensor stream (e.g. ``cache_k_0``) with
        per-position trailing shape `tail_shape`."""
        if name in self._streams:
            raise ValueError(f"stream {name!r} already registered")
        self._streams[name] = np.zeros(
            (self.num_blocks, self.block_size) + tuple(tail_shape),
            dtype=_numpy_dtype(dtype))

    @property
    def stream_names(self):
        return sorted(self._streams)

    # -- allocation / refcounting ---------------------------------------

    def free_blocks(self):
        return len(self._free)

    def used_blocks(self):
        return self.num_blocks - len(self._free)

    def occupancy(self):
        return self.used_blocks() / self.num_blocks

    def blocks_for(self, n_positions):
        """Blocks needed to cover n_positions rows."""
        return -(-int(n_positions) // self.block_size)

    def alloc(self, n):
        """n fresh blocks (refcount 1 each).  Evicts idle prefix chains
        LRU-first when the free list runs dry; raises PoolExhausted when
        even that cannot cover the request."""
        n = int(n)
        if n > len(self._free):
            self._evict_idle(n - len(self._free))
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free of "
                f"{self.num_blocks} (no idle prefix chains left to evict)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def retain(self, blocks):
        for b in blocks:
            if self._refs[b] <= 0:
                raise ValueError(f"retain of free block {b}")
            self._refs[b] += 1

    def release(self, blocks):
        """Drop one reference per block; blocks at zero return to the
        free list (contents become dead — nothing zeroes them, the next
        owner overwrites before its cursor exposes the rows)."""
        for b in blocks:
            if self._refs[b] <= 0:
                raise ValueError(f"release of free block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    def clone_block(self, src):
        """Copy-on-write: a fresh block with every stream's rows copied
        from `src`.  The scheduler calls this before a request appends
        into a tail block it shares with the prefix cache (refcount>1)."""
        (dst,) = self.alloc(1)
        for data in self._streams.values():
            data[dst] = data[src]
        return dst

    # -- row I/O ---------------------------------------------------------

    def _index(self, jobs):
        """(block ids, offsets), int64 arrays, of every row of [(blocks,
        pos, rows)]: rows [T, ...] land at logical positions [pos,
        pos + T) of their table."""
        blks, offs = [], []
        for blocks, pos, rows in jobs:
            p = int(pos) + np.arange(len(rows))
            i = p // self.block_size
            if len(p) and i[-1] >= len(blocks):
                raise IndexError(f"position {int(p[-1])} beyond table of "
                                 f"{len(blocks)} blocks")
            blks.append(np.asarray(blocks, np.int64)[i])
            offs.append(p % self.block_size)
        return np.concatenate(blks), np.concatenate(offs)

    def write_rows(self, name, blocks, pos, rows):
        """rows [T, *tail] written at logical positions [pos, pos+T)."""
        self.write_rows_many(name, [(blocks, pos, rows)])

    def write_row(self, name, blocks, pos, row):
        self.write_rows(name, blocks, pos, row[None])

    def write_rows_many(self, name, jobs):
        """Batched write_rows: jobs is [(blocks, pos, rows [T, *tail])],
        a whole prefill group's rows for one stream."""
        self.write_rows_multi({name: jobs})

    def write_rows_multi(self, jobs_by_stream):
        """Batched write_rows across streams: {name: [(blocks, pos,
        rows)]}, one fancy-indexed store per stream."""
        for name, jobs in jobs_by_stream.items():
            if not jobs:
                continue
            data = self._streams[name]
            blks, offs = self._index(jobs)
            data[blks, offs] = np.concatenate(
                [_host(r, data.dtype) for _, _, r in jobs])

    # -- handoff payloads ------------------------------------------------

    def export_rows(self, blocks, n_rows):
        """{stream name: host rows [n_rows, *tail]} for one request's
        chain: logical rows, not raw blocks, so an importer re-blocks them
        under its own allocator."""
        return {name: self.gather(name, blocks, n_rows, n_rows)
                for name in self._streams}

    def adopt_rows(self, payload, n_rows):
        """Inverse of export_rows: allocate a fresh chain covering n_rows
        and land every stream's payload rows into it.  Returns the new
        block table; raises PoolExhausted like alloc."""
        blocks = self.alloc(self.blocks_for(n_rows))
        try:
            self.write_rows_multi(
                {name: [(blocks, 0, rows)]
                 for name, rows in payload.items()})
        except Exception:
            self.release(blocks)
            raise
        return blocks

    def gather(self, name, blocks, length, pad_to):
        """Dense host [pad_to, *tail] view: rows [0, length) from the
        chain, zeros beyond (masked positions — never read by
        attention)."""
        data = self._streams[name]
        out = np.zeros((int(pad_to),) + data.shape[2:], data.dtype)
        length = min(int(length), int(pad_to))
        nb = self.blocks_for(length)
        if nb:
            flat = data[np.asarray(blocks[:nb], np.int64)].reshape(
                (nb * self.block_size,) + data.shape[2:])
            out[:length] = flat[:length]
        return out

    # -- prefix cache ----------------------------------------------------

    def register_prefix(self, key, blocks, n_rows, aux=None):
        """Park a prompt's chain for reuse.  The registry holds +1 on
        every block, so the chain survives its request; an existing entry
        under the key is left in place (first writer wins — both chains
        hold identical rows by determinism)."""
        if key in self._prefix:
            return False
        self.retain(blocks)
        self._use_tick += 1
        self._prefix[key] = [list(blocks), int(n_rows), aux, self._use_tick]
        return True

    def has_prefix(self, key):
        """Would lookup_prefix hit?  No retain, no hit/miss counting, no
        LRU touch."""
        return key in self._prefix

    def lookup_prefix(self, key):
        """(blocks, n_rows, aux) with every block retained for the
        caller, or None.  Counts hit/miss."""
        ent = self._prefix.get(key)
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        self._use_tick += 1
        ent[3] = self._use_tick
        self.retain(ent[0])
        return list(ent[0]), ent[1], ent[2]

    def evict_prefix(self, key):
        ent = self._prefix.pop(key, None)
        if ent is not None:
            self.release(ent[0])
            self.evictions += 1

    def _evict_idle(self, need):
        """Evict LRU prefix chains whose blocks are held ONLY by the
        registry until `need` blocks came free (an in-use chain frees
        nothing — its request still pins the refcount above 1)."""
        freed = 0
        for key, ent in sorted(self._prefix.items(),
                               key=lambda kv: kv[1][3]):
            if freed >= need:
                break
            blocks = ent[0]
            if all(self._refs[b] == 1 for b in blocks):
                freed += len(blocks)
                self.evict_prefix(key)

    def assert_quiesced(self, evict_prefix=True):
        """Leak check: after every request retired, the only live
        references should be prefix-cache chains.  With evict_prefix=True
        those are dropped first; any block still in use afterwards is a
        leaked reference — raises AssertionError naming the count.
        Returns the pool's stats dict on success."""
        if evict_prefix:
            for key in list(self._prefix):
                self.evict_prefix(key)
        leaked = self.used_blocks()
        if leaked:
            raise AssertionError(
                f"BlockPool not quiesced: {leaked} of {self.num_blocks} "
                f"blocks still referenced after "
                f"{len(self._prefix)} prefix entries remain")
        return self.stats()

    def stats(self):
        total = self.hits + self.misses
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "used_blocks": self.used_blocks(),
            "occupancy": round(self.occupancy(), 4),
            "prefix_entries": len(self._prefix),
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_evictions": self.evictions,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
        }


class DeviceBlockPool(BlockPool):
    """BlockPool whose streams are torch tensors on a device, so the
    decode step consumes blocks IN PLACE (by block table) instead of
    gathering a dense host view every step and uploading it.

    Same allocator, refcounts, prefix cache and block tables as the host
    pool — only where the rows live changes:

      * `write_rows*` upload rows (host arrays or tensors) with ONE
        batched `index_put_` per stream, in place — prefill pays this once
        per prompt; paged decode steps append inside the step program via
        kv_cache_append_paged and never call these;
      * `clone_block` copies block to block on the device;
      * `gather` copies blocks back to a host numpy view (device to host);
      * `stream`/`set_stream` hand whole pool tensors to the paged step
        runner and install the tensors its kv_cache_append_paged ops
        return (the same tensors, written in place: set_stream only
        checks that shape and dtype still match).

    The constructor takes the device; `None` means the card, and raises
    when there is none (no CPU default).  Every tensor is made and written
    under `torch.inference_mode()`, as the serving step runs."""

    def __init__(self, num_blocks, block_size, device=None):
        super().__init__(num_blocks, block_size)
        self.device = as_device(device)

    def add_stream(self, name, tail_shape, dtype=np.float32):
        if name in self._streams:
            raise ValueError(f"stream {name!r} already registered")
        with torch.inference_mode():
            self._streams[name] = torch.zeros(
                (self.num_blocks, self.block_size) + tuple(tail_shape),
                dtype=dtype_to_torch(dtype), device=self.device)

    def stream(self, name):
        """The live pool tensor of one stream."""
        return self._streams[name]

    def set_stream(self, name, arr):
        """Install a step program's updated pool tensor (the output of
        kv_cache_append_paged)."""
        cur = self._streams[name]
        if arr.shape != cur.shape or arr.dtype != cur.dtype:
            raise ValueError(
                f"stream {name!r}: expected {tuple(cur.shape)}/{cur.dtype}, "
                f"got {tuple(arr.shape)}/{arr.dtype}")
        self._streams[name] = arr

    def clone_block(self, src):
        (dst,) = self.alloc(1)
        with torch.inference_mode():
            for data in self._streams.values():
                data[dst] = data[src]
        return dst

    def write_rows_multi(self, jobs_by_stream):
        """One `index_put_` per stream for every row of every job."""
        with torch.inference_mode():
            for name, jobs in jobs_by_stream.items():
                if not jobs:
                    continue
                data = self._streams[name]
                blk, off = (torch.as_tensor(a, device=self.device)
                            for a in self._index(jobs))
                rows = torch.cat([torch.as_tensor(r).to(self.device,
                                                        data.dtype)
                                  for _, _, r in jobs])
                data.index_put_((blk, off), rows)

    def gather(self, name, blocks, length, pad_to):
        data = self._streams[name]
        length = min(int(length), int(pad_to))
        nb = self.blocks_for(length)
        out = np.zeros((int(pad_to),) + tuple(data.shape[2:]),
                       _numpy_dtype(data.dtype))
        if nb:
            idx = torch.as_tensor(blocks[:nb], dtype=torch.int64,
                                  device=self.device)
            flat = data[idx].reshape((nb * self.block_size,)
                                     + tuple(data.shape[2:]))
            out[:length] = flat[:length].cpu().numpy()
        return out
