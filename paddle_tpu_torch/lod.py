"""Ragged-sequence utilities: the host side of LoD (paddle_tpu/lod.py,
copied: numpy only, so that the two packages pack and unpack a batch
alike).

The reference attaches ragged structure to tensors at runtime (LoDTensor:
offset vectors riding along with the data).  Here it is split in two:

  * on the host (this module): nested lists <-> dense padded [B, T, ...]
    batches plus an int32 `lengths [B]` array; bucketing instances by
    length so that padding waste stays low while the number of distinct
    shapes (each a captured graph on the card) stays small; packing many
    short sequences into long rows.
  * on the device (ops/sequence_ops.py): every `sequence_*` op takes the
    dense batch plus the lengths and masks internally.

LoD offset vectors convert losslessly: `lod = [0, 2, 5, 9]` <->
`lengths = [2, 3, 4]`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pack_batch",
    "unpack_batch",
    "lod_to_lengths",
    "lengths_to_lod",
    "bucket_by_length",
    "pack_into_rows",
    "sequence_mask_np",
]


def lod_to_lengths(lod):
    """Level-0 LoD offsets -> lengths (lod_tensor.h:58 offset convention)."""
    lod = np.asarray(lod, dtype=np.int64)
    return (lod[1:] - lod[:-1]).astype(np.int32)


def lengths_to_lod(lengths):
    """Lengths -> level-0 LoD offsets."""
    lengths = np.asarray(lengths, dtype=np.int64)
    out = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def pack_batch(seqs, pad_value=0, max_len=None, dtype=None, time_major=False):
    """Nested lists / per-instance arrays -> (padded [B, T, ...], lengths [B]).

    `seqs` is a list of per-instance arrays, each [t_i, ...feature...].
    Longer instances are truncated to `max_len` when given.
    """
    arrs = [np.asarray(s) for s in seqs]
    if dtype is None:
        dtype = arrs[0].dtype if arrs else np.float32
    lengths = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
    t = int(max_len) if max_len is not None else (int(lengths.max()) if len(arrs) else 0)
    lengths = np.minimum(lengths, t).astype(np.int32)
    feature = arrs[0].shape[1:] if arrs else ()
    out = np.full((len(arrs), t) + feature, pad_value, dtype=dtype)
    for i, a in enumerate(arrs):
        n = min(a.shape[0], t)
        out[i, :n] = a[:n]
    if time_major:
        out = np.swapaxes(out, 0, 1)
    return out, lengths


def unpack_batch(padded, lengths, time_major=False):
    """(padded, lengths) -> list of per-instance arrays (inverse of pack)."""
    if time_major:
        padded = np.swapaxes(padded, 0, 1)
    return [np.asarray(padded[i, : int(n)]) for i, n in enumerate(lengths)]


def sequence_mask_np(lengths, max_len=None, dtype=np.float32):
    lengths = np.asarray(lengths)
    t = int(max_len) if max_len is not None else int(lengths.max())
    return (np.arange(t)[None, :] < lengths[:, None]).astype(dtype)


def bucket_by_length(reader, bucket_boundaries, batch_size, len_fn=None,
                     pad_value=0, drop_last=False, seq_cols=None):
    """Reader decorator: group instances into length buckets, emit packed
    batches per bucket.

    Each emitted batch is `(padded, lengths)` when instances are single
    sequences, or — for tuple instances like (tokens, label) — a tuple
    whose sequence columns (`seq_cols`, default: all) become
    `(padded, lengths)` pairs padded to the bucket boundary and whose other
    columns are plain `np.stack`s.  The executor sees at most
    `len(bucket_boundaries)+1` distinct shapes — the recompile-count /
    padding-waste tradeoff the reference solves with runtime LoD.

    len_fn(instance) -> int chooses the bucketing key (default: len of the
    first / only sequence).
    """
    boundaries = sorted(int(b) for b in bucket_boundaries)
    seq_col_set = None if seq_cols is None else set(seq_cols)

    def _len(ins):
        if len_fn is not None:
            return len_fn(ins)
        if isinstance(ins, (tuple, list)) and not np.isscalar(ins[0]):
            return max(len(x) for x in ins)
        return len(ins)

    def _bucket_of(n):
        for i, b in enumerate(boundaries):
            if n <= b:
                return i
        return len(boundaries)

    def _emit(items, cap):
        first = items[0]
        if isinstance(first, (tuple, list)) and not np.isscalar(first[0]):
            cols = list(zip(*items))
            out = []
            for ci, c in enumerate(cols):
                if seq_col_set is None or ci in seq_col_set:
                    out.append(pack_batch(c, pad_value=pad_value, max_len=cap))
                else:
                    out.append(np.stack([np.asarray(x) for x in c]))
            return tuple(out)
        return pack_batch(items, pad_value=pad_value, max_len=cap)

    def batched_reader():
        buckets = [[] for _ in range(len(boundaries) + 1)]
        for ins in reader():
            i = _bucket_of(_len(ins))
            buckets[i].append(ins)
            if len(buckets[i]) == batch_size:
                cap = boundaries[i] if i < len(boundaries) else None
                yield _emit(buckets[i], cap)
                buckets[i] = []
        if not drop_last:
            for i, items in enumerate(buckets):
                if items:
                    cap = boundaries[i] if i < len(boundaries) else None
                    yield _emit(items, cap)

    return batched_reader


def pack_into_rows(seqs, row_len, pad_value=0, eos=None):
    """Sequence packing: greedily concatenate short sequences into fixed
    [N, row_len] rows, returning (tokens, segment_ids, positions).

    The transformer-pretraining alternative to bucketing: zero padding
    waste, one compiled shape.  `segment_ids` (1-based, 0 = pad) let
    attention ops mask cross-sequence pairs; `positions` restart at 0 per
    sequence for position encodings.
    """
    rows, segs, poss = [], [], []
    cur, cur_seg, cur_pos = [], [], []
    seg = 1
    for s in seqs:
        s = list(s)
        if eos is not None:
            s = s + [eos]
        if len(s) > row_len:
            s = s[:row_len]
        if len(cur) + len(s) > row_len:
            pad = row_len - len(cur)
            rows.append(cur + [pad_value] * pad)
            segs.append(cur_seg + [0] * pad)
            poss.append(cur_pos + [0] * pad)
            cur, cur_seg, cur_pos, seg = [], [], [], 1
        cur += s
        cur_seg += [seg] * len(s)
        cur_pos += list(range(len(s)))
        seg += 1
    if cur:
        pad = row_len - len(cur)
        rows.append(cur + [pad_value] * pad)
        segs.append(cur_seg + [0] * pad)
        poss.append(cur_pos + [0] * pad)
    mk = lambda x, dt: np.asarray(x, dtype=dt)
    return mk(rows, np.int64), mk(segs, np.int32), mk(poss, np.int32)
