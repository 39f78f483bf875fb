"""The launch plan shared by kernels #6 (flash_decode) and #7
(flash_decode_paged), both built on csrc/decode_stream.cuh.

Each (batch, head) row runs on one thread-block cluster of `ranks` CTAs.
The key axis is cut into TILE-row tiles (a page of the Scheduler's
16-row pool; a page of bs rows is bs / TILE tiles), and tile t goes to
rank t % ranks.  Only tiles below the row's length are copied.  Rank 0
merges the ranks' online-softmax partials in rank order, so a row's
output depends on its own inputs and on `ranks`, which depends on the
reach alone (never on the batch).

`rank_tiles` is the kernel's assignment written out in Python, for the
tests; `cluster_ranks` and `table_slots` size the launch, and
`stream_handle` gives it the stream.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 16        # rows of a tile (csrc/decode_stream.cuh: kTile)
CLUSTER = 8      # ranks a cluster at full reach (portable cluster size)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 192, 256)
LENGTH_KINDS = {torch.float32: 0, torch.int64: 1, torch.int32: 2}
TABLE_KINDS = {torch.int32: 0, torch.int64: 1}


def stream_handle(device):
    """The raw handle of the current CUDA stream of `device`, as a launch
    takes it.  torch's raw getter costs ~0.2 us a call against ~7 us for
    `torch.cuda.current_stream(device).cuda_stream` (H100 host, measured
    by paddle_tpu_torch/tools/decode_trace.py); the public call stands in
    where a torch build lacks it."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def cluster_ranks(reach):
    """CTAs a cluster for rows of `reach` keys: CLUSTER, or the least
    power of two that covers a reach of fewer tiles."""
    tiles = -(-reach // TILE)
    ranks = 1
    while ranks < min(CLUSTER, tiles):
        ranks *= 2
    return ranks


def table_slots(reach, ranks):
    """The most tiles one rank can hold: the block ids #7 keeps in shared
    memory."""
    tiles = -(-reach // TILE)
    return -(-tiles // ranks)


def live_keys(length, reach):
    """The keys a row attends: its length as float32, then int32 (the
    Pallas kernels' astype chain), clamped into [0, reach]."""
    return min(reach, max(0, int(np.float32(length))))


def rank_tiles(length, reach, ranks):
    """The tiles each rank copies, in the order it streams them: rank r
    takes tiles r, r + ranks, ... below ceil(live / TILE)."""
    n_tiles = -(-live_keys(length, reach) // TILE)
    return [list(range(r, n_tiles, ranks)) for r in range(ranks)]
