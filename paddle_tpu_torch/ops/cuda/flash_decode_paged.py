"""Single-query decode attention over a paged KV pool: the CUDA kernel
(csrc/flash_decode_paged.cu), its wrapper and its plain PyTorch version.

Port of paddle_tpu/ops/pallas/flash_attention.py's paged decode kernel
(`_paged_decode_kernel`, entry `flash_decode_paged`).  q [B, 1, H*D],
pools k_blocks/v_blocks [N, block_size, H*D], block_table [B, M] of pool
block ids in cursor order, lengths [B] live key counts -> [B, 1, H*D].
Table entries are clipped into [0, N); keys at or past lengths[b] are
never read (so stale entries past ceil(len / block_size) cannot change
the output), and lengths[b] == 0 gives 0.

`flash_decode_paged` runs the plain version for tensors on the CPU (and
on the meta device) and launches the kernel for tensors on the card;
anything else raises.  There is no fallback from the kernel to the plain
version.  `launches` counts kernel launches: one per call, one cluster
of CTAs per (batch, head) that merges its partials on chip
(`decode_stream`), with no scratch tensor.  The table (int64 as the
Scheduler feeds it, or int32) and the lengths (int64, int32 or float32)
are read as they are, so no cast kernel runs either.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_stream import (DTYPES, HEAD_DIMS, LENGTH_KINDS, TABLE_KINDS,
                            TILE, cluster_ranks, stream_handle,
                            table_slots)

_BLOCK_MULTIPLE = 16   # the Pallas kernel's sublane tile (_DECODE_ROWS)

launches = 0
_FN = None


def paged_decode_supported(q, k_blocks, num_heads):
    """The JAX package's gate for this tier (flash_attention.py:777):
    q [B, 1, H*D], pool [N, block_size, H*D] with block_size a multiple
    of 16 and head_dim a multiple of 64, float32 or bfloat16."""
    if len(q.shape) != 3 or len(k_blocks.shape) != 3:
        return False
    if q.dtype not in DTYPES:
        return False
    head_dim = q.shape[-1] // num_heads
    if head_dim * num_heads != q.shape[-1] or head_dim % 64 != 0:
        return False
    if k_blocks.shape[1] % _BLOCK_MULTIPLE != 0:
        return False
    return q.shape[1] == 1


def _resolve_scale(hd, num_heads, scale):
    return scale if scale else 1.0 / ((hd // num_heads) ** 0.5)


def flash_decode_paged_reference(q, k_blocks, v_blocks, block_table,
                                 lengths, num_heads, scale=0.0):
    """The plain PyTorch version: gather each row's table (clipped into
    [0, N)) to a dense [B, M * block_size, H*D] view, then a masked
    softmax over the live keys, 0 where none is live."""
    b, _, hd = q.shape
    n, bs, _ = k_blocks.shape
    m = block_table.shape[1]
    h = num_heads
    d = hd // h
    scale = _resolve_scale(hd, h, scale)
    tab = block_table.to(device=q.device, dtype=torch.int64).clamp(0, n - 1)
    k = k_blocks[tab.reshape(-1)].reshape(b, m * bs, h, d).transpose(1, 2)
    v = v_blocks[tab.reshape(-1)].reshape(b, m * bs, h, d).transpose(1, 2)
    qh = (q * scale).reshape(b, 1, h, d).transpose(1, 2).float()
    s = torch.matmul(qh, k.float().transpose(-1, -2))       # [B, H, 1, M*bs]
    kl = lengths.reshape(b).to(q.device).float().to(torch.int32)
    live = (torch.arange(m * bs, device=q.device)
            < kl[:, None, None, None]).expand(s.shape)
    s = torch.where(live, s, -1e30)
    p = torch.where(live, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())    # [B, H, 1, D]
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return (acc * inv).to(q.dtype).transpose(1, 2).reshape(b, 1, hd)


def _lib():
    global _FN
    if _FN is None:
        fn = _build.load("flash_decode_paged").flash_decode_paged_fwd
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(q, k_blocks, v_blocks, block_table, lengths, num_heads, scale):
    global launches
    dev = q.device
    if (k_blocks.device != dev or v_blocks.device != dev
            or block_table.device != dev or lengths.device != dev):
        raise ValueError("flash_decode_paged: q, the pools, the table and "
                         "the lengths must be on one device")
    if (q.dtype not in DTYPES or k_blocks.dtype != q.dtype
            or v_blocks.dtype != q.dtype):
        raise ValueError(f"flash_decode_paged: dtypes {q.dtype}/"
                         f"{k_blocks.dtype}/{v_blocks.dtype}; the kernel "
                         "takes float32 or bfloat16, all alike")
    tab_kind = TABLE_KINDS.get(block_table.dtype)
    len_kind = LENGTH_KINDS.get(lengths.dtype)
    if tab_kind is None or len_kind is None:
        raise ValueError(f"flash_decode_paged: table {block_table.dtype}, "
                         f"lengths {lengths.dtype}; the kernel reads tables "
                         f"of {list(TABLE_KINDS)} and lengths of "
                         f"{list(LENGTH_KINDS)}")
    if (q.dim() != 3 or q.shape[1] != 1 or k_blocks.dim() != 3
            or v_blocks.shape != k_blocks.shape or block_table.dim() != 2):
        raise ValueError(f"flash_decode_paged: shapes {tuple(q.shape)}, "
                         f"{tuple(k_blocks.shape)}, {tuple(v_blocks.shape)},"
                         f" table {tuple(block_table.shape)}")
    b, _, hd = q.shape
    n, bs, _ = k_blocks.shape
    m = block_table.shape[1]
    if (k_blocks.shape[2] != hd or hd % num_heads or block_table.shape[0] != b
            or lengths.numel() != b or m < 1 or bs % TILE):
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)}, pool "
                         f"{tuple(k_blocks.shape)}, table "
                         f"{tuple(block_table.shape)} and {lengths.numel()} "
                         f"lengths disagree for {num_heads} heads (or the "
                         f"block size is not a multiple of {TILE})")
    d = hd // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode_paged: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k_blocks, v_blocks)):
        raise ValueError("flash_decode_paged: the last dim of q and the "
                         "pools must be contiguous")
    kl = lengths.reshape(b)
    ranks = cluster_ranks(m * bs)
    out = torch.empty((b, 1, hd), dtype=q.dtype, device=dev)
    rc = _lib()(
        q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(),
        out.data_ptr(), block_table.data_ptr(), tab_kind, kl.data_ptr(),
        len_kind, b, n, bs, m, num_heads, d, ranks,
        table_slots(m * bs, ranks), q.stride(0), k_blocks.stride(0),
        k_blocks.stride(1), v_blocks.stride(0), v_blocks.stride(1),
        block_table.stride(0), block_table.stride(1), kl.stride(0),
        float(_resolve_scale(hd, num_heads, scale)), DTYPES[q.dtype],
        stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def flash_decode_paged(q, k_blocks, v_blocks, block_table, lengths,
                       num_heads, scale=0.0):
    """q [B,1,H*D] against pools [N,bs,H*D] through block_table [B,M] ->
    [B,1,H*D]: the kernel for tensors on the card, the plain version for
    tensors on the CPU or meta device.  Inference only (no gradient)."""
    if q.device.type in ("cpu", "meta"):
        return flash_decode_paged_reference(q, k_blocks, v_blocks,
                                            block_table, lengths, num_heads,
                                            scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged: no kernel for device "
                         f"{q.device}")
    return _launch(q, k_blocks, v_blocks, block_table, lengths, num_heads,
                   scale)
