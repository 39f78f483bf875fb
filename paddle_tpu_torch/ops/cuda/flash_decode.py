"""Single-query decode attention over a dense KV cache: the CUDA kernel
(csrc/flash_decode.cu), its wrapper and its plain PyTorch version.

Port of the decode part of paddle_tpu/ops/pallas/flash_attention.py
(`_decode_kernel`, entry `flash_decode`).  q [B, 1, H*D], k/v
[B, Sk, H*D] -> [B, 1, H*D]; kv_len [B] bounds the live keys.  Keys at or
past kv_len are never read, and kv_len == 0 gives 0 (not the mean of V:
that is mha_block's masked-row semantics).  kv_len may be float32, int64
or int32; the kernel reads it as it is (float32, then int32).

`flash_decode` runs the plain version for tensors on the CPU (and on the
meta device) and launches the kernel for tensors on the card; anything
else raises.  `launches` counts kernel launches: one per call, one
cluster of CTAs per (batch, head) that merges its partials on chip
(`decode_stream`), with no scratch tensor and no cast kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_stream import (DTYPES, HEAD_DIMS, LENGTH_KINDS,
                            cluster_ranks, stream_handle)

launches = 0
_FN = None


def decode_supported(q, k, num_heads):
    """The JAX package's gate for this tier (flash_attention.py:617):
    [B, 1, H*D] single-query form, head_dim a multiple of 64, any Sk."""
    if len(q.shape) != 3 or len(k.shape) != 3:
        return False
    if q.dtype not in DTYPES:
        return False
    head_dim = q.shape[-1] // num_heads
    if head_dim * num_heads != q.shape[-1] or head_dim % 64 != 0:
        return False
    return q.shape[1] == 1


def _resolve_scale(hd, num_heads, scale):
    return scale if scale else 1.0 / ((hd // num_heads) ** 0.5)


def flash_decode_reference(q, k, v, num_heads, scale=0.0, kv_len=None):
    """The plain PyTorch version: masked softmax over the live keys,
    0 where none is live."""
    b, _, hd = q.shape
    sk = k.shape[1]
    h = num_heads
    d = hd // h
    scale = _resolve_scale(hd, h, scale)
    qh = (q * scale).reshape(b, 1, h, d).transpose(1, 2).float()
    kh = k.reshape(b, sk, h, d).transpose(1, 2).float()
    vh = v.reshape(b, sk, h, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2))             # [B, H, 1, Sk]
    cols = torch.arange(sk, device=q.device)
    if kv_len is None:
        live = torch.ones_like(s, dtype=torch.bool)
    else:
        kl = kv_len.reshape(b).float().to(torch.int32)
        live = (cols < kl[:, None, None, None]).expand(s.shape)
    s = torch.where(live, s, -1e30)
    p = torch.where(live, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())  # [B, H, 1, D]
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return (acc * inv).to(q.dtype).transpose(1, 2).reshape(b, 1, hd)


def _lib():
    global _FN
    if _FN is None:
        fn = _build.load("flash_decode").flash_decode_fwd
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(q, k, v, num_heads, scale, kv_len):
    global launches
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_decode: q, k, v must be on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16, "
                         "all alike")
    if q.dim() != 3 or q.shape[1] != 1 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_decode: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hd = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != hd or hd % num_heads or sk < 1:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree for {num_heads} heads")
    d = hd // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_decode: the last dim of q, k, v must be "
                         "contiguous")
    kl, kind, kl_s = None, 0, 0
    if kv_len is not None:
        if kv_len.numel() != b or kv_len.device != q.device:
            raise ValueError(f"flash_decode: kv_len {tuple(kv_len.shape)} "
                             f"on {kv_len.device} for batch {b} on "
                             f"{q.device}")
        kind = LENGTH_KINDS.get(kv_len.dtype)
        if kind is None:
            raise ValueError(f"flash_decode: kv_len dtype {kv_len.dtype}; "
                             f"the kernel reads {list(LENGTH_KINDS)}")
        kl = kv_len.reshape(b)
        kl_s = kl.stride(0)
    out = torch.empty((b, 1, hd), dtype=q.dtype, device=q.device)
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kl is None else kl.data_ptr(), kind,
        b, sk, num_heads, d, cluster_ranks(sk),
        q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        kl_s, float(_resolve_scale(hd, num_heads, scale)), DTYPES[q.dtype],
        stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out


def flash_decode(q, k, v, num_heads, scale=0.0, kv_len=None):
    """q [B,1,H*D], k/v [B,Sk,H*D] -> [B,1,H*D]: the kernel for tensors on
    the card, the plain version for tensors on the CPU or meta device."""
    if q.device.type in ("cpu", "meta"):
        return flash_decode_reference(q, k, v, num_heads, scale, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    return _launch(q, k, v, num_heads, scale, kv_len)
