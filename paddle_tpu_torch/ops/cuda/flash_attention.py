"""Streaming (flash) attention forward with the row logsumexp: the CUDA
kernel (csrc/flash_attention_fwd.cu), its wrapper and its plain PyTorch
version.

Port of the forward of paddle_tpu/ops/pallas/flash_attention.py
(`_fwd_kernel`, entries `flash_attention` and `flash_attention_lse`).
q [B, Sq, H*D], k/v [B, Sk, H*D] -> out [B, Sq, H*D] and lse [B, H, Sq]
(float32).  Causal masking uses the (Sk - Sq) diagonal offset and is
refused for Sq > Sk; keys at or past kv_len[b] are masked, with kv_len
clamped to Sk (the JAX kernel counts its zero block padding as live when
kv_len > Sk, ROADMAP.md C6).  A row with no live key gives out = 0 and
lse = -1e30 (the JAX module docstring, :41-46), not the mean of V that
mha_block gives.

The entries run the plain version for tensors on the CPU (and on the meta
device) and launch the kernel for tensors on the card; anything else
raises.  There is no fallback from the kernel to the plain version.  The
backward (kernels #4 and #5) is not ported: these entries take no
gradient.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 192, 256)

launches = 0


def supported(q, k, num_heads, causal=False):
    """The JAX package's gate for this tier (flash_attention.py:78), on
    anything with .shape and .dtype: any Sq and Sk, head_dim a multiple of
    64, float32 or bfloat16, and Sq <= Sk under causal."""
    if len(q.shape) != 3 or len(k.shape) != 3:
        return False
    if q.dtype not in _DTYPES:
        return False
    head_dim = q.shape[-1] // num_heads
    if head_dim * num_heads != q.shape[-1] or head_dim % 64 != 0:
        return False
    return not (causal and q.shape[1] > k.shape[1])


def _resolve_scale(hd, num_heads, scale):
    return scale if scale else 1.0 / ((hd // num_heads) ** 0.5)


def flash_attention_fwd_reference(q, k, v, num_heads, causal=False,
                                  scale=0.0, kv_len=None):
    """The plain PyTorch version: (out, lse) of a masked softmax over the
    live keys, float32 scores, P rounded to V's dtype before P V; a row
    with no live key gives out = 0 and lse = -1e30."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    h = num_heads
    d = hd // h
    scale = _resolve_scale(hd, h, scale)
    qh = (q * scale).reshape(b, sq, h, d).transpose(1, 2).float()
    kh = k.reshape(b, sk, h, d).transpose(1, 2).float()
    vh = v.reshape(b, sk, h, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2))             # [B, H, Sq, Sk]
    cols = torch.arange(sk, device=q.device)
    live = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        live = live & (cols[None, :] <= rows)
    if kv_len is not None:
        kl = kv_len.reshape(b).to(q.device).float().to(torch.int32)
        live = live & (cols < kl[:, None, None, None])
    live = live.expand(s.shape)
    s = torch.where(live, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())  # [B, H, Sq, D]
    out = acc * torch.where(l > 0, 1.0 / l, 0.0)
    lse = torch.where(l > 0, m + torch.log(l), _NEG_INF)[..., 0]
    return out.to(q.dtype).transpose(1, 2).reshape(b, sq, hd), lse


def _lib():
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, num_heads, causal, scale, kv_len):
    global launches
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k, v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16, "
                         "all alike")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hd = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != hd or hd % num_heads:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree for {num_heads} heads")
    d = hd // num_heads
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    if sq < 1 or sk < 1 or (causal and sq > sk):
        raise ValueError(f"flash_attention: Sq={sq}, Sk={sk}, "
                         f"causal={causal}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dim of q, k, v must be "
                         "contiguous")
    kl = None
    if kv_len is not None:
        if kv_len.numel() != b:
            raise ValueError(f"flash_attention: kv_len has {kv_len.numel()} "
                             f"entries for batch {b}")
        kl = kv_len.reshape(b).to(device=q.device,
                                  dtype=torch.float32).contiguous()
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), kl.data_ptr() if kl is not None else None,
        b, sq, sk, num_heads, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        float(_resolve_scale(hd, num_heads, scale)), int(bool(causal)),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out, lse


def flash_attention_lse(q, k, v, num_heads, causal=False, scale=0.0,
                        kv_len=None):
    """(out [B,Sq,H*D], lse [B,H,Sq] float32): the kernel for tensors on
    the card, the plain version for tensors on the CPU or meta device."""
    if q.device.type in ("cpu", "meta"):
        return flash_attention_fwd_reference(q, k, v, num_heads, causal,
                                             scale, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, num_heads, causal, scale, kv_len)


def flash_attention(q, k, v, num_heads, causal=False, scale=0.0,
                    kv_len=None):
    """q [B,Sq,H*D], k/v [B,Sk,H*D] -> [B,Sq,H*D] (flash_attention_lse
    without the lse)."""
    return flash_attention_lse(q, k, v, num_heads, causal, scale, kv_len)[0]
