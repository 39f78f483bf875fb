"""Exact multi-head attention: the CUDA kernels (csrc/mha_block.cu and
csrc/mha_block_bwd.cu), their wrappers and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/mha_block.py: `_mha_fwd_kernel` (entry
`mha_attention`) and `_mha_bwd_kernel` (entry `mha_block_bwd`, the
backward of `_mha_bwd_rule`).  q [B, Sq, H*D], k/v [B, Sk, H*D] ->
[B, Sq, H*D]; optional key_len [B] masks keys at positions >= key_len[b];
causal uses the (Sk - Sq) diagonal offset.  Masked scores are the finite
-1e30, so a row whose keys are all masked is the uniform mean of V.  The
backward's residuals are the inputs alone (P is recomputed), and key_len
has no gradient.  `MHABlockFunction` joins the two as one autograd op.

The entries run the plain versions for tensors on the CPU (and on the
meta device, for shape inference) and launch the kernels for tensors on
the card; anything else raises.  The forward takes one of three kernels
(csrc/mha_block.cu): in bfloat16 a tensor-core kernel (the mha_block mode
of csrc/flash_fwd_mma.cuh, shared with the flash forward: the row lse
first, then the normalised P rounded to bfloat16 before P V), in float32
a SIMT kernel, and for a single query (Sq == 1, mha_decode) with at most
`DECODE_MAX_KEYS` keys a decode kernel in either dtype.  In bfloat16 the
backward runs three tensor-core kernels (row statistics, dQ, dK/dV;
csrc/flash_bwd_mma.cuh, shared with the flash backward).  Every bfloat16
kernel needs 16-byte aligned rows: a misaligned view raises.  There is
no fallback from a kernel to a plain version.  `launches` and
`bwd_launches` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ... import flags
from . import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 192, 256)
# the longest key axis the forward's single-query body takes (its float32
# scores sit in shared memory); csrc/mha_block.cu's kDecodeMaxKeys
DECODE_MAX_KEYS = 16384

launches = 0
bwd_launches = 0


def _head_chunk(num_heads, sq, sk):
    """Largest divisor hc of num_heads whose [hc, Sq, Sk] f32 score tile
    fits attn_vmem_score_budget, or None.  This is the JAX kernel's TPU
    VMEM budget; the CUDA kernel streams keys and needs no such tile, but
    the gate keeps it so both packages send the same shapes to this tier."""
    budget = flags.get("attn_vmem_score_budget")
    if sq * sk * 4 > budget:
        return None
    for hc in range(num_heads, 0, -1):
        if num_heads % hc == 0 and hc * sq * sk * 4 <= budget:
            return hc
    return None


def supported(q, k, num_heads, causal=False):
    """The JAX package's gate for this tier (mha_block.py:61), on
    anything with .shape and .dtype."""
    if len(q.shape) != 3 or len(k.shape) != 3:
        return False
    if q.dtype not in _DTYPES:
        return False
    hd = q.shape[-1]
    d = hd // num_heads
    if d * num_heads != hd or d % 64 != 0:
        return False
    sq, sk = q.shape[1], k.shape[1]
    if sq % 8 != 0 or sk % 128 != 0:
        return False
    if causal and sq > sk:
        return False
    return _head_chunk(num_heads, sq, sk) is not None


def _resolve_scale(hd, num_heads, scale):
    return scale if scale else 1.0 / ((hd // num_heads) ** 0.5)


def mha_reference(q, k, v, num_heads, causal=False, scale=0.0, key_len=None):
    """The plain PyTorch version: a straightforward masked softmax
    attention with the kernel's semantics."""
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
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        s = torch.where(cols[None, :] <= rows, s, _NEG_INF)
    if key_len is not None:
        kl = key_len.reshape(b).float().to(torch.int32)
        s = torch.where(cols < kl[:, None, None, None], s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vh.float())    # [B, H, Sq, D]
    return o.to(q.dtype).transpose(1, 2).reshape(b, sq, hd)


def mha_block_bwd_reference(q, k, v, dout, num_heads, causal=False,
                            scale=0.0, key_len=None):
    """The backward's plain PyTorch version, in float32 over [B, H, Sq, Sk]:
    P recomputed under the forward's masks, dP = dO V^T, delta =
    rowsum(P o dP), dS = P o (dP - delta), dQ = scale dS K,
    dK = dS^T (scale q), dV = P^T dO.  dS is not masked afterwards (as in
    the Pallas kernel), so an all-masked row passes a gradient to every
    key.  Returns (dq, dk, dv) in the inputs' dtype and layout."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    h = num_heads
    d = hd // h
    scale = _resolve_scale(hd, h, scale)

    def heads(x, s):
        return x.reshape(b, s, h, d).transpose(1, 2).float()

    qh = heads(q * scale, sq)          # scaled in q's own dtype
    kh, vh, doh = heads(k, sk), heads(v, sk), heads(dout.to(q.dtype), sq)
    s = torch.matmul(qh, kh.transpose(-1, -2))             # [B, H, Sq, Sk]
    cols = torch.arange(sk, device=q.device)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        s = torch.where(cols[None, :] <= rows, s, _NEG_INF)
    if key_len is not None:
        kl = key_len.reshape(b).float().to(torch.int32)
        s = torch.where(cols < kl[:, None, None, None], s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.transpose(-1, -2), doh)

    def back(x, like):
        return x.transpose(1, 2).reshape(like.shape).to(like.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


def _lib():
    lib = _build.load("mha_block")
    fn = lib.mha_block_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("mha_block_bwd")
    fn = lib.mha_block_bwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, num_heads, causal, key_len, extra=()):
    """Checks shared by both kernels; returns (d, key lengths as float32
    on the card or None)."""
    if any(t.device != q.device for t in (k, v, *extra)):
        raise ValueError("mha_block: q, k, v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mha_block: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernel takes float32 or bfloat16, all alike")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"mha_block: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hd = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != hd or hd % num_heads:
        raise ValueError(f"mha_block: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree for {num_heads} heads")
    d = hd // num_heads
    if d not in _HEAD_DIMS:
        raise ValueError(f"mha_block: head_dim {d} not in {_HEAD_DIMS}")
    if sq < 1 or sk < 1 or (causal and sq > sk):
        raise ValueError(f"mha_block: Sq={sq}, Sk={sk}, causal={causal}")
    if any(t.stride(-1) != 1 for t in (q, k, v, *extra)):
        raise ValueError("mha_block: the last dim of q, k, v and dO must "
                         "be contiguous")
    kl = None
    if key_len is not None:
        if key_len.numel() != b:
            raise ValueError(f"mha_block: key_len has {key_len.numel()} "
                             f"entries for batch {b}")
        kl = key_len.reshape(b).to(device=q.device,
                                   dtype=torch.float32).contiguous()
    return d, kl


def _launch(q, k, v, num_heads, causal, scale, key_len):
    global launches
    d, kl = _check(q, k, v, num_heads, causal, key_len)
    b, sq, hd = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kl.data_ptr() if kl is not None else None,
        b, sq, sk, num_heads, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        float(_resolve_scale(hd, num_heads, scale)), int(bool(causal)),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mha_block kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def _launch_bwd(q, k, v, dout, num_heads, causal, scale, key_len):
    global bwd_launches
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"mha_block_bwd: dO {tuple(dout.shape)} "
                         f"{dout.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    d, kl = _check(q, k, v, num_heads, causal, key_len, extra=(dout,))
    b, sq, hd = q.shape
    sk = k.shape[1]
    dq = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, hd), dtype=q.dtype, device=q.device)
    # per-row statistics for the later kernels: m, 1/l and delta from the
    # float32 dq kernel, or lse and delta from the bf16 stats kernel
    planes = 3 if q.dtype == torch.float32 else 2
    stats = torch.empty((planes, b, num_heads, sq), dtype=torch.float32,
                        device=q.device)
    rc = _bwd_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        kl.data_ptr() if kl is not None else None,
        b, sq, sk, num_heads, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
        float(_resolve_scale(hd, num_heads, scale)), int(bool(causal)),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mha_block_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dq, dk, dv


def _forward(q, k, v, num_heads, causal, scale, key_len):
    if q.device.type in ("cpu", "meta"):
        return mha_reference(q, k, v, num_heads, causal, scale, key_len)
    if q.device.type != "cuda":
        raise ValueError(f"mha_block: no kernel for device {q.device}")
    return _launch(q, k, v, num_heads, causal, scale, key_len)


def mha_block_bwd(q, k, v, dout, num_heads, causal=False, scale=0.0,
                  key_len=None):
    """(dq, dk, dv) of mha_attention at q, k, v for the output grad dout:
    the backward kernel for tensors on the card, the plain version for
    tensors on the CPU or meta device.  No forward kernel runs."""
    if q.device.type in ("cpu", "meta"):
        return mha_block_bwd_reference(q, k, v, dout, num_heads, causal,
                                       scale, key_len)
    if q.device.type != "cuda":
        raise ValueError(f"mha_block_bwd: no kernel for device {q.device}")
    return _launch_bwd(q, k, v, dout, num_heads, causal, scale, key_len)


class MHABlockFunction(torch.autograd.Function):
    """mha_attention as one autograd op: the forward kernel forward, the
    backward kernel backward, with q, k, v (and key_len) as the only
    residuals."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal, scale, key_len):
        ctx.save_for_backward(q, k, v, key_len)
        ctx.cfg = (num_heads, causal, scale)
        return _forward(q, k, v, num_heads, causal, scale, key_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_len = ctx.saved_tensors
        num_heads, causal, scale = ctx.cfg
        dq, dk, dv = mha_block_bwd(q, k, v, g.contiguous(), num_heads,
                                   causal, scale, key_len)
        return dq, dk, dv, None, None, None, None


def mha_attention(q, k, v, num_heads, causal=False, scale=0.0, key_len=None):
    """q [B,Sq,H*D], k/v [B,Sk,H*D] -> [B,Sq,H*D]: the kernel for tensors on
    the card, the plain version for tensors on the CPU or meta device.
    Under autograd it is `MHABlockFunction`, whose backward is
    `mha_block_bwd`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return MHABlockFunction.apply(q, k, v, num_heads, causal, scale,
                                      key_len)
    return _forward(q, k, v, num_heads, causal, scale, key_len)
