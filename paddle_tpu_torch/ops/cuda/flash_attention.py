"""Streaming (flash) attention, forward with the row logsumexp and its
backward: the CUDA kernels (csrc/flash_attention_fwd.cu,
csrc/flash_attention_bwd.cu), their wrappers and their plain PyTorch
versions.

Port of paddle_tpu/ops/pallas/flash_attention.py: `_fwd_kernel` (entries
`flash_attention` and `flash_attention_lse`), and the backward rule
`_flash_bwd_rule` with its two kernels `_bwd_dq_kernel` (entry
`flash_attention_bwd_dq`) and `_bwd_dkv_kernel` (entry
`flash_attention_bwd_dkv`), joined by `flash_attention_bwd`.
q [B, Sq, H*D], k/v [B, Sk, H*D] -> out [B, Sq, H*D] and lse [B, H, Sq]
(float32).  Causal masking uses the (Sk - Sq) diagonal offset and is
refused for Sq > Sk; keys at or past kv_len[b] are masked, with kv_len
clamped to Sk (the JAX kernel counts its zero block padding as live when
kv_len > Sk, ROADMAP.md C6).  A row with no live key gives out = 0 and
lse = -1e30 (the JAX module docstring, :41-46), not the mean of V that
mha_block gives, and gets dq = dk = dv = 0.

The backward takes the forward's residuals (q, k, v, out, lse) and the
cotangents of out and of lse: g_lse folds into delta = rowsum(dO o O) -
g_lse (flash_attention.py:416-424), computed here with torch ops as the
JAX package computes it outside its kernels.  `FlashAttentionFunction`
makes (out, lse) one autograd op whose outputs are both differentiable.

The entries run the plain versions for tensors on the CPU (and on the meta
device) and launch the kernels for tensors on the card; anything else
raises.  There is no fallback from a kernel to a plain version.  In
bfloat16 all three run on the tensor cores and need 16-byte aligned rows
(a misaligned view raises); in float32 they are SIMT.  `launches`,
`bwd_dq_launches` and `bwd_dkv_launches` count kernel launches (#3, #4
and #5).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 192, 256)

launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0


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


def _live_mask(b, sq, sk, causal, kv_len, device):
    """[B or 1, 1, Sq, Sk] bool: keys below kv_len (clamped to Sk) and,
    under causal, at or left of the (Sk - Sq)-offset diagonal."""
    cols = torch.arange(sk, device=device)
    live = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    if causal:
        rows = torch.arange(sq, device=device)[:, None] + (sk - sq)
        live = live & (cols[None, :] <= rows)
    if kv_len is not None:
        kl = kv_len.reshape(b).to(device).float().to(torch.int32)
        live = live & (cols < kl[:, None, None, None])
    return live


def _heads(x, s, num_heads):
    b, _, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2).float()


def flash_attention_fwd_reference(q, k, v, num_heads, causal=False,
                                  scale=0.0, kv_len=None):
    """The plain PyTorch version: (out, lse) of a masked softmax over the
    live keys, float32 scores, P rounded to V's dtype before P V; a row
    with no live key gives out = 0 and lse = -1e30."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    h = num_heads
    scale = _resolve_scale(hd, h, scale)
    qh = _heads(q * scale, sq, h)
    kh = _heads(k, sk, h)
    vh = v.reshape(b, sk, h, hd // h).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2))             # [B, H, Sq, Sk]
    live = _live_mask(b, sq, sk, causal, kv_len, q.device).expand(s.shape)
    s = torch.where(live, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())  # [B, H, Sq, D]
    out = acc * torch.where(l > 0, 1.0 / l, 0.0)
    lse = torch.where(l > 0, m + torch.log(l), _NEG_INF)[..., 0]
    return out.to(q.dtype).transpose(1, 2).reshape(b, sq, hd), lse


def bwd_delta(out, dout, num_heads, g_lse=None):
    """delta [B, H, Sq] float32 = rowsum(dO o O) per head, minus the lse
    cotangent g_lse when there is one (flash_attention.py:419-422)."""
    b, sq, hd = out.shape
    delta = (dout.float() * out.float()).reshape(
        b, sq, num_heads, hd // num_heads).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def bwd_reference(q, k, v, dout, lse, delta, num_heads, causal, scale,
                  kv_len):
    """The plain version of kernels #4 and #5, from lse and delta, in
    float32 over [B, H, Sq, Sk]: P = exp(S - lse) on live pairs, dP = dO V^T,
    dS = P o (dP - delta), dQ = scale dS K, dK = dS^T (scale q),
    dV = P^T dO, with dS and P rounded to the inputs' dtype before the
    products, as the Pallas bodies round them.  Returns (dq, dk, dv) in
    the inputs' dtype and layout."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    h = num_heads
    scale = _resolve_scale(hd, h, scale)
    qh = _heads(q * scale, sq, h)          # scaled in q's own dtype
    kh, vh, doh = _heads(k, sk, h), _heads(v, sk, h), _heads(dout, sq, h)
    s = torch.matmul(qh, kh.transpose(-1, -2))             # [B, H, Sq, Sk]
    live = _live_mask(b, sq, sk, causal, kv_len, q.device)
    p = torch.where(live, torch.exp(s - lse.float()[..., None]), 0.0)
    del s
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds.to(k.dtype).float(), kh) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qh)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), doh)

    def back(x, like):
        return x.transpose(1, 2).reshape(like.shape).to(like.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


def flash_attention_bwd_reference(q, k, v, out, lse, dout, num_heads,
                                  causal=False, scale=0.0, kv_len=None,
                                  g_lse=None):
    """The backward's plain PyTorch version: (dq, dk, dv) of
    flash_attention_lse at q, k, v for the cotangents dout (of out) and
    g_lse (of lse, or None), from the forward's out and lse."""
    delta = bwd_delta(out, dout, num_heads, g_lse)
    return bwd_reference(q, k, v, dout, lse, delta, num_heads, causal,
                         scale, kv_len)


def _fn(lib_name, fn_name, argtypes):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)


def _check(q, k, v, num_heads, causal, kv_len, extra=()):
    """Checks shared by the three kernels; returns (head_dim, kv_len as
    float32 on the card or None)."""
    if any(t.device != q.device for t in (k, v, *extra)):
        raise ValueError("flash_attention: q, k, v (and dO) must be on one "
                         "device")
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
    if any(t.stride(-1) != 1 for t in (q, k, v, *extra)):
        raise ValueError("flash_attention: the last dim of q, k, v and dO "
                         "must be contiguous")
    kl = None
    if kv_len is not None:
        if kv_len.numel() != b:
            raise ValueError(f"flash_attention: kv_len has {kv_len.numel()} "
                             f"entries for batch {b}")
        kl = kv_len.reshape(b).to(device=q.device,
                                  dtype=torch.float32).contiguous()
    return d, kl


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _launch(q, k, v, num_heads, causal, scale, kv_len):
    global launches
    d, kl = _check(q, k, v, num_heads, causal, kv_len)
    b, sq, hd = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    fn = _fn("flash_attention_fwd", "flash_attention_fwd",
             [_P] * 6 + [_I] * 5 + [_LL] * 6 + [_F, _I, _I, _P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), kl.data_ptr() if kl is not None else None,
            b, sq, sk, num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1),
            float(_resolve_scale(hd, num_heads, scale)), int(bool(causal)),
            _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out, lse


def _bwd_args(q, k, v, dout, lse, delta, num_heads, causal, kv_len):
    """Checks of a backward launch; returns (head_dim, kv_len on the card
    or None)."""
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: dO {tuple(dout.shape)} "
                         f"{dout.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    rows = (q.shape[0], num_heads, q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != rows or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous float32 {rows} tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    return _check(q, k, v, num_heads, causal, kv_len, extra=(dout,))


_BWD_ARGTYPES = [_I] * 5 + [_LL] * 8 + [_F, _I, _I, _P]


def _launch_dq(q, k, v, dout, lse, delta, num_heads, causal, scale,
               kv_len):
    global bwd_dq_launches
    d, kl = _bwd_args(q, k, v, dout, lse, delta, num_heads, causal, kv_len)
    b, sq, hd = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    fn = _fn("flash_attention_bwd", "flash_attention_bwd_dq",
             [_P] * 8 + _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            kl.data_ptr() if kl is not None else None,
            b, sq, k.shape[1], num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
            float(_resolve_scale(hd, num_heads, scale)), int(bool(causal)),
            _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq kernel launch failed: "
                           f"CUDA error {rc}")
    bwd_dq_launches += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, num_heads, causal, scale,
                kv_len):
    global bwd_dkv_launches
    d, kl = _bwd_args(q, k, v, dout, lse, delta, num_heads, causal, kv_len)
    b, sq, hd = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, hd), dtype=v.dtype, device=v.device)
    fn = _fn("flash_attention_bwd", "flash_attention_bwd_dkv",
             [_P] * 9 + _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            kl.data_ptr() if kl is not None else None,
            b, sq, sk, num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
            float(_resolve_scale(hd, num_heads, scale)), int(bool(causal)),
            _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv kernel launch failed: "
                           f"CUDA error {rc}")
    bwd_dkv_launches += 1
    return dk, dv


def _on_host(x, what):
    """True for the CPU and meta devices (the plain versions); False for
    the card; raises for anything else."""
    if x.device.type in ("cpu", "meta"):
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return False


def _forward(q, k, v, num_heads, causal, scale, kv_len):
    if _on_host(q, "flash_attention"):
        return flash_attention_fwd_reference(q, k, v, num_heads, causal,
                                             scale, kv_len)
    return _launch(q, k, v, num_heads, causal, scale, kv_len)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, num_heads,
                           causal=False, scale=0.0, kv_len=None):
    """Kernel #4: dq from q, k, v, dO, the forward's lse and delta
    (`bwd_delta`); the plain version for tensors on the CPU or meta
    device."""
    if _on_host(q, "flash_attention_bwd_dq"):
        return bwd_reference(q, k, v, dout, lse, delta, num_heads, causal,
                             scale, kv_len)[0]
    return _launch_dq(q, k, v, dout, lse, delta, num_heads, causal, scale,
                      kv_len)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, num_heads,
                            causal=False, scale=0.0, kv_len=None):
    """Kernel #5: (dk, dv) from the same inputs as kernel #4."""
    if _on_host(q, "flash_attention_bwd_dkv"):
        return bwd_reference(q, k, v, dout, lse, delta, num_heads, causal,
                             scale, kv_len)[1:]
    return _launch_dkv(q, k, v, dout, lse, delta, num_heads, causal, scale,
                       kv_len)


def flash_attention_bwd(q, k, v, out, lse, dout, num_heads, causal=False,
                        scale=0.0, kv_len=None, g_lse=None):
    """(dq, dk, dv) of flash_attention_lse at q, k, v for the cotangents
    dout (of out) and g_lse (of lse, or None), from the forward's out and
    lse: kernels #4 and #5 for tensors on the card, the plain version for
    tensors on the CPU or meta device.  No forward kernel runs."""
    if _on_host(q, "flash_attention_bwd"):
        return flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                             num_heads, causal, scale,
                                             kv_len, g_lse)
    delta = bwd_delta(out, dout, num_heads, g_lse)
    dq = _launch_dq(q, k, v, dout, lse, delta, num_heads, causal, scale,
                    kv_len)
    dk, dv = _launch_dkv(q, k, v, dout, lse, delta, num_heads, causal,
                         scale, kv_len)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """flash_attention_lse as one autograd op: kernel #3 forward, kernels
    #4 and #5 backward, with (q, k, v, out, lse) as the residuals.  Both
    outputs are differentiable; the lse cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal, scale, kv_len):
        out, lse = _forward(q, k, v, num_heads, causal, scale, kv_len)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.cfg = (num_heads, causal, scale)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        num_heads, causal, scale = ctx.cfg
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         g_out.contiguous(), num_heads,
                                         causal, scale, kv_len, g_lse)
        return dq, dk, dv, None, None, None, None


def flash_attention_lse(q, k, v, num_heads, causal=False, scale=0.0,
                        kv_len=None):
    """(out [B,Sq,H*D], lse [B,H,Sq] float32): the kernel for tensors on
    the card, the plain version for tensors on the CPU or meta device.
    Under autograd it is `FlashAttentionFunction`, whose backward is
    `flash_attention_bwd`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, num_heads, causal,
                                            scale, kv_len)
    return _forward(q, k, v, num_heads, causal, scale, kv_len)


def flash_attention(q, k, v, num_heads, causal=False, scale=0.0,
                    kv_len=None):
    """q [B,Sq,H*D], k/v [B,Sk,H*D] -> [B,Sq,H*D] (flash_attention_lse
    without the lse)."""
    return flash_attention_lse(q, k, v, num_heads, causal, scale, kv_len)[0]
