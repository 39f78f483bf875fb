"""Ring attention: exact attention over sequence-sharded Q/K/V
(counterpart of paddle_tpu/parallel/ring_attention.py).

The sequence dim is sharded over the mesh's `sp` axis; each rank keeps
its Q block and K/V blocks rotate around the ring (`comm.ring_shift`),
the softmax accumulated exactly over the rotations — the attention's
working set is O(S/P) a rank.  One process per rank: the bodies below
run on this rank's local blocks, and `ring_attention` lays global
DTensors out for them (batch over the live data axes, heads over `tp`
where they are sharded, the sequence over `sp`).  Results go back in
their inputs' layouts: a q that came replicated over the ring gets its
output gathered over it.  The JAX package leaves the output
sequence-sharded and GSPMD reshards the ops after it; torch 2.11's
DTensor refuses to flatten a sequence-sharded [B, S, D] into rows (the
`mul` op's [B*S, D]), so in the port the layers around attention run
replicated over sp (ROADMAP.md A item 7).

Two per-rotation bodies, chosen by `_ring_kernel_mode` as in the JAX
package (:35-61):

  - flash: when the local block passes kernel #3's gate (s_loc >= 128,
    head_dim % 64 == 0), each rotation runs `flash_attention_lse` (kernel
    #3 on the card, its plain version on the CPU) on (q_local, k_blk,
    v_blk), and the rotations merge normalised (out, lse) partials:
    new_lse = logaddexp(lse, lse_blk), out rescaled by exp(lse - new_lse)
    (`_ring_local_flash`, :64-130).  The kernel's kv_len carries the
    padding mask (global lengths clamped into the held block); the
    diagonal block runs the causal kernel, past blocks run unmasked, a
    future block contributes nothing (the merge identity).
  - composite: the per-rotation score body with the running max and sum
    (`_ring_attention_local`, :133-195).

Masks use global positions (`seq_len`, causal), and the sentinel is the
finite -1e30, never -inf (the JAX docstring, :200-215): while only
masked blocks have arrived, the running max is -1e30 and the first live
block rescales the bogus sum by exp(-1e30 - m) = 0.  A row masked
everywhere gives the mean of V in the composite body and 0 in the flash
body, as in the JAX package.

The backward (`RingAttentionFunction`, and `ring_attention_grad` for the
`fused_attention_grad` op) recomputes nothing of the softmax per block:
it rotates K/V again, with dK/dV accumulators travelling with them, and
per rotation runs kernels #4 (dQ) and #5 (dK, dV) — or their plain
versions, or the composite's score algebra — from the MERGED global
(out, lse): delta = rowsum(dO o O) of the merged output.  A rotation's
own lse would give gradients that look plausible and are wrong.
"""

from __future__ import annotations

import torch

from .. import flags
from ..ops.cuda import flash_attention as _fa
from . import comm

_NEG = -1e30


def _heads(x, num_heads):
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _ring_kernel_mode(q, k, num_heads, s_loc):
    """Gate for the per-rotation flash body: kernel #3's own gate on the
    LOCAL block, plus a minimum local length (s_loc >= 128).  Returns
    "cuda" | "interpret" | None (None -> the composite body)."""
    flag = flags.get("flash_attention")
    if flag == "0" or s_loc < 128:
        return None
    loc = torch.empty((q.shape[0], s_loc, q.shape[2]), dtype=q.dtype,
                      device="meta")
    if not _fa.supported(loc, loc, num_heads):
        return None
    if flag == "interpret":
        return "interpret"
    if q.device.type == "cuda":
        return "cuda"
    return None


class _Ring:
    """One rank's place on the ring and the op's static config."""

    def __init__(self, group, index, size, num_heads, causal, scale,
                 flash):
        self.group = group
        self.index = index
        self.size = size
        self.num_heads = num_heads
        self.causal = causal
        self.scale = scale
        self.flash = flash

    def src(self, i):
        """The ring index of the block held at rotation i."""
        return (self.index - i) % self.size

    def skip(self, src):
        """A block wholly in the future of every local query."""
        return self.causal and src > self.index

    def shift(self, tensors):
        return comm.ring_shift(tensors, self.group)


def _block_len(key_len, src, s_loc, b, device):
    """Global key lengths -> the held block's local lengths (float32 [B],
    the kernels' kv_len form), or None without a padding mask."""
    if key_len is None:
        return None
    return (key_len.to(device=device, dtype=torch.int64) - src * s_loc
            ).clamp(0, s_loc).float().reshape(b)


def _live(ring, src, s_loc, key_len, device):
    """[B or 1, 1, s_loc, s_loc] bool of the composite body: causal over
    global positions, keys below the global lengths."""
    q_pos = ring.index * s_loc + torch.arange(s_loc, device=device)
    k_pos = src * s_loc + torch.arange(s_loc, device=device)
    live = torch.ones((1, 1, s_loc, s_loc), dtype=torch.bool, device=device)
    if ring.causal:
        live = live & (k_pos[None, :] <= q_pos[:, None])
    if key_len is not None:
        kl = key_len.to(device=device, dtype=torch.int64).reshape(-1)
        live = live & (k_pos < kl[:, None, None, None])
    return live


def _forward(ring, q, k, v, key_len):
    """(out [B, s_loc, H*D] in q's dtype, residuals) of the ring over the
    local blocks.  Residuals: (out f32, lse) for the flash body, (m, l,
    out f32) for the composite."""
    b, s_loc, hd = q.shape
    h = ring.num_heads
    d = hd // h
    scale = ring.scale or 1.0 / (d ** 0.5)
    kb, vb = k, v
    if ring.flash:
        o = torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                        device=q.device)
        lse = torch.full((b, h, s_loc), _NEG, dtype=torch.float32,
                         device=q.device)
        for i in range(ring.size):
            src = ring.src(i)
            if not ring.skip(src):
                ob, lb = _fa.flash_attention_lse(
                    q, kb, vb, h, ring.causal and src == ring.index, scale,
                    kv_len=_block_len(key_len, src, s_loc, b, q.device))
                new = torch.logaddexp(lse, lb)
                o = (o * torch.exp(lse - new)[..., None]
                     + _heads(ob, h).float() * torch.exp(lb - new)[..., None])
                lse = new
            if i + 1 < ring.size:
                kb, vb = ring.shift([kb, vb])
        out = _merge_heads(o)
        return out.to(q.dtype), (out, lse)
    qh = (_heads(q, h) * scale).float()
    m = torch.full((b, h, s_loc), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    for i in range(ring.size):
        src = ring.src(i)
        s = torch.matmul(qh, _heads(kb, h).float().transpose(-1, -2))
        s = torch.where(_live(ring, src, s_loc, key_len, q.device), s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p, _heads(vb, h).float())
        m = m_new
        if i + 1 < ring.size:
            kb, vb = ring.shift([kb, vb])
    inv = torch.where(l == 0.0, 0.0, 1.0 / l)
    out = _merge_heads(acc * inv[..., None])
    return out.to(q.dtype), (m, l, out)


def _backward(ring, q, k, v, key_len, dout, res):
    """(dq, dk, dv) of the ring at the local blocks, from the forward's
    merged residuals: K/V rotate again with their dK/dV accumulators,
    which are home after the last rotation."""
    b, s_loc, hd = q.shape
    h = ring.num_heads
    d = hd // h
    scale = ring.scale or 1.0 / (d ** 0.5)
    dout = dout.to(q.dtype).contiguous()
    dq = torch.zeros((b, s_loc, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    kb, vb = k, v
    if ring.flash:
        out, lse = res
        delta = _fa.bwd_delta(out, dout, h)
        lse = lse.contiguous()
    else:
        m, l, out = res
        inv = torch.where(l == 0.0, 0.0, 1.0 / l)
        qh = (_heads(q, h) * scale).float()
        doh = _heads(dout, h).float()
        delta = (doh * _heads(out, h)).sum(-1)
    for i in range(ring.size):
        src = ring.src(i)
        if ring.flash:
            if not ring.skip(src):
                blk_causal = ring.causal and src == ring.index
                kl = _block_len(key_len, src, s_loc, b, q.device)
                dq += _fa.flash_attention_bwd_dq(
                    q, kb, vb, dout, lse, delta, h, blk_causal, scale,
                    kv_len=kl).float()
                gk, gv = _fa.flash_attention_bwd_dkv(
                    q, kb, vb, dout, lse, delta, h, blk_causal, scale,
                    kv_len=kl)
                dk += gk.float()
                dv += gv.float()
        else:
            kh = _heads(kb, h).float()
            vh = _heads(vb, h).float()
            live = _live(ring, src, s_loc, key_len, q.device)
            s = torch.where(live, torch.matmul(qh, kh.transpose(-1, -2)),
                            _NEG)
            p = torch.exp(s - m[..., None]) * inv[..., None]
            dp = torch.matmul(doh, vh.transpose(-1, -2))
            ds = torch.where(live, p * (dp - delta[..., None]), 0.0)
            dq += _merge_heads(torch.matmul(ds, kh) * scale)
            dk += _merge_heads(torch.matmul(ds.transpose(-1, -2), qh))
            dv += _merge_heads(torch.matmul(p.transpose(-1, -2), doh))
        if i + 1 < ring.size:
            kb, vb, dk, dv = ring.shift([kb, vb, dk, dv])
        else:
            dk, dv = ring.shift([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttentionFunction(torch.autograd.Function):
    """The ring over local blocks as one autograd op: `_forward`, and
    `_backward` from its merged residuals."""

    @staticmethod
    def forward(ctx, q, k, v, key_len, ring):
        out, res = _forward(ring, q, k, v, key_len)
        ctx.ring = ring
        ctx.save_for_backward(q, k, v, key_len, *res)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_len, *res = ctx.saved_tensors
        dq, dk, dv = _backward(ctx.ring, q, k, v, key_len, dout, tuple(res))
        return dq, dk, dv, None, None


def _make_ring(group, q, k, num_heads, causal, scale):
    import torch.distributed as dist

    return _Ring(group, dist.get_rank(group), dist.get_world_size(group),
                 num_heads, causal, scale,
                 _ring_kernel_mode(q, k, num_heads, q.shape[1]) is not None)


def ring_attention_local(q, k, v, key_len=None, *, group, num_heads,
                         causal=False, scale=0.0):
    """Exact attention of this rank's blocks q/k/v [B, s_loc, H*D] (the
    rank's place on the sequence is its index in `group`), key_len [B]
    the GLOBAL key lengths or None.  Differentiable."""
    ring = _make_ring(group, q, k, num_heads, causal, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingAttentionFunction.apply(q, k, v, key_len, ring)
    return _forward(ring, q, k, v, key_len)[0]


def _layout(q, k, v, seq_len, mesh, num_heads, axis_name):
    """Local blocks of q, k, v (and the lengths) on `mesh`, the ring's
    group, the local head count, and the placements of q's layout."""
    from . import spmd

    qkv, lens, hdiv = spmd.attention_layout(mesh, q, num_heads,
                                            seq_axis=axis_name)
    blocks = [spmd.to_layout(x, mesh, qkv) for x in (q, k, v)]
    kl = (None if seq_len is None
          else spmd.to_layout(seq_len, mesh, lens).to_local())
    return blocks, kl, mesh.group(axis_name), num_heads // hdiv, qkv


def ring_attention(q, k, v, mesh, *, num_heads, causal=False, scale=0.0,
                   axis_name="sp", seq_len=None):
    """Exact attention with K/V ring-rotated over `axis_name` of `mesh`.
    q/k/v are global [B, S, H*D] values: DTensors on the mesh, or plain
    tensors, the same on every rank.  seq_len [B]: global key padding
    lengths.  Returns a DTensor in q's layout (`spmd.layout_of`): a q
    replicated over the ring gets its output gathered over it, so the ops
    after the attention see the layout they would without the ring.
    Differentiable: autograd runs the ring's backward on the local
    blocks."""
    from . import spmd

    blocks, lens, group, heads, qkv = _layout(q, k, v, seq_len, mesh,
                                              num_heads, axis_name)
    out = ring_attention_local(*(x.to_local() for x in blocks), lens,
                               group=group, num_heads=heads, causal=causal,
                               scale=scale)
    return spmd.to_layout(spmd.wrap(out, mesh, qkv, q.shape), mesh,
                          spmd.layout_of(q, mesh))


def ring_attention_grad(q, k, v, dout, mesh, *, num_heads, causal=False,
                        scale=0.0, axis_name="sp", seq_len=None):
    """(dq, dk, dv) of `ring_attention` at q, k, v for the cotangent dout
    (the `fused_attention_grad` op's ring branch): the forward ring runs
    again for the merged residuals, then the backward ring.  DTensors in
    the layouts of q, k and v."""
    from . import spmd

    blocks, lens, group, heads, qkv = _layout(q, k, v, seq_len, mesh,
                                              num_heads, axis_name)
    ql, kl, vl = (x.to_local() for x in blocks)
    dl = spmd.to_layout(dout, mesh, qkv).to_local()
    ring = _make_ring(group, ql, kl, heads, causal, scale)
    _, res = _forward(ring, ql, kl, vl, lens)
    grads = _backward(ring, ql, kl, vl, lens, dl, res)
    return [spmd.to_layout(spmd.wrap(g, mesh, qkv, x.shape), mesh,
                           spmd.layout_of(x, mesh))
            for g, x in zip(grads, (q, k, v))]
