"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: run with `python -m pytest tests/test_torch_cuda.py -m cuda`
on a machine with an NVIDIA H100.  Whether a card is present is decided in
the `card` fixture (never at import), so every xdist worker collects the
same tests; without a card each test skips.

Shapes are the serving, training and Scheduler slices' main paths at
transformer-base (d_model 512, 8 heads of 64), the BERT slice's flash-tier
grad at BERT-base widths (12 heads of 64, 2048 tokens), kernel #8
(bn_relu_conv1x1) at ResNet-50's conv3 widths and the ResNet conv
lowering in float32, plus the edge cases of each kernel's masking
contract.  Last, the Executor's jit path: captured decode steps against
their eager runs (bound and copied arguments, a moved pool, the launch
counts a replay adds) and a captured training step against the
interpreter's; then the recurrent slice: #6 at the GRU translator's
decode step (one head of 256 over 24 keys, batch 8 and 32) and a
captured stacked-LSTM training step against the interpreter's.
Tolerances: max abs error 1e-4 in float32 (the kernels sum in
another order than cuBLAS) and 2e-2 in bfloat16 (one bfloat16 step of an
output in [2, 4); the forwards round P to bfloat16 before P V as the
plain versions do, from float32 sums taken in another order, and the
flash forward rounds it before the division by the row sum); the
backward's bfloat16 outputs are held to 2e-2
of their largest magnitude (the flash backward's too); the flash
forward's float32 lse to 1e-4; #8's bfloat16 output to 2e-2 of its
largest magnitude.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_decode as fd
from paddle_tpu_torch.ops.cuda import flash_decode_paged as fdp
from paddle_tpu_torch.ops.cuda import mha_block

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    # the plain versions' float32 matmuls must not round through TF32
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _qkv(seed, b, sq, sk, hd, device, dtype):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(rng.standard_normal((b, s, hd)).astype(np.float32),
                            device=device).to(dtype)
            for s in (sq, sk, sk)]


def _lens(values, device):
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


@pytest.mark.parametrize("case", [
    # (b, sq, sk, heads, head_dim, causal, key_len)
    (8, 256, 256, 8, 64, False, "ragged"),   # encoder self-attention
    (8, 1024, 1024, 8, 64, True, None),      # decoder prefix, causal
    (8, 8, 256, 8, 64, False, "ragged"),     # prefill cross-attention
    (8, 1, 256, 8, 64, False, "ragged"),     # mha_decode, single query
    (2, 72, 200, 4, 128, True, "ragged"),    # ragged edges, causal offset
    (3, 16, 128, 2, 64, False, "with_zero"),  # an all-masked row
    (2, 8, 64, 2, 256, True, "with_zero"),
    # the Sq = 1 decode body: D 128 and 256, up to 2047 keys, and one
    # cache past its limit (the block kernels take that one)
    (2, 1, 1000, 2, 128, False, "ragged"),
    (2, 1, 1000, 1, 256, False, "ragged"),
    (3, 1, 2047, 2, 128, False, "ragged"),
    (3, 1, 2047, 1, 256, False, "ragged"),
    (2, 1, mha_block.DECODE_MAX_KEYS + 1, 1, 64, False, "ragged"),
    (3, 1, 300, 2, 64, False, "past_and_negative"),
    # a causal image with key_len 0: the mean of V over ALL keys
    (3, 100, 300, 2, 64, True, "zero"),
    (3, 72, 200, 2, 128, True, "past_and_negative"),
], ids=["enc256", "causal1024", "cross8x256", "decode1x256", "edges_d128",
        "masked_row", "d256", "decode1x1000_d128", "decode1x1000_d256",
        "decode1x2047_d128", "decode1x2047_d256", "decode_past_limit",
        "decode_past_negative", "causal_zero", "causal_past_negative"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mha_block_matches_plain(card, case, dtype):
    b, sq, sk, h, d, causal, kl = case
    q, k, v = _qkv(1, b, sq, sk, h * d, card, dtype)
    key_len = None
    if kl is not None:
        rng = np.random.RandomState(2)
        vals = rng.randint(max(1, sk // 2), sk + 1, size=b)
        if kl in ("with_zero", "zero"):
            vals[0] = 0
        if kl == "past_and_negative":
            vals[0], vals[1] = sk + 30, -2
        key_len = _lens(vals, card)
    before = mha_block.launches
    out = mha_block.mha_attention(q, k, v, h, causal, 0.0, key_len=key_len)
    torch.cuda.synchronize()
    assert mha_block.launches == before + 1
    ref = mha_block.mha_reference(q, k, v, h, causal, 0.0, key_len=key_len)
    assert out.shape == ref.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if kl == "with_zero" and not causal:
        # finite -1e30 masking: an all-masked row is the mean of V
        mean_v = v[0].float().mean(dim=0)
        assert torch.allclose(out[0].float(), mean_v.expand(sq, -1),
                              atol=TOL[dtype])
    empty = {"zero": 0, "past_and_negative": 1}.get(kl)
    if empty is not None:
        # key_len <= 0: the mean of V over every key, causal or not
        mean_v = v[empty].float().mean(dim=0)
        assert torch.allclose(out[empty].float(), mean_v.expand(sq, -1),
                              atol=TOL[dtype])


def test_mha_block_reads_strided_views(card):
    """q/k/v read in place through their batch and row strides (the
    column slices of a fused [B, S, 3*H*D] projection)."""
    b, s, hd, h = 2, 128, 256, 4
    rng = np.random.RandomState(3)
    qkv = torch.as_tensor(rng.standard_normal((b, s, 3 * hd)),
                          dtype=torch.float32, device=card)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    out = mha_block.mha_attention(q, k, v, h, True)
    ref = mha_block.mha_reference(q.contiguous(), k.contiguous(),
                                  v.contiguous(), h, True)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", [
    # (b, sk, heads, head_dim, kv_len)
    (8, 2048, 8, 64, "main"),       # the main path's long-cache step
    (4, 200, 2, 64, "with_zero"),   # Sk not a multiple of 128; kv_len 0
    (3, 1000, 4, 128, None),        # every key live
    (2, 136, 1, 256, "with_zero"),
    (2, 200, 2, 64, "past_the_cache"),  # kv_len > Sk: every key live
    (3, 300, 2, 64, "rank0"),       # kv_len <= 16: rank 0 alone is live
    (2, 40, 2, 128, "with_zero"),   # 3 tiles: a cluster of 4 ranks
    (2, 2048, 2, 256, "main"),      # D 256: the 2-stage ring cycles
], ids=["main2048", "ragged_zero", "unmasked_d128", "d256", "past_cache",
        "rank0_only", "few_tiles", "d256_long"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_decode_matches_plain(card, case, dtype):
    b, sk, h, d, kl = case
    q, k, v = _qkv(4, b, 1, sk, h * d, card, dtype)
    kv_len = None
    if kl == "main":
        kv_len = _lens(np.linspace(512, 1056, b).astype(np.int64), card)
    elif kl == "with_zero":
        vals = np.random.RandomState(5).randint(1, sk + 1, size=b)
        vals[0] = 0
        kv_len = _lens(vals, card)
    elif kl == "past_the_cache":
        kv_len = _lens([sk + 50, sk], card)
    elif kl == "rank0":
        kv_len = _lens([1, 16, 9], card)
    before = fd.launches
    out = fd.flash_decode(q, k, v, h, 0.0, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    ref = fd.flash_decode_reference(q, k, v, h, 0.0, kv_len=kv_len)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if kl == "with_zero":
        assert torch.count_nonzero(out[0]).item() == 0  # kv_len 0 -> O = 0


def test_flash_decode_never_reads_dead_keys(card):
    """Keys at or past kv_len are never read: NaNs planted there cannot
    reach the output."""
    b, sk, hd, h = 4, 512, 128, 2
    q, k, v = _qkv(6, b, 1, sk, hd, card, torch.float32)
    kv_len = _lens([1, 100, 300, 511], card)
    for t in (k, v):
        for row, n in enumerate((1, 100, 300, 511)):
            t[row, n:] = float("nan")
    out = fd.flash_decode(q, k, v, h, kv_len=kv_len)
    assert torch.isfinite(out).all()


def test_wrappers_raise_instead_of_falling_back(card):
    q, k, v = _qkv(7, 2, 1, 128, 64, card, torch.float32)
    with pytest.raises(ValueError):
        mha_block.mha_attention(q, k, v, 4)      # head_dim 16
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v, 4)
    with pytest.raises(ValueError):
        fd.flash_decode(q.double(), k.double(), v.double(), 1)


@pytest.mark.parametrize("case", [
    # (b, sq, sk, heads, head_dim, causal, key_len)
    (16, 256, 256, 8, 64, False, "ragged"),   # encoder self-attention
    (16, 256, 256, 8, 64, True, None),        # decoder self-attention
    (16, 256, 256, 8, 64, False, "with_zero"),  # cross, an all-masked row
    (2, 72, 200, 4, 128, True, "ragged"),     # ragged edges, causal offset
    (2, 8, 64, 2, 256, True, "with_zero"),    # 32-row tiles
    (2, 40, 100, 2, 192, False, "ragged"),
    (8, 1, 256, 8, 64, False, "ragged"),      # mha_decode's single query
    # tile edges of the bf16 tensor-core kernels (64-row q tiles, 64- or
    # 32-key tiles); key_len 0 under causal: P = 1/Sk over every key
    (2, 1, 65, 2, 64, False, [1, 63]),        # one row; one key past a tile
    (2, 17, 65, 2, 128, True, None),          # one row past an mma tile
    (2, 17, 130, 1, 192, False, [1, 63]),
    (2, 17, 130, 2, 64, True, [0, 63]),       # an all-masked image, causal
    (2, 33, 65, 2, 128, True, [0, 65]),
    (2, 1, 130, 1, 256, True, [0, 1]),
    (2, 16, 80, 1, 256, True, [0, 80]),
    (2, 65, 130, 1, 192, True, [0, 129]),
], ids=["enc256", "causal256", "cross_zero", "edges_d128", "d256", "d192",
        "decode1", "sq1_sk65_kl_1_63", "sq17_sk65_causal_d128",
        "sq17_sk130_kl_1_63_d192", "causal_zero_image", "causal_zero_d128",
        "sq1_causal_zero_d256", "causal_16x80_zero_d256",
        "sq65_causal_zero_d192"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mha_block_bwd_matches_plain(card, case, dtype):
    b, sq, sk, h, d, causal, kl = case
    q, k, v = _qkv(8, b, sq, sk, h * d, card, dtype)
    g = _qkv(9, b, sq, sq, h * d, card, dtype)[0]
    key_len = None
    if isinstance(kl, list):
        key_len = _lens(kl, card)
    elif kl is not None:
        vals = np.random.RandomState(10).randint(max(1, sk // 2), sk + 1,
                                                 size=b)
        if kl == "with_zero":
            vals[0] = 0
        key_len = _lens(vals, card)
    before = mha_block.bwd_launches
    out = mha_block.mha_block_bwd(q, k, v, g, h, causal, 0.0,
                                  key_len=key_len)
    torch.cuda.synchronize()
    assert mha_block.bwd_launches == before + 1
    ref = mha_block.mha_block_bwd_reference(q, k, v, g, h, causal, 0.0,
                                            key_len=key_len)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert o.shape == r.shape and o.dtype == dtype, name
        err = (o.float() - r.float()).abs().max().item()
        tol = TOL[torch.float32] if dtype == torch.float32 else \
            TOL[dtype] * r.float().abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mha_block_bwd_all_masked_image_reaches_every_key(card, dtype):
    """An image with key_len 0 has every score at the finite -1e30, so P
    = 1/Sk over every key, those right of the causal diagonal too, and dS
    is not masked afterwards: every key of that image gets a gradient
    (the Pallas kernel's semantics, ROADMAP C5), as in the plain
    version; the other image, key_len 70, gives keys past 70 exactly 0."""
    b, sq, sk, h, d = 2, 96, 160, 2, 64
    q, k, v = _qkv(24, b, sq, sk, h * d, card, dtype)
    g = _qkv(25, b, sq, sq, h * d, card, dtype)[0]
    key_len = _lens([0, 70], card)
    got = mha_block.mha_block_bwd(q, k, v, g, h, True, 0.0, key_len=key_len)
    torch.cuda.synchronize()
    ref = mha_block.mha_block_bwd_reference(q, k, v, g, h, True, 0.0,
                                            key_len=key_len)
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        err = (o.float() - r.float()).abs().max().item()
        tol = TOL[torch.float32] if dtype == torch.float32 else \
            TOL[dtype] * r.float().abs().max().item()
        assert err <= tol, (name, err, tol)
    dk, dv = got[1], got[2]
    # image 0: every key row has a gradient, right of the diagonal too
    for t in (dk, dv):
        assert bool((t[0].float().abs().amax(dim=-1) > 0).all())
        assert torch.count_nonzero(t[1, 70:]).item() == 0


def test_flash_bwd_dq_kv_len_zero_row_is_exactly_zero(card):
    """Kernel #4 alone, both dtypes: an image with kv_len 0 visits no key,
    so its dQ is exactly 0, and the other images match the plain
    version."""
    b, s, h, d = 3, 200, 2, 64
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, kv_len, out, lse, g, g_lse = _flash_bwd_inputs(
            26, b, s, s, h, d, True, [0, 130, 200], card, dtype)
        delta = fa.bwd_delta(out, g, h, g_lse)
        before = fa.bwd_dq_launches
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, h, True,
                                       kv_len=kv_len)
        torch.cuda.synchronize()
        assert fa.bwd_dq_launches == before + 1
        assert torch.count_nonzero(dq[0]).item() == 0, dtype
        ref = fa.bwd_reference(q, k, v, g, lse, delta, h, True, 0.0,
                               kv_len)[0]
        err = (dq.float() - ref.float()).abs().max().item()
        tol = TOL[torch.float32] if dtype == torch.float32 else \
            TOL[dtype] * ref.float().abs().max().item()
        assert err <= tol, (dtype, err, tol)


def test_mha_block_function_grads_match_autograd(card):
    """The autograd Function (forward kernel, backward kernel) against
    autograd over the plain forward, on strided q/k/v views.  Every row
    keeps a live key: for a row whose keys are all masked the kernel, like
    the Pallas one, passes dS to every key, where autograd over the masked
    forward gives 0."""
    b, s, hd, h = 4, 256, 512, 8
    rng = np.random.RandomState(11)
    qkv = torch.as_tensor(rng.standard_normal((b, s, 3 * hd)),
                          dtype=torch.float32, device=card)
    kl = _lens([256, 200, 129, 1], card)
    g = torch.as_tensor(rng.standard_normal((b, s, hd)), dtype=torch.float32,
                        device=card)
    grads = []
    for fn in (mha_block.mha_attention, mha_block.mha_reference):
        leaf = qkv.clone().requires_grad_(True)
        q, k, v = leaf[..., :hd], leaf[..., hd:2 * hd], leaf[..., 2 * hd:]
        out = fn(q, k, v, h, False, 0.0, key_len=kl)
        (gr,) = torch.autograd.grad(out, leaf, g)
        grads.append(gr)
    before = mha_block.bwd_launches
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4
    leaf = qkv.clone().requires_grad_(True)
    out = mha_block.mha_attention(leaf[..., :hd], leaf[..., hd:2 * hd],
                                  leaf[..., 2 * hd:], h, True)
    out.sum().backward()
    assert mha_block.bwd_launches == before + 1


def test_bwd_wrapper_raises_instead_of_falling_back(card):
    q, k, v = _qkv(12, 2, 8, 128, 64, card, torch.float32)
    with pytest.raises(ValueError):
        mha_block.mha_block_bwd(q, k, v, q, 4)            # head_dim 16
    with pytest.raises(ValueError):
        mha_block.mha_block_bwd(q, k, v, q.double(), 1)   # dO dtype
    with pytest.raises(ValueError):
        mha_block.mha_block_bwd(
            q, k, v, q.transpose(1, 2).contiguous().transpose(1, 2), 1)


# ------------------------------------------- kernel #7: flash_decode_paged


def _pool_case(seed, b, n, bs, m, h, d, lengths, device, dtype):
    """q, pools [N, bs, H*D] and block tables drawn from one random
    permutation of the pool (scattered, never contiguous chains)."""
    rng = np.random.RandomState(seed)
    hd = h * d
    q = torch.as_tensor(rng.standard_normal((b, 1, hd)).astype(np.float32),
                        device=device).to(dtype)
    kb, vb = (torch.as_tensor(rng.standard_normal((n, bs, hd))
                              .astype(np.float32), device=device).to(dtype)
              for _ in range(2))
    table = torch.as_tensor(rng.permutation(n)[:b * m].reshape(b, m),
                            device=device)
    return q, kb, vb, table, _lens(lengths, device)


@pytest.mark.parametrize("case", [
    # (b, n, bs, m, heads, head_dim, lengths)
    (8, 2560, 16, 256, 8, 64, "serving"),   # the Scheduler's decode step
    (5, 23, 16, 4, 4, 64, [5, 16, 17, 37, 64]),  # across block edges
    (4, 40, 32, 8, 2, 128, [0, 1, 200, 256]),    # bs 32, an empty row
    (2, 9, 16, 3, 1, 256, [48, 7]),
    (3, 40, 16, 8, 2, 64, [1, 16, 9]),           # rank 0 alone is live
    (3, 12, 16, 3, 2, 128, [48, 0, 33]),         # 3 pages: 4 ranks
    (2, 300, 16, 128, 2, 256, [2048, 1000]),     # D 256, a long reach
], ids=["serving", "edges", "bs32_zero", "d256", "rank0_only", "few_pages",
        "d256_long"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_decode_paged_matches_plain(card, case, dtype):
    b, n, bs, m, h, d, lengths = case
    if lengths == "serving":
        lengths = np.random.RandomState(13).randint(1024, 4097, size=b)
    q, kb, vb, table, kl = _pool_case(14, b, n, bs, m, h, d, lengths, card,
                                      dtype)
    before = fdp.launches
    out = fdp.flash_decode_paged(q, kb, vb, table, kl, h)
    torch.cuda.synchronize()
    assert fdp.launches == before + 1
    ref = fdp.flash_decode_paged_reference(q, kb, vb, table, kl, h)
    assert out.shape == ref.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    for row, n_live in enumerate(np.asarray(lengths)):
        if n_live == 0:
            assert torch.count_nonzero(out[row]).item() == 0


def test_flash_decode_paged_never_reads_past_the_length(card):
    """Junk table entries past ceil(len / bs) and NaNs planted in the
    dead rows of live blocks cannot reach the output."""
    b, n, bs, m, h, d = 3, 30, 16, 6, 2, 64
    lengths = [20, 9, 96]
    q, kb, vb, table, kl = _pool_case(15, b, n, bs, m, h, d, lengths, card,
                                      torch.float32)
    ref = fdp.flash_decode_paged(q, kb, vb, table, kl, h)
    junk = table.clone()
    junk[0, 2:] = (junk[0, 2:] + 1) % n
    junk[1, 1:] = 10 ** 6               # out of the pool: clipped
    for row, n_live in enumerate(lengths):
        blk, off = divmod(n_live, bs)
        if blk < m:
            for t in (kb, vb):
                t[table[row, blk], off:] = float("nan")
    out = fdp.flash_decode_paged(q, kb, vb, junk, kl, h)
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)


def _offset_view(t, offset):
    """t's values in a view whose rows start `offset` elements into a
    wider buffer: strided, and off the 16-byte grid unless offset is a
    multiple of 16 bytes."""
    buf = torch.zeros(t.shape[:-1] + (t.shape[-1] + 8,), dtype=t.dtype,
                      device=t.device)
    view = buf[..., offset:offset + t.shape[-1]]
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype,offset", [
    (torch.float32, 1), (torch.float32, 2), (torch.bfloat16, 2),
    (torch.bfloat16, 4)], ids=["f32_4B", "f32_8B", "bf16_4B", "bf16_8B"])
def test_decode_kernels_copy_unaligned_views(card, dtype, offset):
    """K/V views whose rows start on 4 or 8 bytes take the narrow cp.async
    copies (#6 and #7), and give what the contiguous tensors give."""
    q, kb, vb, table, kl = _pool_case(21, 3, 40, 16, 6, 2, 64, [5, 96, 40],
                                      card, dtype)
    kv, vv = _offset_view(kb, offset), _offset_view(vb, offset)
    assert kv.data_ptr() % 16 != 0
    ref = fdp.flash_decode_paged(q, kb, vb, table, kl, 2)
    assert torch.equal(fdp.flash_decode_paged(q, kv, vv, table, kl, 2), ref)
    q, k, v = _qkv(22, 3, 1, 300, 128, card, dtype)
    kv_len = _lens([7, 300, 150], card)
    ref = fd.flash_decode(q, k, v, 2, kv_len=kv_len)
    out = fd.flash_decode(q, _offset_view(k, offset), _offset_view(v, offset),
                          2, kv_len=kv_len)
    assert torch.equal(out, ref)


def test_decode_kernels_refuse_rows_off_4_bytes(card):
    """A bf16 view whose rows start on 2 bytes cannot be copied by
    cp.async: both wrappers raise (no fallback)."""
    q, kb, vb, table, kl = _pool_case(23, 2, 10, 16, 2, 1, 64, [5, 20],
                                      card, torch.bfloat16)
    with pytest.raises(RuntimeError):
        fdp.flash_decode_paged(q, _offset_view(kb, 1), _offset_view(vb, 1),
                               table, kl, 1)
    q, k, v = _qkv(24, 2, 1, 64, 64, card, torch.bfloat16)
    with pytest.raises(RuntimeError):
        fd.flash_decode(q, _offset_view(k, 1), _offset_view(v, 1), 1)


def test_paged_cluster_that_cannot_fit_raises(card):
    """A table reach whose block-id slice overflows shared memory is a
    launch the occupancy check refuses: the wrapper raises."""
    q, kb, vb, _, kl = _pool_case(25, 1, 4, 16, 1, 1, 64, [20], card,
                                  torch.float32)
    table = torch.zeros((1, 1 << 19), dtype=torch.int32, device=card)
    before = fdp.launches
    with pytest.raises(RuntimeError):
        fdp.flash_decode_paged(q, kb, vb, table, kl, 1)
    assert fdp.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_table_and_length_dtypes_are_bitwise_equal(card, dtype):
    """int64 and int32 tables, int64, int32 and float32 lengths: the kernel
    reads each as it is, and every combination gives the same bits."""
    q, kb, vb, table, kl = _pool_case(26, 8, 600, 16, 64, 8, 64,
                                      np.linspace(0, 1024, 8).astype(int),
                                      card, dtype)
    ref = fdp.flash_decode_paged(q, kb, vb, table, kl, 8)
    for tab in (table.to(torch.int32), table):
        for lens in (kl.to(torch.int32), kl.float(), kl):
            out = fdp.flash_decode_paged(q, kb, vb, tab, lens, 8)
            assert torch.equal(out, ref)
    q, k, v = _qkv(27, 4, 1, 500, 256, card, dtype)
    kv_len = _lens([0, 17, 256, 499], card)
    ref = fd.flash_decode(q, k, v, 4, kv_len=kv_len)
    for lens in (kv_len.to(torch.int32), kv_len.float()):
        assert torch.equal(fd.flash_decode(q, k, v, 4, kv_len=lens), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_rows_do_not_depend_on_the_batch_or_the_run(card, dtype):
    """The merge is in a fixed order with no atomics: two identical calls
    give the same bits, and a row gives the same bits alone (batch 1) as
    in a batch of 8."""
    lengths = np.linspace(1024, 2080, 8).astype(int)
    q, kb, vb, table, kl = _pool_case(28, 8, 2560, 16, 256, 8, 64, lengths,
                                      card, dtype)
    out = fdp.flash_decode_paged(q, kb, vb, table, kl, 8)
    assert torch.equal(fdp.flash_decode_paged(q, kb, vb, table, kl, 8), out)
    for row in (0, 5):
        one = fdp.flash_decode_paged(q[row:row + 1], kb, vb,
                                     table[row:row + 1], kl[row:row + 1], 8)
        assert torch.equal(one, out[row:row + 1])
    q, k, v = _qkv(29, 8, 1, 2048, 512, card, dtype)
    kv_len = _lens(np.linspace(512, 1056, 8).astype(int), card)
    out = fd.flash_decode(q, k, v, 8, kv_len=kv_len)
    assert torch.equal(fd.flash_decode(q, k, v, 8, kv_len=kv_len), out)
    for row in (0, 7):
        one = fd.flash_decode(q[row:row + 1], k[row:row + 1],
                              v[row:row + 1], 8, kv_len=kv_len[row:row + 1])
        assert torch.equal(one, out[row:row + 1])


# ---------------------------------------- kernel #3: flash attention fwd

# Shapes at the edges of the bf16 kernels' tiles (16-row mma tiles, 64-key
# tiles at D <= 128 and 32-key tiles above, 64 or 32 keys a dK/dV block),
# for #3 and #4/#5: (b, sq, sk, heads, head_dim, causal, kv_len), kv_len a
# list of per-image lengths
EDGE_CASES = [
    (2, 1, 65, 2, 64, False, None),          # one row; one key past a tile
    (2, 17, 65, 2, 64, False, None),         # one row past an mma tile
    (2, 17, 65, 2, 128, True, None),         # the same, causal offset 48
    (2, 40, 100, 2, 64, False, [1, 63]),     # kv_len 1 and a tile less one
    (2, 33, 70, 1, 192, False, [1, 63]),
    (2, 16, 80, 2, 64, True, None),          # causal, Sq 16, Sk 80
    (2, 16, 80, 1, 256, True, [80, 63]),
]
EDGE_IDS = ["sq1_sk65", "sq17_sk65", "sq17_sk65_causal_d128",
            "kv_len_1_63", "kv_len_1_63_d192", "causal_16x80",
            "causal_16x80_d256"]


def _kv_len(kl, seed, b, sk, device):
    """kv_len of a case: None, a list, or "ragged" (sk/2..sk), "with_zero"
    (ragged, image 0 empty), "past_sk" (ragged, image 0 at sk + 60)."""
    if kl is None:
        return None
    if isinstance(kl, list):
        return _lens(kl, device)
    vals = np.random.RandomState(seed).randint(max(1, sk // 2), sk + 1,
                                               size=b)
    if kl == "with_zero":
        vals[0] = 0
    if kl == "past_sk":
        vals[0] = sk + 60
    return _lens(vals, device)



@pytest.mark.parametrize("case", [
    # (b, sq, sk, heads, head_dim, causal, kv_len)
    (8, 2048, 2048, 8, 64, True, None),      # the long-prompt prefill
    (8, 1000, 1000, 8, 64, True, "ragged"),  # off the 128 grid
    (4, 200, 200, 2, 64, True, "with_zero"),  # an empty row
    (2, 72, 300, 4, 128, True, "ragged"),    # causal offset Sq < Sk
    (3, 130, 257, 2, 64, False, "past_sk"),  # kv_len > Sk is clamped
    (2, 64, 96, 1, 256, False, None),
    *EDGE_CASES,
], ids=["causal2048", "causal1000", "zero_row", "offset_d128", "past_sk",
        "d256", *EDGE_IDS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_matches_plain(card, case, dtype):
    b, sq, sk, h, d, causal, kl = case
    q, k, v = _qkv(16, b, sq, sk, h * d, card, dtype)
    kv_len = _kv_len(kl, 17, b, sk, card)
    before = fa.launches
    out, lse = fa.flash_attention_lse(q, k, v, h, causal, 0.0, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, h, causal, 0.0,
                                                    kv_len=kv_len)
    assert out.shape == ref.shape and out.dtype == dtype
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= 1e-4, lse_err
    if kl == "with_zero":
        assert torch.count_nonzero(out[0]).item() == 0
        assert (lse[0] == -1e30).all()


def test_new_wrappers_raise_instead_of_falling_back(card):
    q, k, v = _qkv(18, 2, 8, 128, 64, card, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, 4)                  # head_dim 16
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :4], v[:, :4], 1, causal=True)  # Sq > Sk
    pool = torch.zeros((4, 16, 64), device=card)
    table = torch.zeros((2, 2), dtype=torch.int64, device=card)
    lens = _lens([3, 4], card)
    with pytest.raises(ValueError):
        fdp.flash_decode_paged(q[:, :1], pool, pool, table, lens, 4)
    with pytest.raises(ValueError):
        fdp.flash_decode_paged(q[:, :2], pool, pool, table, lens, 1)


# ------------------------------- kernels #4 and #5: flash attention bwd


def _flash_bwd_inputs(seed, b, sq, sk, h, d, causal, kl, device, dtype):
    """q, k, v, kv_len, the forward's (out, lse) from the plain version,
    and the cotangents of out and of lse."""
    q, k, v = _qkv(seed, b, sq, sk, h * d, device, dtype)
    kv_len = _kv_len(kl, seed + 1, b, sk, device)
    out, lse = fa.flash_attention_fwd_reference(q, k, v, h, causal, 0.0,
                                                kv_len=kv_len)
    rng = np.random.RandomState(seed + 2)
    g = torch.as_tensor(rng.standard_normal(q.shape).astype(np.float32),
                        device=device).to(dtype)
    g_lse = torch.as_tensor(rng.standard_normal((b, h, sq))
                            .astype(np.float32), device=device)
    return q, k, v, kv_len, out, lse, g, g_lse


@pytest.mark.parametrize("case", [
    # (b, sq, sk, heads, head_dim, causal, kv_len)
    (2, 256, 256, 4, 64, False, "ragged"),   # BERT's masked encoder
    (2, 256, 256, 4, 64, False, None),
    (2, 200, 200, 2, 64, True, "with_zero"),  # off-grid, an empty row
    (2, 72, 300, 4, 128, True, "ragged"),    # causal offset Sq < Sk
    (3, 130, 257, 2, 64, False, "past_sk"),  # kv_len > Sk is clamped
    (2, 64, 96, 1, 256, False, None),        # 32-row tiles
    (2, 40, 100, 2, 192, True, None),
    *EDGE_CASES,
], ids=["masked256", "unmasked256", "zero_row", "offset_d128", "past_sk",
        "d256", "d192", *EDGE_IDS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_bwd_matches_plain(card, case, dtype):
    b, sq, sk, h, d, causal, kl = case
    q, k, v, kv_len, out, lse, g, g_lse = _flash_bwd_inputs(
        19, b, sq, sk, h, d, causal, kl, card, dtype)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, h, causal, 0.0,
                                 kv_len=kv_len, g_lse=g_lse)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, h, causal,
                                           0.0, kv_len=kv_len, g_lse=g_lse)
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        assert o.shape == r.shape and o.dtype == dtype, name
        err = (o.float() - r.float()).abs().max().item()
        tol = TOL[torch.float32] if dtype == torch.float32 else \
            TOL[dtype] * r.float().abs().max().item()
        assert err <= tol, (name, err, tol)
        if kl == "with_zero":
            assert torch.count_nonzero(o[0]).item() == 0, name


@pytest.mark.parametrize("seed", range(12))
def test_flash_attention_bf16_random_shapes_match_plain(card, seed):
    """The bf16 tensor-core kernels #3 and #5 (and #4) at random shapes:
    Sq and Sk from 1 to 300, every head_dim, causal or not, random kv_len
    (past Sk included), against the plain versions with the file's
    bf16 tolerances."""
    rng = np.random.RandomState(100 + seed)
    d = int(rng.choice([64, 128, 192, 256]))
    h = int(rng.randint(1, 4))
    b = int(rng.randint(1, 4))
    sk = int(rng.randint(1, 301))
    causal = bool(rng.randint(2))
    sq = int(rng.randint(1, sk + 1)) if causal else int(rng.randint(1, 301))
    kl = [int(x) for x in rng.randint(0, sk + 40, size=b)] \
        if rng.randint(2) else None
    q, k, v, kv_len, out, lse, g, g_lse = _flash_bwd_inputs(
        200 + seed, b, sq, sk, h, d, causal, kl, card, torch.bfloat16)
    got, got_lse = fa.flash_attention_lse(q, k, v, h, causal, 0.0,
                                          kv_len=kv_len)
    torch.cuda.synchronize()
    assert (got.float() - out.float()).abs().max().item() <= 2e-2
    assert (got_lse - lse).abs().max().item() <= 1e-4
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, h, causal, 0.0,
                                   kv_len=kv_len, g_lse=g_lse)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, h, causal,
                                           0.0, kv_len=kv_len, g_lse=g_lse)
    for name, o, r in zip(("dq", "dk", "dv"), grads, ref):
        err = (o.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * r.float().abs().max().item(), (name, err)


def test_flash_attention_function_grads_match_autograd(card):
    """FlashAttentionFunction (kernel #3 forward, #4 and #5 backward)
    against autograd over the plain forward, with cotangents on out and
    on lse, on strided q/k/v views; every row keeps a live key."""
    b, s, hd, h = 2, 320, 256, 4
    rng = np.random.RandomState(20)
    qkv = torch.as_tensor(rng.standard_normal((b, s, 3 * hd)),
                          dtype=torch.float32, device=card)
    kl = _lens([320, 131], card)
    g = torch.as_tensor(rng.standard_normal((b, s, hd)), dtype=torch.float32,
                        device=card)
    g_lse = torch.as_tensor(rng.standard_normal((b, h, s)),
                            dtype=torch.float32, device=card)
    grads = []
    before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    for fn in (fa.flash_attention_lse, fa.flash_attention_fwd_reference):
        leaf = qkv.clone().requires_grad_(True)
        q, k, v = leaf[..., :hd], leaf[..., hd:2 * hd], leaf[..., 2 * hd:]
        out, lse = fn(q, k, v, h, True, 0.0, kv_len=kl)
        (gr,) = torch.autograd.grad((out, lse), leaf, (g, g_lse))
        grads.append(gr)
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == \
        tuple(n + 1 for n in before)
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4


def test_bert_flash_grad_op_matches_the_composite(card):
    """fused_attention_grad on the card at BERT-base widths and 2048 tokens
    with ragged key lengths: the gate picks the flash tier (kernel #3 to
    recompute out and lse, then #4 and #5), and the grads equal the
    composite's (flags flash_attention "0") within 1e-4."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import attention_ops, registry

    b, s, h, d = 2, 2048, 12, 64
    q, k, v = _qkv(21, b, s, s, h * d, card, torch.float32)
    g = _qkv(22, b, s, s, h * d, card, torch.float32)[0]
    seq_len = _lens([2048, 1100], card)
    assert attention_ops.backend_choice(q, k, h, False, False, True) == \
        "flash"
    info = registry.get_runtime_info("fused_attention_grad")
    inputs = {"Q": [q], "K": [k], "V": [v], "Out@GRAD": [g],
              "SeqLen": [seq_len]}
    attrs = {"num_heads": h, "causal": False, "scale": 0.0}
    out_names = {p: [p] for p in ("Q@GRAD", "K@GRAD", "V@GRAD")}
    before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = registry.run_forward(info, inputs, attrs, out_names=out_names,
                               device=card)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == \
        tuple(n + 1 for n in before)
    flags.set("flash_attention", "0")
    try:
        want = registry.run_forward(info, inputs, attrs, out_names=out_names,
                                    device=card)
    finally:
        flags.reset("flash_attention")
    for name in out_names:
        err = (got[name][0] - want[name][0]).abs().max().item()
        assert err <= 1e-4, (name, err)


def test_bwd_kernels_raise_instead_of_falling_back(card):
    b, s, h, d = 2, 64, 2, 64
    q, k, v, kv_len, out, lse, g, _ = _flash_bwd_inputs(
        23, b, s, s, h, d, False, None, card, torch.float32)
    delta = fa.bwd_delta(out, g, h)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, 8)  # head_dim 16
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q, k, v, g.double(), lse, delta, h)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dkv(q, k, v, g, lse[:, :1], delta, h)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta.double(), h)


def _conv1x1_inputs(seed, b, c, hw, k, device, dtype):
    rng = np.random.RandomState(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dt)

    return (t(rng.standard_normal((b, c) + hw)),
            t(rng.rand(c) + 0.5, torch.float32),
            t(rng.standard_normal(c) * 0.5, torch.float32),
            t(rng.standard_normal((c, k)) * c ** -0.5))


@pytest.mark.parametrize("case", [
    # (b, c, (h, w), k)
    (4, 64, (56, 56), 256),      # ResNet-50's conv3 sites, batch cut
    (8, 128, (28, 28), 512),
    (8, 256, (14, 14), 1024),
    (16, 512, (7, 7), 2048),
    (3, 40, (24, 24), 72),       # C, K and B*HW off every tile
    (1, 7, (1, 3), 5),
    # odd batches: pixel tiles cross images at unaligned rows (HW 196:
    # 8-byte copies; HW 49: 4-byte words), C off the 32-channel stage
    (37, 256, (14, 14), 1024),
    (5, 512, (7, 7), 2048),
    (3, 200, (14, 14), 136),
    (7, 72, (7, 7), 100),        # K % 8 != 0: w by scalar loads
    (3, 33, (5, 5), 24),         # an odd number of y elements
    (3, 64, (5, 6), 40),         # HW 30: image regions, HW % 4 == 2
    (2, 16, (13, 13), 24),       # HW 169, odd and past the regions: words
], ids=["56x56", "28x28", "14x14", "7x7", "ragged", "tiny", "14x14_b37",
        "7x7_b5", "14x14_c200", "7x7_c72_k100", "odd_total", "hw30",
        "hw169"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bn_relu_conv1x1_matches_plain(card, case, dtype):
    b, c, hw, k = case
    y, scale, bias, w = _conv1x1_inputs(3, b, c, hw, k, card, dtype)
    before = brc.launches
    out = brc.bn_relu_conv1x1(y, scale, bias, w)
    torch.cuda.synchronize()
    assert brc.launches == before + 1
    ref = brc.bn_relu_conv1x1_reference(y, scale, bias, w)
    assert out.shape == (b, k) + hw and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref.float().abs().max().item()
    assert err <= TOL[dtype], err


def test_bn_relu_conv1x1_wrapper_raises_instead_of_falling_back(card):
    y, scale, bias, w = _conv1x1_inputs(4, 2, 8, (4, 4), 16, card,
                                        torch.float32)
    with pytest.raises(ValueError, match="dtypes"):
        brc.bn_relu_conv1x1(y, scale, bias, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        brc.bn_relu_conv1x1(y.transpose(2, 3), scale, bias, w)
    with pytest.raises(ValueError, match="disagree"):
        brc.bn_relu_conv1x1(y, scale, bias, w[:4])


def test_bn_relu_conv1x1_bf16_refuses_misaligned_y(card):
    """The bf16 kernel copies y, w and z in 16-, 8- or 4-byte pieces from
    their start: a y that does not start on 16 bytes is refused (no
    fallback), and the same view in float32 runs."""
    b, c, hw, k = 2, 64, (8, 8), 128
    for dtype, ok in ((torch.bfloat16, False), (torch.float32, True)):
        y, scale, bias, w = _conv1x1_inputs(6, b, c, hw, k, card, dtype)
        buf = torch.empty(y.numel() + 1, dtype=dtype, device=card)
        shifted = buf[1:].view(y.shape)
        shifted.copy_(y)
        if ok:
            brc.bn_relu_conv1x1(shifted, scale, bias, w)
            torch.cuda.synchronize()
            continue
        with pytest.raises(RuntimeError):
            brc.bn_relu_conv1x1(shifted, scale, bias, w)


def test_conv_lowering_runs_float32_without_tf32(card):
    """The conv2d lowering and its grad on the card equal the CPU's in
    float32 at 1e-5 relative: cuDNN's TF32 is off inside them (it would
    round the inputs to 10 mantissa bits), and the global flag is left as
    it was."""
    from paddle_tpu_torch.ops import registry

    rng = np.random.RandomState(5)
    x = rng.standard_normal((8, 64, 28, 28)).astype(np.float32)
    w = (rng.standard_normal((128, 64, 3, 3)) / 24).astype(np.float32)
    gy = rng.standard_normal((8, 128, 28, 28)).astype(np.float32)
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1}
    flag = torch.backends.cudnn.allow_tf32
    res = {}
    for dev in (torch.device("cpu"), card):
        t = {n: torch.as_tensor(a, device=dev) for n, a in
             (("x", x), ("w", w), ("gy", gy))}
        fwd = registry.run_forward(
            registry.get_runtime_info("conv2d"),
            {"Input": [t["x"]], "Filter": [t["w"]]}, attrs,
            out_names={"Output": ["o"]}, device=dev)["Output"][0]
        grads = registry.run_forward(
            registry.get_runtime_info("conv2d_grad"),
            {"Input": [t["x"]], "Filter": [t["w"]], "Output": [fwd],
             "Output@GRAD": [t["gy"]]}, attrs,
            out_names={"Input@GRAD": ["gx"], "Filter@GRAD": ["gw"]},
            device=dev)
        res[dev.type] = [fwd, grads["Input@GRAD"][0],
                         grads["Filter@GRAD"][0]]
    assert torch.backends.cudnn.allow_tf32 == flag
    for a, b in zip(res["cuda"], res["cpu"]):
        scale = b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_top_k_breaks_ties_lower_index_first_on_the_card(card, dtype):
    """top_k on the card orders equal values as jax.lax.top_k does, lower
    index first (the card's sort could order ties in yet another way),
    and accuracy reads the same hits: X = [1, 2, 2, 2, 0, 2], an all-equal
    row, and logits tied at their maximum."""
    from paddle_tpu_torch.ops import registry

    rng = np.random.RandomState(6)
    logits = rng.standard_normal((64, 1000)).astype(np.float32)
    logits[:, [3, 500, 999]] = logits.max(axis=1, keepdims=True) + 0.25
    rows = np.zeros((66, 1000), np.float32)
    rows[0, :6] = [1, 2, 2, 2, 0, 2]
    rows[1] = 0.5
    rows[2:] = logits
    x = torch.as_tensor(rows, device=card).to(dtype)
    got = registry.run_forward(
        registry.get_runtime_info("top_k"), {"X": [x]}, {"k": 3},
        out_names={"Out": ["o"], "Indices": ["i"]}, device=card)
    idx = got["Indices"][0].cpu().numpy()
    want = np.argsort(-x.float().cpu().numpy(), axis=-1, kind="stable")[:, :3]
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(idx[0], [1, 2, 3])
    np.testing.assert_array_equal(idx[2:], np.tile([3, 500, 999], (64, 1)))
    label = torch.full((66, 1), 500, dtype=torch.int64, device=card)
    acc = registry.run_forward(
        registry.get_runtime_info("accuracy"),
        {"Out": got["Out"], "Indices": got["Indices"], "Label": [label]}, {},
        out_names={"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]},
        device=card)
    assert acc["Correct"][0].item() == 64


def test_bf16_flash_kernels_refuse_misaligned_rows(card):
    """The bf16 tensor-core kernels (#1, #3, #4, #5 and #2's three) copy
    16-byte chunks of each row: a view whose rows do not start on 16
    bytes is refused (no fallback to another kernel), and so is #1's
    single-query body in bf16; the same views in float32 run."""
    b, s, h, d = 2, 64, 2, 64
    buf = torch.randn((b, s, 3 * h * d + 1), device=card)
    lse = torch.zeros((b, h, s), device=card)
    for dtype, ok in ((torch.bfloat16, False), (torch.float32, True)):
        t = buf.to(dtype)
        q, k, v = (t[..., 1 + i * h * d:1 + (i + 1) * h * d]
                   for i in range(3))
        calls = (lambda: fa.flash_attention_lse(q, k, v, h),
                 lambda: fa.flash_attention_bwd_dq(q, k, v, q, lse, lse, h),
                 lambda: fa.flash_attention_bwd_dkv(q, k, v, q, lse, lse, h),
                 lambda: mha_block.mha_block_bwd(q, k, v, q, h),
                 lambda: mha_block.mha_attention(q, k, v, h),
                 lambda: mha_block.mha_attention(q[:, :1], k, v, h))
        for call in calls:
            if ok:
                call()
                torch.cuda.synchronize()
                continue
            with pytest.raises(RuntimeError):
                call()


# ---------------------------------------------------- serving's new paths

SERVE_CFG = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
                 d_model=128, d_inner=256, dropout=0.0)
SERVE_S, SERVE_WINDOW, SERVE_MAX_LEN, SERVE_MNT = 128, 256, 512, 10


def _serve_world(device, **spec_kw):
    """A head_dim-64 decode spec, seeded random weights (matrices and the
    embedding times 3, so that greedy tokens do not collapse) on `device`,
    seeded single-request feeds, and the sequential Generator's tokens
    for each."""
    from paddle_tpu_torch import Scope, decode
    from paddle_tpu_torch.models import transformer

    spec = transformer.build_decode(
        transformer.TransformerConfig(**SERVE_CFG), src_len=SERVE_S,
        prefix_len=SERVE_WINDOW, max_len=SERVE_MAX_LEN, **spec_kw)
    for startup in (spec.prefill_startup, spec.step_startup):
        startup.random_seed = 7
    scope = Scope()
    gen = decode.Generator(spec, scope=scope, place=device)
    with torch.no_grad():
        for n in scope.local_var_names():
            if n.endswith(".w_0") or n == "src_word_emb":
                scope.find_var(n).mul_(3.0)
    rng = np.random.RandomState(11)
    feeds = [{
        "src_ids": rng.randint(2, 64, size=(1, SERVE_S)).astype(np.int64),
        "src_lens": np.asarray([rng.randint(64, SERVE_S + 1)], np.int64),
        "trg_ids": rng.randint(2, 64, size=(1, SERVE_WINDOW)).astype(
            np.int64),
        "prefix_lens": np.asarray([n], np.int64),
    } for n in (256, 200, 130, 70, 17)]
    refs = [gen.generate(f, SERVE_MNT, eos_id=-1)[0].tolist() for f in feeds]
    return spec, scope, feeds, refs


def _served(reqs, refs):
    for i, (r, ref) in enumerate(zip(reqs, refs, strict=True)):
        assert r.status == "done", (i, r.status, r.error)
        assert r.tokens == ref, f"request {i} vs the sequential Generator"


def test_spec_decode_on_the_card_equals_sequential(card):
    """Speculative decoding over the device pool: the trunc draft and the
    target itself as the draft (every proposal accepted).  Tokens equal
    the sequential Generator's; plain and draft steps launch #7."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import transformer

    spec, scope, feeds, refs = _serve_world(card, verify_len=4)
    cfg = transformer.TransformerConfig(**SERVE_CFG)
    kw = dict(src_len=SERVE_S, prefix_len=SERVE_WINDOW,
              max_len=SERVE_MAX_LEN)
    drafts = (transformer.build_draft(cfg, tier="trunc", scope=scope,
                                      **kw)[0],
              transformer.build_decode(cfg, **kw))
    for draft in drafts:
        sched = serving.Scheduler(spec, scope, place=card, max_batch=4,
                                  block_size=16, paged_kv=True,
                                  spec_decode=True, spec_k=4,
                                  draft_spec=draft)
        fdp.launches = 0
        reqs = [sched.submit(f, SERVE_MNT, eos_id=-1) for f in feeds]
        sched.run_until_idle(max_steps=500)
        _served(reqs, refs)
        st = sched.stats()
        assert st["spec_rounds"] > 0 and fdp.launches > 0
        sched.pool.assert_quiesced()
    assert st["spec_accepted"] == st["spec_proposed"]


def test_chunked_prefill_on_the_card_equals_sequential(card):
    """Chunk windows of 64 rows over the device pool, interleaved with the
    decode steps of the short prompts, and one request exported mid-chunk
    into a second Scheduler: tokens equal the sequential Generator's; the
    encode pass and the windows' cross-attention launch #1."""
    from paddle_tpu_torch import serving

    spec, scope, feeds, refs = _serve_world(card, chunk_len=64)
    a = serving.Scheduler(spec, scope, place=card, max_batch=4,
                          block_size=16, paged_kv=True, prefill_chunk=64)
    mha_block.launches = 0
    reqs = [a.submit(f, SERVE_MNT, eos_id=-1, request_id=str(i))
            for i, f in enumerate(feeds)]
    a.step()
    a.step()
    rec = next(r for r in a.export_requests() if r["request_id"] == "1")
    reqs[1].cancel()
    a.run_until_idle(max_steps=500)
    b = serving.Scheduler(spec, scope, place=card, max_batch=4,
                          block_size=16, paged_kv=True, prefill_chunk=64)
    (moved,) = b.import_requests([rec])
    b.run_until_idle(max_steps=500)
    assert reqs[1].status == "cancelled"
    _served(reqs[:1] + reqs[2:] + [moved], refs[:1] + refs[2:] + [refs[1]])
    assert a.counters["chunked"] >= 2 and mha_block.launches > 0
    a.pool.assert_quiesced()
    b.pool.assert_quiesced()


def test_two_tier_handoff_on_the_card_equals_sequential(card):
    """A prefill tier (chunks of 64, blocks of 16) hands each request off
    to a decode tier with blocks of 32: tokens equal the sequential
    Generator's."""
    from paddle_tpu_torch import serving

    spec, scope, feeds, refs = _serve_world(card, chunk_len=64)
    pre = serving.Scheduler(spec, scope, place=card, max_batch=4,
                            block_size=16, paged_kv=True, prefill_chunk=64)
    dec = serving.Scheduler(spec, scope, place=card, max_batch=4,
                            block_size=32, paged_kv=True)
    handles = [pre.submit(f, SERVE_MNT, eos_id=-1, prefill_only=True)
               for f in feeds]
    pre.run_until_idle(max_steps=500)
    moved = []
    for h in handles:
        assert h.status == "prefilled", (h.status, h.error)
        rec = h.handoff
        moved.append(dec.submit(
            serving.decode_feed(rec["feed"]), rec["max_new_tokens"],
            eos_id=rec["eos_id"], recorded_tokens=rec["tokens"],
            kv_payload={"cursor": rec["cursor"], "rows": rec["kv"],
                        "states": rec["states"],
                        "last_tok": rec["last_tok"],
                        "n_tokens": rec["n_tokens"]}))
    dec.run_until_idle(max_steps=500)
    _served(moved, refs)
    assert dec.counters["adopted"] == len(feeds)
    pre.pool.assert_quiesced()
    dec.pool.assert_quiesced()


# ------------------------------------------- the jit path: captured graphs


def test_captured_decode_step_equals_its_eager_run(card):
    """One decode step at one signature, three times over the same cursor
    (the append rewrites the same row): the first call runs eagerly, the
    second captures and replays, the third replays.  The logits agree
    within 1e-6 and the launch counts of every call are equal."""
    from paddle_tpu_torch import decode
    from paddle_tpu_torch.framework import cuda_graph

    spec, scope, feeds, _ = _serve_world(card)
    gen = decode.Generator(spec, scope=scope, place=card)
    feed = {k: np.concatenate([f[k] for f in feeds[:4]]) for k in feeds[0]}
    _, states, lengths, logits = gen._prefill(feed)
    tok = torch.argmax(logits, -1).cpu().numpy()
    cuda_graph.reset_stats()
    outs, counts = [], []
    for _ in range(3):
        before = (mha_block.launches, fd.launches)
        logits, states = gen._step(tok, lengths, states, feed)
        outs.append(logits.clone())
        counts.append((mha_block.launches - before[0],
                       fd.launches - before[1]))
    torch.cuda.synchronize()
    assert cuda_graph.STATS["warmups"] == 1
    assert cuda_graph.STATS["captures"] == 1
    assert cuda_graph.STATS["replays"] == 1
    assert counts[0] == counts[1] == counts[2] and sum(counts[0]) > 0
    for o in outs[1:]:
        assert (o - outs[0]).abs().max().item() <= 1e-6


def test_a_new_tensor_every_call_is_copied_into_the_graph(card):
    """The step's caches passed as a new tensor at every call (clones):
    the capture binds none of them but copies each into the graph's own
    buffer, so the graph still replays (one capture, then replays), the
    logits equal the eager warm-up's within 1e-6 and the returned caches
    hold the appended row, as the eager call's do."""
    from paddle_tpu_torch import decode
    from paddle_tpu_torch.framework import cuda_graph

    spec, scope, feeds, _ = _serve_world(card)
    gen = decode.Generator(spec, scope=scope, place=card)
    feed = {k: np.concatenate([f[k] for f in feeds[:2]]) for k in feeds[0]}
    _, states, lengths, logits = gen._prefill(feed)
    tok = torch.argmax(logits, -1).cpu().numpy()
    base = {k: v.clone() for k, v in states.items()}
    cuda_graph.reset_stats()
    outs = []
    for _ in range(4):
        fresh = {k: v.clone() for k, v in base.items()}
        logits, new = gen._step(tok, lengths, fresh, feed)
        outs.append((logits.clone(), {k: v.clone() for k, v in new.items()}))
    torch.cuda.synchronize()
    assert cuda_graph.STATS["captures"] == 1
    assert cuda_graph.STATS["replays"] == 2
    for logits, new in outs[1:]:
        assert (logits - outs[0][0]).abs().max().item() <= 1e-6
        for k, v in new.items():
            assert (v - outs[0][1][k]).abs().max().item() <= 1e-6, k


def test_moved_pool_storage_is_captured_again(card):
    """Mid-flight, every pool stream moves to a new storage: the paged
    step's graph over the old pool is never replayed (its signature holds
    the old addresses), the step runs eagerly, is captured again over the
    new pool, and every request's tokens still equal the sequential
    Generator's."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework import cuda_graph

    spec, scope, feeds, refs = _serve_world(card)
    sched = serving.Scheduler(spec, scope, place=card, max_batch=8,
                              block_size=16, paged_kv=True)
    reqs = [sched.submit(f, SERVE_MNT, eos_id=-1) for f in feeds]
    for _ in range(5):
        sched.step()
    captured = cuda_graph.STATS["captures"]
    assert captured >= 1
    for name in list(sched.pool._streams):
        sched.pool._streams[name] = sched.pool._streams[name].clone()
    sched.run_until_idle(max_steps=500)
    assert cuda_graph.STATS["captures"] > captured
    _served(reqs, refs)
    sched.pool.assert_quiesced()


def test_replays_add_the_captured_launch_counts(card):
    """A replay runs no Python, so it adds the launch and tier counts its
    capture recorded: n steps count n times one eager step's."""
    from paddle_tpu_torch import decode
    from paddle_tpu_torch.ops import attention_ops

    spec, scope, feeds, _ = _serve_world(card)
    gen = decode.Generator(spec, scope=scope, place=card)
    feed = feeds[0]
    _, states, lengths, logits = gen._prefill(feed)
    tok = torch.argmax(logits, -1).cpu().numpy()
    per_step = None
    for i in range(6):
        before = (mha_block.launches, fd.launches,
                  dict(attention_ops.TIER_CALLS))
        logits, states = gen._step(tok, lengths, states, feed)
        lengths = lengths + 1
        tok = torch.argmax(logits, -1).cpu().numpy()
        tiers = {k: v - before[2].get(k, 0)
                 for k, v in attention_ops.TIER_CALLS.items()
                 if v != before[2].get(k, 0)}
        step = (mha_block.launches - before[0], fd.launches - before[1],
                tiers)
        per_step = per_step or step
        assert step == per_step, f"step {i}"
    assert per_step[0] + per_step[1] > 0 and per_step[2]


def test_jit_executor_trains_as_the_interpreter_on_the_card(card):
    """A tiny transformer training program (head_dim 64, float32, Adam):
    4 steps under Executor(mode="jit"), whose step is captured at its
    second run, give the interpreter's losses (rtol 1e-5), from the same
    weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(
        src_vocab_size=64, trg_vocab_size=64, n_layer=1, n_head=2,
        d_model=128, d_inner=256, dropout=0.0, max_length=64)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = transformer.build(cfg, use_src_lens=True)
        pt.optimizer.Adam(1e-3).minimize(loss)
    startup.random_seed = 3
    feeds = [dict(transformer.synthetic_batch(4, cfg, seed=s),
                  src_lens=np.asarray([64, 50, 33, 9], np.int64))
             for s in range(4)]
    losses = {}
    for mode in ("interpret", "jit"):
        scope = pt.Scope()
        pt.Executor(card, mode="interpret").run(startup, scope=scope)
        exe = pt.Executor(card, mode=mode)
        losses[mode] = [float(exe.run(main, feed=f, scope=scope,
                                      fetch_list=[loss])[0].ravel()[0])
                        for f in feeds]
    np.testing.assert_allclose(losses["jit"], losses["interpret"], rtol=1e-5)


def test_jit_executor_captures_dropout_training_as_the_interpreter(card):
    """A tiny transformer at dropout 0.1 (float32, Adam): under
    Executor(mode="jit") its step is captured with the run's generator
    registered (a CUDA graph at the second run, replayed at the third);
    from the same state and run counter its 3 losses and masks equal
    mode="interpret"'s (losses rtol 1e-5, masks exactly), and a mask
    differs from step to step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import cuda_graph
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(
        src_vocab_size=64, trg_vocab_size=64, n_layer=1, n_head=2,
        d_model=128, d_inner=256, dropout=0.1, max_length=64)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = transformer.build(cfg, use_src_lens=True)
        pt.optimizer.Adam(1e-3).minimize(loss)
    mask = next(op.output("Mask")[0] for op in main.global_block().ops
                if op.type == "dropout")
    feed = dict(transformer.synthetic_batch(4, cfg, seed=1),
                src_lens=np.asarray([64, 50, 33, 9], np.int64))
    runs = {}
    for mode in ("interpret", "jit"):
        scope = pt.Scope()
        pt.Executor(card, mode="interpret").run(startup, scope=scope)
        exe = pt.Executor(card, mode=mode)
        cuda_graph.reset_stats()
        runs[mode] = [exe.run(main, feed=feed, scope=scope,
                              fetch_list=[loss, mask]) for _ in range(3)]
        stats = dict(cuda_graph.STATS)
    assert stats["captures"] >= 1 and stats["replays"] >= 1, stats
    np.testing.assert_allclose([r[0].ravel()[0] for r in runs["jit"]],
                               [r[0].ravel()[0] for r in runs["interpret"]],
                               rtol=1e-5)
    for a, b in zip(runs["jit"], runs["interpret"]):
        np.testing.assert_array_equal(a[1], b[1])
    masks = [r[1] for r in runs["jit"]]
    assert not np.array_equal(masks[1], masks[2])
    assert not np.array_equal(masks[0], masks[1])


def test_capture_without_a_registered_generator_raises(card):
    """A draw from a generator the graph did not register fails the
    capture, and the error names the segment (no eager fallback)."""
    from paddle_tpu_torch.framework.cuda_graph import CapturedSegment

    x = torch.ones(64, device=card)
    stray = torch.Generator(device=card)
    stray.manual_seed(0)
    seg = CapturedSegment(lambda rng, a: (a * torch.rand(
        a.shape, generator=stray, device=a.device),), ["x"], ["y"], card,
        label="stray")
    seg(None, x)                     # warm-up, eager
    with pytest.raises(RuntimeError, match="segment stray"):
        seg(None, x)                 # capture


@pytest.mark.parametrize("batch", [8, 32], ids=["b8", "beam4x8"])
@pytest.mark.parametrize("kv", [None, "short"], ids=["all_live", "short"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_decode_at_the_translators_shape(card, batch, kv, dtype):
    """#6 at the GRU translator's decode step: one head of 256 over 24
    encoder keys, less than one key block: a cluster of 2 ranks, rank 1's
    tile half live (warps 2 and 3 of it dead).  With no kv_len every key is
    live; with lengths of 1-16 rank 1 holds no live key, and its partial
    (m = -inf, l = 0) must merge with weight 0, not NaN."""
    from paddle_tpu_torch.ops.cuda.decode_stream import cluster_ranks

    sk, h, d = 24, 1, 256
    assert cluster_ranks(sk) == 2
    q, k, v = _qkv(8, batch, 1, sk, h * d, card, dtype)
    kv_len = None
    if kv == "short":
        kv_len = _lens(np.resize([1, 5, 16, 9, 12, 3, 16, 8], batch), card)
    before = fd.launches
    out = fd.flash_decode(q, k, v, h, 0.0, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    ref = fd.flash_decode_reference(q, k, v, h, 0.0, kv_len=kv_len)
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_jit_executor_trains_stacked_lstm_as_the_interpreter(card):
    """A small stacked-LSTM classifier (2 layers, the second reversed,
    float32, Adam): under Executor(mode="jit") its step (the time loops,
    the generic grads replaying them, reduce_max's tie-splitting grad) is
    captured at its second run and replayed after; its 4 losses equal the
    interpreter's (rtol 1e-5) from the same weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import cuda_graph
    from paddle_tpu_torch.models import stacked_lstm

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = stacked_lstm.build(seq_len=20, dict_size=100, emb_dim=32,
                                  hidden_dim=64, stacked_num=2)[0]
        pt.optimizer.Adam(1e-3).minimize(loss)
    rng = np.random.RandomState(0)
    feeds = [{"words": rng.randint(0, 100, (8, 20)).astype(np.int64),
              "label": rng.randint(0, 2, (8, 1)).astype(np.int64)}
             for _ in range(4)]
    losses = {}
    for mode in ("interpret", "jit"):
        scope = pt.Scope()
        pt.Executor(card, mode="interpret").run(startup, scope=scope)
        exe = pt.Executor(card, mode=mode)
        cuda_graph.reset_stats()
        losses[mode] = [float(exe.run(main, feed=f, scope=scope,
                                      fetch_list=[loss])[0].ravel()[0])
                        for f in feeds]
        stats = dict(cuda_graph.STATS)
    assert stats["captures"] >= 1 and stats["replays"] >= 2, stats
    np.testing.assert_allclose(losses["jit"], losses["interpret"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the saved-model slice: io, the Predictor, the transpiler on the card
# ---------------------------------------------------------------------------


def _resnet8_test_program():
    """cifar ResNet-8's test clone, pruned to its prediction, with its
    startup (batch norms in it: a Predictor transpiles on load)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 1
    with pt.program_guard(main, startup), pt.unique_name.guard():
        _, prediction, _ = resnet.build(dataset="cifar10", depth=8)
    return main.clone(for_test=True)._prune([prediction]), startup, \
        prediction


def _saved_resnet8(tmp_path):
    import paddle_tpu_torch as pt

    test, startup, prediction = _resnet8_test_program()
    d = str(tmp_path / "resnet8")
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        pt.io.save_inference_model(d, ["img"], [prediction], exe,
                                   main_program=test)
    return d


def _images(n, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (n, 3, 32, 32)).astype(np.float32)


def test_predictor_on_the_card_equals_the_cpu(card, tmp_path):
    """The same saved directory in a Predictor on the card (each run a
    replayed graph after the second) and on the CPU: rtol 1e-3 (cuDNN in
    float32 without TF32 sums in other orders)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference

    d = _saved_resnet8(tmp_path)
    on_card = inference.create_predictor(inference.Config(d, place=card))
    on_cpu = inference.create_predictor(inference.Config(
        d, place=pt.CPUPlace()))
    for seed in range(3):
        feed = {"img": _images(4, seed)}
        (got,), (want,) = on_card.run(feed), on_cpu.run(feed)
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max())


def test_bf16_file_loads_onto_the_card(card, tmp_path):
    """A bfloat16 tensor saved by `save` (per var) and `save_combine`
    loads through the Executor on the card, bit for bit."""
    import paddle_tpu_torch as pt

    value = torch.as_tensor(np.random.RandomState(1).standard_normal(
        (5, 7)).astype(np.float32)).to(torch.bfloat16)
    prog = pt.Program()
    prog.global_block().create_var(name="h", shape=(5, 7), dtype="bfloat16",
                                   persistable=True)
    src = pt.Scope()
    src.set_var("h", value)
    for filename in (None, "params"):
        d = str(tmp_path / f"bf16_{filename}")
        with pt.scope_guard(src):
            pt.io.save_persistables(pt.Executor(pt.CPUPlace()), d, prog,
                                    filename)
        dst = pt.Scope()
        with pt.scope_guard(dst):
            pt.io.load_persistables(pt.Executor(card), d, prog, filename)
        got = dst.find_var("h")
        assert got.device.type == "cuda" and got.dtype == torch.bfloat16
        assert torch.equal(got.cpu().view(torch.int16),
                           value.view(torch.int16))


def test_clones_capturing_concurrently_equal_the_sequential_run(card,
                                                                tmp_path):
    """Two clones of a Predictor on the card, each in its own thread, start
    together (a barrier): each warms up, captures and replays its own
    graphs while the other does, 4 runs each; every output equals the base
    predictor's sequential run (rtol 1e-6, atol 1e-7), and each clone
    captured one graph."""
    import threading

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.framework import cuda_graph

    base = inference.create_predictor(inference.Config(
        _saved_resnet8(tmp_path), place=card))
    n_threads, runs = 2, 4
    feeds = [{"img": _images(4, i)} for i in range(n_threads * runs)]
    sequential = [base.run(f)[0] for f in feeds]
    clones = [base.clone() for _ in range(n_threads)]
    results, errors = [None] * len(feeds), []
    barrier = threading.Barrier(n_threads)

    def worker(t, pred):
        try:
            barrier.wait(timeout=60)
            for r in range(runs):
                i = t * runs + r
                results[i] = pred.run(feeds[i])[0]
        except Exception as e:  # surfaced after join
            errors.append((t, e))

    cuda_graph.reset_stats()
    threads = [threading.Thread(target=worker, args=(t, p))
               for t, p in enumerate(clones)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert cuda_graph.STATS["captures"] == n_threads, cuda_graph.STATS
    assert cuda_graph.STATS["replays"] == n_threads * (runs - 2)
    for got, ref in zip(results, sequential):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_transpile_after_a_captured_run_replays_the_folded_weights(card):
    """Run the test program on the jit path until its graph replays, then
    fold its batch norms: the next runs capture the folded program anew
    (the old graph bound the old filters' addresses) and agree with the
    unfolded outputs (rtol 1e-4) and with an eager run of the folded
    program (rtol 1e-6)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import cuda_graph

    test, startup, prediction = _resnet8_test_program()
    scope = pt.Scope()
    pt.Executor(card).run(startup, scope=scope)
    exe = pt.Executor(card)
    feed = {"img": _images(4)}
    cuda_graph.reset_stats()
    before = [exe.run(test, feed=feed, fetch_list=[prediction],
                      scope=scope)[0] for _ in range(3)]
    assert cuda_graph.STATS["captures"] == 1
    assert cuda_graph.STATS["replays"] == 1
    pt.transpiler.InferenceTranspiler().transpile(test, scope=scope)
    assert not any(op.type == "batch_norm" for op in test.global_block().ops)
    after = [exe.run(test, feed=feed, fetch_list=[prediction],
                     scope=scope)[0] for _ in range(3)]
    assert cuda_graph.STATS["captures"] == 2
    assert cuda_graph.STATS["replays"] == 2
    (eager,) = pt.Executor(card, mode="interpret").run(
        test, feed=feed, fetch_list=[prediction], scope=scope)
    for a in after:
        np.testing.assert_allclose(a, before[0], rtol=1e-4,
                                   atol=1e-4 * np.abs(before[0]).max())
        np.testing.assert_allclose(a, eager, rtol=1e-6, atol=1e-7)
