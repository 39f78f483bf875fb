"""The port's attention kernels' plain versions, reference and gate against
the JAX package's.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
the JAX side runs its Pallas kernels in interpret mode, as its own tests
do.  Inputs are numpy arrays made from a seed; tolerance atol 1e-5 in
float32 (two float32 softmax-attention implementations that sum in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import mha_block as jmha
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import attention_ops as pattn
from paddle_tpu_torch.ops.cuda import flash_decode as pfd
from paddle_tpu_torch.ops.cuda import mha_block as pmha

ATOL = 1e-5
GATE_FLAGS = ("flash_attention", "attn_decode_min_keys",
              "attn_vmem_score_budget", "attn_flash_min_scores")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for name in GATE_FLAGS:
        jflags.reset(name)
        pflags.reset(name)


def _set_both(name, value):
    jflags.set(name, value)
    pflags.set(name, value)


def _data(seed, b, sq, sk, hd):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, s, hd)).astype(np.float32)
            for s in (sq, sk, sk)]


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("sq,causal", [(1, False), (8, False), (8, True),
                                       (128, False), (128, True)])
@pytest.mark.parametrize("key_len", [None, [128, 37], [0, 90]],
                         ids=["unmasked", "ragged", "all_masked_row"])
def test_mha_attention_matches_pallas_interpret(sq, causal, key_len):
    b, sk, h, d = 2, 128, 2, 64
    q, k, v = _data(sq + 3 * causal, b, sq, sk, h * d)
    kl = None if key_len is None else np.asarray(key_len, np.int64)
    if sq == 1:
        # the JAX package's mha_decode: q padded to its 8-sublane tile,
        # causal dropped (attention_ops.py:363); the port takes Sq=1 as is
        qp = np.pad(q, ((0, 0), (0, 7), (0, 0)))
        ref = np.asarray(jmha.mha_attention(
            jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v), h, False, 0.0,
            True, key_len=None if kl is None else jnp.asarray(kl)))[:, :1]
    else:
        ref = np.asarray(jmha.mha_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, causal, 0.0,
            True, key_len=None if kl is None else jnp.asarray(kl)))
    out = pmha.mha_attention(_t(q), _t(k), _t(v), h, causal, 0.0,
                             key_len=None if kl is None else _t(kl))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    if key_len is not None and key_len[0] == 0 and not causal:
        # finite -1e30 masking: the all-masked row is the mean of V
        np.testing.assert_allclose(out.numpy()[0],
                                   np.broadcast_to(v[0].mean(0), (sq, h * d)),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("sq,causal,key_len", [
    (1, False, [128, 37]),       # mha_decode, single query
    (1, False, [0, 90]),
    (8, False, [128, 37]),
    (128, False, None),
    (128, True, None),
    (128, True, [0, 90]),        # a key_len-0 image under causal
    (64, True, [300, -3]),       # key_len past Sk, and a negative one
], ids=["decode", "decode_zero", "cross", "self", "causal", "causal_zero",
        "causal_past_negative"])
def test_mha_attention_bf16_matches_pallas_interpret(sq, causal, key_len):
    """bfloat16 inputs: the plain version against the Pallas kernel in
    interpret mode, atol 2e-2 (both round q * scale and the normalised P
    to bfloat16 and sum in float32 in other orders, so the bfloat16
    output can differ by one step, 1.6e-2 at |o| in [2, 4)).  An image
    with key_len <= 0 is the mean of V over every key, under causal too."""
    b, sk, h, d = 2, 128, 2, 64
    q, k, v = (x.astype(jnp.bfloat16).astype(np.float32)
               for x in _data(sq + 11 * causal, b, sq, sk, h * d))
    kl = None if key_len is None else np.asarray(key_len, np.int64)
    qj = np.pad(q, ((0, 0), (0, 7), (0, 0))) if sq == 1 else q
    ref = np.asarray(jmha.mha_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (qj, k, v)), h, causal, 0.0,
        True, key_len=None if kl is None else jnp.asarray(kl))
        .astype(jnp.float32))[:, :sq]
    out = pmha.mha_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                             h, causal, 0.0,
                             key_len=None if kl is None else _t(kl))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2e-2)
    for i in range(b):
        if kl is not None and kl[i] <= 0:
            mean_v = torch.as_tensor(v[i]).to(torch.bfloat16).float().mean(0)
            np.testing.assert_allclose(
                out[i].float().numpy(),
                np.broadcast_to(mean_v.numpy(), (sq, h * d)), rtol=0,
                atol=2e-2)


def _mha_mode_fwd(q, k, v, h, causal, scale, key_len):
    """The card's bf16 mha_block forward as float32 torch: the shared
    forward body in its mha_block mask mode (csrc/flash_fwd_mma.cuh).  An
    image with key_len > 0 sees keys below min(key_len, Sk) and, under
    causal, at or left of the diagonal; an image with key_len <= 0 is
    "uniform": every key live, causal off, every score taken as 0.  The
    first sweep gives each row's lse from its live scores; the second
    forms P = exp(S - lse) on live pairs (0 elsewhere), rounds it to V's
    dtype, and sums P V in float32, with no final division."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // h

    def heads(x, s):
        return x.reshape(b, s, h, d).transpose(1, 2).float()

    qh, kh, vh = heads(q * scale, sq), heads(k, sk), heads(v, sk)
    s = torch.matmul(qh, kh.transpose(-1, -2))            # [B, H, Sq, Sk]
    kl = key_len.reshape(b).float().to(torch.int32)
    uniform = (kl <= 0)[:, None, None, None]
    cols = torch.arange(sk)
    live = (cols < kl.clamp(0, sk)[:, None, None, None]) | uniform
    if causal:
        rows = torch.arange(sq)[:, None] + (sk - sq)
        live = live & ((cols[None, :] <= rows) | uniform)
    s = torch.where(uniform, 0.0, s)
    lse = torch.logsumexp(torch.where(live, s, -torch.inf), -1, keepdim=True)
    p = torch.where(live, torch.exp(s - lse), 0.0).to(v.dtype).float()
    o = torch.matmul(p, vh).to(q.dtype)
    return o.transpose(1, 2).reshape(b, sq, hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,sk", [(1, 100), (40, 100), (100, 100)],
                         ids=["decode", "offset", "square"])
def test_mha_mask_mode_forward_gives_the_plain_output(sq, sk, causal, dtype):
    """The two-sweep forward of the card's bf16 #1 (lse first, then the
    normalised P rounded to V's dtype), written in torch, gives
    mha_reference's output: key_len 0, a negative one, one past Sk and a
    ragged one, with and without causal.  atol 1e-5 in float32; 2e-2 in
    bfloat16 (P = exp(S - lse) and exp(S - m) / l differ in their last
    float32 bits, which can move P's bfloat16 rounding and then the
    output's by one step)."""
    b, h, d = 4, 2, 64
    dt = getattr(torch, dtype)
    q, k, v = (_t(x).to(dt) for x in _data(sq + sk + causal, b, sq, sk,
                                             h * d))
    kl = _t(np.asarray([0, 37, sk + 30, -2], np.float32))
    want = pmha.mha_reference(q, k, v, h, causal, 0.0, key_len=kl)
    got = _mha_mode_fwd(q, k, v, h, causal, d ** -0.5, kl)
    assert got.dtype == want.dtype == dt
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=1e-5 if dtype == "float32"
                               else 2e-2)
    # the key_len <= 0 images are the mean of V over every key
    for i in (0, 3):
        np.testing.assert_allclose(
            want[i].float().numpy(),
            np.broadcast_to(v[i].float().mean(0).numpy(), (sq, h * d)),
            rtol=0, atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("sk", [200, 256, 300])
@pytest.mark.parametrize("kv_len", [None, [200, 0, 17]],
                         ids=["unmasked", "ragged_with_zero"])
def test_flash_decode_matches_pallas_interpret(sk, kv_len):
    b, h, d = 3, 2, 64
    q, k, v = _data(sk, b, 1, sk, h * d)
    kl = None if kv_len is None else np.asarray(kv_len, np.int64)
    ref = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, 0.0, True,
        kv_len=None if kl is None else jnp.asarray(kl)))
    out = pfd.flash_decode(_t(q), _t(k), _t(v), h, 0.0,
                           kv_len=None if kl is None else _t(kl))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    if kv_len is not None:
        assert not out.numpy()[1].any()   # kv_len 0 gives 0, not mean(V)


def test_flash_decode_clamps_kv_len_to_the_cache():
    """kv_len past Sk means every cached key is live, as in the composite.
    (The JAX kernel differs here when Sk is not a multiple of its key
    block: its zero padding keys count as live, ROADMAP.md C.)"""
    b, h, d, sk = 2, 1, 64, 200
    q, k, v = _data(22, b, 1, sk, h * d)
    kl = np.asarray([250, 200], np.int64)
    ref = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jattn._seq_len_bias(jnp.asarray(kl), b, sk), num_heads=h,
        causal=False, scale=0.0))
    out = pfd.flash_decode(_t(q), _t(k), _t(v), h, kv_len=_t(kl))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_flash_decode_scale_and_head_dim_128():
    b, h, d, sk = 2, 2, 128, 130
    q, k, v = _data(21, b, 1, sk, h * d)
    kl = np.asarray([130, 64], np.int64)
    ref = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, 0.3, True,
        kv_len=jnp.asarray(kl)))
    out = pfd.flash_decode(_t(q), _t(k), _t(v), h, 0.3, kv_len=_t(kl))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal,bias,scale", [
    (False, False, 0.0), (True, False, 0.0), (True, True, 0.25),
    (False, True, 0.0),
])
def test_attention_reference_matches(causal, bias, scale):
    b, sq, sk, h, d = 2, 5, 9, 3, 8
    q, k, v = _data(30, b, sq, sk, h * d)
    bb = (np.random.RandomState(31).standard_normal((b, 1, sq, sk))
          .astype(np.float32) if bias else None)
    ref = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bb is None else jnp.asarray(bb), num_heads=h, causal=causal,
        scale=scale))
    out = pattn.attention_reference(
        _t(q), _t(k), _t(v), None if bb is None else _t(bb), num_heads=h,
        causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_seq_len_bias_matches():
    lens = np.asarray([3, 0, 7], np.int64)
    ref = np.asarray(jattn._seq_len_bias(jnp.asarray(lens), 3, 7))
    out = pattn._seq_len_bias(_t(lens), 3, 7)
    np.testing.assert_array_equal(out.numpy(), ref)


# (q shape, k shape, heads, causal, bias, seq_len)
_GATE_SHAPES = [
    ((8, 256, 512), (8, 256, 512), 8, False, False, True),   # encoder
    ((8, 1024, 512), (8, 1024, 512), 8, True, False, False),  # long prefix
    ((8, 2048, 512), (8, 2048, 512), 8, True, False, False),  # tile too big
    ((8, 8, 512), (8, 8, 512), 8, True, False, False),       # short prefix
    ((8, 8, 512), (8, 256, 512), 8, False, False, True),     # cross
    ((8, 1, 512), (8, 256, 512), 8, False, False, True),     # decode, short
    ((8, 1, 512), (8, 2048, 512), 8, False, False, True),    # decode, long
    ((8, 1, 512), (8, 200, 512), 8, False, False, True),     # unaligned
    ((2, 1, 64), (2, 16, 64), 4, False, False, True),        # head_dim 16
    ((2, 128, 128), (2, 128, 128), 2, False, True, False),   # additive bias
    ((2, 128, 128), (2, 128, 128), 1, False, False, False),  # head_dim 128
    ((2, 16, 128), (2, 8, 128), 2, True, False, False),      # Sq > Sk
]


@pytest.mark.parametrize("flag", ["auto", "interpret", "0", "flash",
                                  "force"])
@pytest.mark.parametrize("min_keys", [None, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backend_choice_agrees(flag, min_keys, dtype):
    """Same shapes, same flags -> the same tier name in both packages.
    Off the accelerator ("auto" on the CPU) both say composite."""
    if flag != "auto":
        _set_both("flash_attention", flag)
    if min_keys is not None:
        _set_both("attn_decode_min_keys", min_keys)
    for qs, ks, h, causal, bias, seq_len in _GATE_SHAPES:
        jq = jax.ShapeDtypeStruct(qs, jnp.dtype(dtype))
        jk = jax.ShapeDtypeStruct(ks, jnp.dtype(dtype))
        tdt = getattr(torch, dtype)
        pq = torch.empty(qs, dtype=tdt, device="meta")
        pk = torch.empty(ks, dtype=tdt, device="meta")
        j = jattn.backend_choice(jq, jk, h, causal, bias, seq_len)
        p = pattn.backend_choice(pq, pk, h, causal, bias, seq_len)
        assert p == j, (qs, ks, h, causal, bias, seq_len, flag, p, j)


def test_gate_routes_card_tensors_to_the_kernels():
    """A tensor on the card takes the kernel tiers under the default gate
    (checked on meta tensors standing in for the device: the gate reads
    shape, dtype and device type only)."""
    class _Card:
        def __init__(self, shape):
            self.shape = shape
            self.dtype = torch.float32
            self.device = torch.device("cuda", 0)

    choose = pattn._backend_choice
    assert choose(_Card((8, 256, 512)), _Card((8, 256, 512)), 8, False,
                  False, True) == ("mha_block", "cuda")
    assert choose(_Card((8, 1, 512)), _Card((8, 256, 512)), 8, False,
                  False, True) == ("mha_decode", "cuda")
    assert choose(_Card((8, 1, 512)), _Card((8, 2048, 512)), 8, False,
                  False, True) == ("flash_decode", "cuda")
    assert choose(_Card((8, 8, 512)), _Card((8, 8, 512)), 8, True,
                  False, False) == ("composite", None)


def test_unported_tiers_raise():
    """The flash tier's forward is ported (kernel #3, tests/
    test_torch_flash.py), and so is the seq_len_ramp window: in the dense
    and the paged form it takes the composite under the ramp bias, as the
    JAX package's does (atol 1e-5), under "interpret" too, and no kernel
    tier is counted for it."""
    _set_both("flash_attention", "interpret")
    q = torch.zeros((1, 8, 128))
    out = pattn._apply_attention(q, q, q, None, num_heads=2, causal=True,
                                 scale=0.0)
    assert out.shape == q.shape
    qn, kn, vn = _data(80, 2, 4, 128, 128)
    lens = np.asarray([1, 120], np.int64)
    pattn.TIER_CALLS.clear()
    got = pattn._apply_attention(_t(qn), _t(kn), _t(vn), None, num_heads=2,
                                 causal=False, scale=0.0, seq_len=_t(lens),
                                 seq_len_ramp=True)
    assert dict(pattn.TIER_CALLS) == {"composite": 1}
    want = jattn._apply_attention(jnp.asarray(qn), jnp.asarray(kn),
                                  jnp.asarray(vn), None, num_heads=2,
                                  causal=False, scale=0.0,
                                  seq_len=jnp.asarray(lens),
                                  seq_len_ramp=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    rng = np.random.RandomState(81)
    kb, vb = (rng.standard_normal((12, 16, 128)).astype(np.float32)
              for _ in range(2))
    table = np.asarray([[3, 0, 7, 1], [11, 2, 5, 9]], np.int64)
    got = pattn._apply_attention_paged(
        _t(qn), _t(kb), _t(vb), _t(table), _t(lens), num_heads=2, scale=0.0,
        max_len=60, seq_len_ramp=True)
    assert pattn.TIER_CALLS["paged_reference"] == 1
    want = jattn._apply_attention_paged(
        jnp.asarray(qn), jnp.asarray(kb), jnp.asarray(vb), table,
        jnp.asarray(lens), num_heads=2, scale=0.0, max_len=60,
        seq_len_ramp=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_meta_tensors_never_reach_a_kernel_wrapper():
    pflags.set("flash_attention", "interpret")
    before = dict(pattn.TIER_CALLS)
    q = torch.empty((8, 256, 512), device="meta")
    out = pattn._apply_attention(q, q, q, None, num_heads=8, causal=False,
                                 scale=0.0)
    assert out.shape == (8, 256, 512) and out.device.type == "meta"
    assert dict(pattn.TIER_CALLS) == before


# ------------------------------------------------------------- backward


def _jax_vjp(q, k, v, g, h, causal, scale, kl, dtype):
    jdt = jnp.dtype(dtype)

    def f(q, k, v):
        return jmha.mha_attention(
            q, k, v, h, causal, scale, True,
            key_len=None if kl is None else jnp.asarray(kl))

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(g, jdt))]


@pytest.mark.parametrize("sq,sk,causal", [(128, 128, False), (128, 128, True),
                                          (8, 256, False), (64, 128, True)],
                         ids=["self", "causal", "cross", "causal_offset"])
@pytest.mark.parametrize("key_len", [None, [128, 37], [0, 300]],
                         ids=["unmasked", "ragged", "zero_and_past_sk"])
@pytest.mark.parametrize("d", [64, 128])
def test_mha_block_bwd_matches_pallas_vjp(sq, sk, causal, key_len, d):
    """Kernel #2's plain version against jax.vjp of the Pallas kernel in
    interpret mode, float32, atol 1e-5.  A row with key_len 0 has P = 1/Sk
    over every key and, as in the Pallas kernel, passes dS to all of them."""
    b, h = 2, 2
    q, k, v = _data(sq + d + 5 * causal, b, sq, sk, h * d)
    g = np.random.RandomState(sk).standard_normal(q.shape).astype(np.float32)
    kl = None if key_len is None else np.asarray(key_len, np.int64)
    ref = _jax_vjp(q, k, v, g, h, causal, 0.0, kl, "float32")
    out = pmha.mha_block_bwd(_t(q), _t(k), _t(v), _t(g), h, causal, 0.0,
                             key_len=None if kl is None else _t(kl))
    for name, r, o in zip(("dq", "dk", "dv"), ref, out):
        assert o.shape == r.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=ATOL,
                                   err_msg=name)


def test_mha_block_bwd_bf16_and_scale():
    """bfloat16 inputs, an explicit scale: within 2e-2 of each output's
    largest magnitude of the Pallas vjp (one bfloat16 step at that
    magnitude is 2**-7 of it; the Pallas kernel rounds dS and P to
    bfloat16 before its dots, the plain version keeps them in float32)."""
    b, sq, sk, h, d = 2, 128, 128, 2, 64
    q, k, v = _data(40, b, sq, sk, h * d)
    g = np.random.RandomState(41).standard_normal(q.shape).astype(np.float32)
    kl = np.asarray([128, 37], np.int64)
    ref = _jax_vjp(q, k, v, g, h, True, 0.2, kl, "bfloat16")
    out = pmha.mha_block_bwd(*(_t(x).to(torch.bfloat16) for x in (q, k, v, g)),
                             h, True, 0.2, key_len=_t(kl))
    for r, o in zip(ref, out):
        assert o.dtype == torch.bfloat16
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0,
                                   atol=2e-2 * np.abs(r).max())


@pytest.mark.parametrize("sq,sk,causal,key_len,d", [
    (1, 65, False, [1, 63], 64),     # one row; one key past a 64-key tile
    (17, 65, True, [0, 63], 64),     # a key_len-0 image under causal
    (17, 130, False, [1, 63], 128),  # one row past an mma tile
    (33, 130, True, [0, 130], 64),
    (65, 130, True, [129, 0], 128),
], ids=["sq1_sk65", "sq17_causal_zero", "sq17_sk130_d128",
        "sq33_causal_zero", "sq65_causal_zero_d128"])
def test_mha_block_bwd_bf16_tile_edges_match_pallas_vjp(sq, sk, causal,
                                                         key_len, d):
    """bfloat16 at the tile edges of the card's tensor-core kernels (64-row
    q tiles, 32- and 64-key tiles): the plain version against jax.vjp of
    the Pallas kernel in interpret mode, within 2e-2 of each grad's
    largest magnitude (the Pallas kernel rounds dS and P to bfloat16
    before its dots, the plain version keeps them in float32).  A key_len-0
    image has P = 1/Sk over every key, those right of the causal diagonal
    too, in both."""
    b, h = 2, 2
    q, k, v = _data(sq + sk + d, b, sq, sk, h * d)
    g = np.random.RandomState(sq).standard_normal(q.shape).astype(np.float32)
    kl = np.asarray(key_len, np.int64)
    ref = _jax_vjp(q, k, v, g, h, causal, 0.0, kl, "bfloat16")
    out = pmha.mha_block_bwd(*(_t(x).to(torch.bfloat16) for x in (q, k, v, g)),
                             h, causal, 0.0, key_len=_t(kl))
    for name, r, o in zip(("dq", "dk", "dv"), ref, out):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape, name
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0,
                                   atol=2e-2 * np.abs(r).max(), err_msg=name)


def _mha_mode_bwd(q, k, v, dout, h, causal, scale, key_len):
    """The card's bf16 mha_block backward in float32 torch: the shared
    flash backward bodies in their mha_block mask mode
    (csrc/flash_bwd_mma.cuh).  An image with key_len > 0 sees keys below
    min(key_len, Sk) and, under causal, at or left of the diagonal; an
    image with key_len <= 0 is "uniform": every key live, causal off,
    every score taken as 0.  lse and delta come from the live scores as
    the statistics kernel makes them, then P = exp(S - lse) on live pairs
    (0 elsewhere) and the flash products."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // h

    def heads(x, s):
        return x.reshape(b, s, h, d).transpose(1, 2)

    qh, kh, vh, doh = heads(q * scale, sq), heads(k, sk), heads(v, sk), \
        heads(dout, sq)
    s = torch.matmul(qh, kh.transpose(-1, -2))            # [B, H, Sq, Sk]
    kl = key_len.reshape(b).float().to(torch.int32)
    uniform = (kl <= 0)[:, None, None, None]
    cols = torch.arange(sk)
    live = (cols < kl.clamp(0, sk)[:, None, None, None]) | uniform
    if causal:
        rows = torch.arange(sq)[:, None] + (sk - sq)
        live = live & ((cols[None, :] <= rows) | uniform)
    s = torch.where(uniform, 0.0, s)
    lse = torch.logsumexp(torch.where(live, s, -torch.inf), -1, keepdim=True)
    p = torch.where(live, torch.exp(s - lse), 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    grads = (torch.matmul(ds, kh) * scale, torch.matmul(ds.transpose(-1, -2), qh),
             torch.matmul(p.transpose(-1, -2), doh))
    return [x.transpose(1, 2).reshape(b, -1, hd) for x in grads]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,sk", [(40, 100), (100, 100)],
                         ids=["offset", "square"])
def test_mha_mask_mode_gives_the_plain_grads(sq, sk, causal):
    """The card's bf16 #2 reuses #4/#5's bodies with a mask mode (scores 0
    and lse = log Sk for a key_len <= 0 image, every key live, causal off;
    key_len past Sk leaves every key live): that mode, written in float32
    torch, gives mha_block_bwd_reference's grads within 1e-5, key_len 0,
    a negative one, one past Sk and a ragged one included."""
    b, h, d = 4, 2, 64
    q, k, v = (_t(x) for x in _data(sq + sk, b, sq, sk, h * d))
    g = _t(np.random.RandomState(7).standard_normal(q.shape)
           .astype(np.float32))
    kl = _t(np.asarray([0, 37, sk + 30, -2], np.float32))
    want = pmha.mha_block_bwd_reference(q, k, v, g, h, causal, 0.0,
                                        key_len=kl)
    got = _mha_mode_bwd(q, k, v, g, h, causal, d ** -0.5, kl)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)
    # the all-masked images pass a gradient to every key
    for t in want[1:]:
        assert bool((t[[0, 3]].abs().amax(-1) > 0).all())


def test_mha_block_function_backward_is_the_bwd_entry():
    """MHABlockFunction (forward kernel, backward kernel) against autograd
    over the plain forward, on the CPU: the same gradients."""
    b, sq, sk, h, d = 2, 64, 128, 2, 64
    q, k, v = _data(50, b, sq, sk, h * d)
    g = _t(np.random.RandomState(51).standard_normal((b, sq, h * d))
           .astype(np.float32))
    kl = _t(np.asarray([128, 70], np.int64))
    got, want = [], []
    for fn, into in ((pmha.mha_attention, got), (pmha.mha_reference, want)):
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, h, True, 0.0, key_len=kl)
        into.extend(torch.autograd.grad(out, leaves, g))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=ATOL)


def _grad_op(reg, backend, inputs, attrs):
    """fused_attention_grad through a package's registry."""
    info = reg.get_runtime_info("fused_attention_grad")
    out_names = {p + "@GRAD": [p.lower() + "@GRAD"]
                 for p in ("Q", "K", "V", "Bias") if p in inputs}
    if backend == "jax":
        ins = {p: [jnp.asarray(a) for a in lst] for p, lst in inputs.items()}
        outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names)
        return {p: np.asarray(v[0]) for p, v in outs.items()}
    ins = {p: [_t(a) for a in lst] for p, lst in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names,
                           device=torch.device("cpu"))
    return {p: v[0].numpy() for p, v in outs.items()}


@pytest.mark.parametrize("flag", ["0", "interpret"],
                         ids=["composite", "mha_block"])
@pytest.mark.parametrize("causal,seq_len,bias", [
    (False, True, False), (True, False, False), (True, True, False),
    (False, False, True), (False, "ramp", False), (False, "ramp", True),
], ids=["seq_len", "causal", "causal_seq_len", "bias", "ramp", "ramp_bias"])
def test_fused_attention_grad_matches(flag, causal, seq_len, bias):
    """The op-level grad lowering in both packages, same tier, atol 1e-5:
    autograd over attention_reference against jax.vjp of the composite
    ("0"), and the backward kernel's plain version against the Pallas
    backward ("interpret"; a bias or a seq_len_ramp window sends both to
    the composite)."""
    _set_both("flash_attention", flag)
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as preg

    b, sq, sk, h, d = 2, 8, 128, 2, 64
    q, k, v = _data(60, b, sq, sk, h * d)
    rng = np.random.RandomState(61)
    inputs = {"Q": [q], "K": [k], "V": [v],
              "Out@GRAD": [rng.standard_normal(q.shape).astype(np.float32)]}
    if seq_len:
        inputs["SeqLen"] = [np.asarray([100, 3], np.int64)]
    if bias:
        inputs["Bias"] = [rng.standard_normal((b, 1, sq, sk))
                          .astype(np.float32)]
    attrs = {"num_heads": h, "causal": causal, "scale": 0.0}
    if seq_len == "ramp":
        attrs["seq_len_ramp"] = True
    j = _grad_op(jreg, "jax", inputs, attrs)
    p = _grad_op(preg, "torch", inputs, attrs)
    assert sorted(p) == sorted(j)
    for name in j:
        np.testing.assert_allclose(p[name], j[name], rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("tier", ["flash", "flash_decode"])
def test_grad_of_unported_tiers_raises(tier):
    """Neither tier's grad raises any more: the flash tier's (kernels #4
    and #5, at Sk 8 under "interpret") and the flash_decode tier's (the
    composite with the kv_len bias, ROADMAP C11) equal the JAX grad op."""
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as preg

    _set_both("flash_attention", "interpret")
    sq = 8 if tier == "flash" else 1     # Sk 8: off mha_block's grid
    q, k, v = _data(70, 1, sq, 8, 128)
    g = np.random.RandomState(71).standard_normal(q.shape).astype(np.float32)
    inputs = {"Q": [q], "K": [k], "V": [v], "Out@GRAD": [g]}
    attrs = {"num_heads": 2, "causal": True, "scale": 0.0}
    assert pattn.backend_choice(*(torch.empty(x.shape, device="meta")
                                  for x in (q, k)), 2, True) == tier
    j = _grad_op(jreg, "jax", inputs, attrs)
    p = _grad_op(preg, "torch", inputs, attrs)
    assert sorted(p) == sorted(j) == ["K@GRAD", "Q@GRAD", "V@GRAD"]
    for name in j:
        np.testing.assert_allclose(p[name], j[name], rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("kv_len", [None, (256, 131, 300)])
def test_flash_decode_grad_matches_jax(kv_len):
    """ROADMAP C11: the grad through the flash_decode tier (Sq = 1, a
    256-key cache past attn_decode_min_keys 200, under "interpret") equals
    the JAX rule's pull-back through the composite with the kv_len bias
    (flash_attention.py:_decode_bwd_rule), rtol 1e-4; a kv_len past the
    cache counts every key, as the port's forward clamps it."""
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as preg

    _set_both("flash_attention", "interpret")
    _set_both("attn_decode_min_keys", 200)
    b, sk, h, d = 3, 256, 2, 64
    q, k, v = _data(72, b, 1, sk, h * d)
    rng = np.random.RandomState(73)
    g = rng.standard_normal(q.shape).astype(np.float32)
    inputs = {"Q": [q], "K": [k], "V": [v], "Out@GRAD": [g]}
    if kv_len is not None:
        inputs["SeqLen"] = [np.asarray(kv_len, np.int64)]
    attrs = {"num_heads": h, "causal": False, "scale": 0.0}
    assert pattn.backend_choice(
        *(torch.empty(x.shape, device="meta") for x in (q, k)), h,
        seq_len=kv_len is not None) == "flash_decode"
    j = _grad_op(jreg, "jax", inputs, attrs)
    p = _grad_op(preg, "torch", inputs, attrs)
    assert sorted(p) == sorted(j) == ["K@GRAD", "Q@GRAD", "V@GRAD"]
    for name in j:
        np.testing.assert_allclose(p[name], j[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
