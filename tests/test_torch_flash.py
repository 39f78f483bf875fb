"""Kernel #3's forward (the streaming flash tier): the port's plain version
against the JAX package's Pallas kernel in interpret mode, and the gate
that sends windows to it.

Inputs are numpy arrays made from a seed.  out and lse are held to atol
1e-5 in float32 (two online-softmax orders over float32 scores) and out to
2e-2 in bfloat16 (the Pallas kernel rounds each tile's unnormalised P to
bfloat16 against its running max, the plain version against the row's
final max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import attention_ops as pattn
from paddle_tpu_torch.ops.cuda import flash_attention as pfa

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


def _data(seed, b, sq, sk, hd):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, s, hd)).astype(np.float32)
            for s in (sq, sk, sk)]


def _both(q, k, v, h, causal, kl, dtype="float32", scale=0.0):
    jdt = jnp.dtype(dtype)
    jo, jl = jfa.flash_attention_lse(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), h, causal, scale, True,
        kv_len=None if kl is None else jnp.asarray(kl))
    tdt = getattr(torch, dtype)
    po, pl = pfa.flash_attention_lse(
        *(torch.as_tensor(x).to(tdt) for x in (q, k, v)), h, causal, scale,
        kv_len=None if kl is None else torch.as_tensor(kl))
    return (np.asarray(jo.astype(jnp.float32)), np.asarray(jl),
            po.float().numpy(), pl.numpy())


@pytest.mark.parametrize("b,sq,sk,h,d,causal,kv_len", [
    (2, 128, 128, 2, 64, True, None),          # causal, Sq == Sk
    (2, 64, 192, 2, 64, True, None),           # causal offset, Sq < Sk
    (2, 96, 160, 2, 64, False, None),          # non-causal
    (3, 128, 256, 2, 64, False, [256, 100, 7]),  # ragged kv_len
    (2, 200, 200, 1, 128, True, [200, 133]),   # S = 200: off the 128 grid
    (2, 128, 128, 2, 64, True, [0, 90]),       # a row with no live key
], ids=["causal", "causal_offset", "noncausal", "ragged", "s200",
        "zero_row"])
def test_flash_fwd_matches_pallas_interpret(b, sq, sk, h, d, causal, kv_len):
    q, k, v = _data(sq + sk, b, sq, sk, h * d)
    kl = None if kv_len is None else np.asarray(kv_len, np.int64)
    jo, jl, po, pl = _both(q, k, v, h, causal, kl)
    assert po.shape == jo.shape and pl.shape == jl.shape == (b, h, sq)
    np.testing.assert_allclose(po, jo, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=ATOL)
    if kv_len is not None and kv_len[0] == 0:
        # the (out, lse) merge identity, not mha_block's mean of V
        assert not po[0].any()
        assert (pl[0] == -1e30).all()


def test_flash_fwd_bf16_and_scale():
    b, sq, sk, h, d = 2, 128, 256, 2, 64
    q, k, v = _data(5, b, sq, sk, h * d)
    kl = np.asarray([256, 150], np.int64)
    jo, jl, po, pl = _both(q, k, v, h, True, kl, "bfloat16", scale=0.2)
    np.testing.assert_allclose(po, jo, rtol=0, atol=2e-2)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=2e-2)


# the bf16 kernels' tile edges (16-row mma tiles, 64- or 32-key tiles):
# (b, sq, sk, heads, head_dim, causal, kv_len)
BF16_EDGES = {
    "sq1_sk65": (2, 1, 65, 2, 64, False, None),
    "sq17_sk65_causal_d128": (2, 17, 65, 2, 128, True, None),
    "kv_len_1_63": (2, 40, 100, 2, 64, False, [1, 63]),
    "kv_len_1_63_d192": (2, 33, 70, 1, 192, False, [1, 63]),
    "causal_16x80": (2, 16, 80, 2, 64, True, None),
    "causal_16x80_d256": (2, 16, 80, 1, 256, True, [80, 63]),
}


@pytest.mark.parametrize("case", list(BF16_EDGES))
def test_flash_fwd_bf16_tile_edges_match_pallas_interpret(case):
    """bf16 at the shapes where the card's kernel crosses its tile edges:
    the plain version the CPU runs against the Pallas kernel (bf16 rounds
    P and the output at other points there: 2e-2)."""
    b, sq, sk, h, d, causal, kv_len = BF16_EDGES[case]
    q, k, v = _data(sq * sk, b, sq, sk, h * d)
    kl = None if kv_len is None else np.asarray(kv_len, np.int64)
    jo, jl, po, pl = _both(q, k, v, h, causal, kl, "bfloat16")
    assert po.shape == jo.shape and pl.shape == jl.shape == (b, h, sq)
    np.testing.assert_allclose(po, jo, rtol=0, atol=2e-2)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=2e-2)


def test_kernel_library_is_keyed_by_its_headers(tmp_path, monkeypatch):
    """A source's library name hashes every csrc header it includes, so an
    edited header (flash_mma.cuh, shared by #2-#5, or flash_bwd_mma.cuh,
    which includes it, shared by #2, #4 and #5) builds anew."""
    from paddle_tpu_torch.ops.cuda import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <math.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._source_files("k")] == \
        ["k.cu", "a.cuh", "b.cuh"]
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.lib_path("k")
    assert second != first and second.name.startswith("k-")
    monkeypatch.undo()
    for name in ("flash_attention_bwd", "mha_block_bwd"):
        assert [p.name for p in _build._source_files(name)] == \
            [f"{name}.cu", "flash_bwd_mma.cuh", "flash_mma.cuh"]


def test_flash_fwd_clamps_kv_len_to_sk():
    """kv_len past Sk means every key is live, as in the composite.  The
    JAX kernel pads Sk to its block grid and counts the zero padding keys
    as live there (ROADMAP.md C6), so the comparison is with the
    composite."""
    b, sq, sk, h, d = 2, 40, 200, 2, 64
    q, k, v = _data(7, b, sq, sk, h * d)
    kl = np.asarray([260, 200], np.int64)
    ref = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jattn._seq_len_bias(jnp.asarray(kl), b, sk), num_heads=h,
        causal=False, scale=0.0))
    out = pfa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), h,
                              kv_len=torch.as_tensor(kl))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_flash_tier_runs_in_the_op():
    """The fused_attention forward takes the flash tier where the gate
    sends it (a 200-token causal window under "interpret") and equals the
    composite."""
    pflags.set("flash_attention", "interpret")
    b, s, h, d = 2, 200, 2, 64
    q, k, v = (torch.as_tensor(x) for x in _data(9, b, s, s, h * d))
    pattn.TIER_CALLS.clear()
    out = pattn._apply_attention(q, k, v, None, num_heads=h, causal=True,
                                 scale=0.0)
    assert dict(pattn.TIER_CALLS) == {"flash": 1}
    ref = pattn.attention_reference(q, k, v, None, num_heads=h, causal=True,
                                    scale=0.0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=ATOL)


# (q shape, k shape, heads, causal, seq_len): windows around the flash
# tier at transformer-base widths and at the tests' head_dim-64 widths
_FLASH_GATE_SHAPES = [
    ((8, 1000, 512), (8, 1000, 512), 8, True, False),    # off-grid prompt
    ((8, 2048, 512), (8, 2048, 512), 8, True, False),    # long prompt
    ((8, 1024, 512), (8, 1024, 512), 8, True, False),    # still mha_block
    ((8, 2048, 512), (8, 256, 512), 8, False, True),     # its cross-attn
    ((8, 4096, 512), (8, 4096, 512), 8, False, True),
    ((2, 200, 128), (2, 200, 128), 2, True, False),      # the tests' window
    ((2, 128, 128), (2, 128, 128), 2, True, False),
    ((2, 16, 128), (2, 8, 128), 2, True, False),         # Sq > Sk
    ((2, 300, 64), (2, 300, 64), 4, True, False),        # head_dim 16
]


@pytest.mark.parametrize("flag", ["auto", "interpret", "0", "flash",
                                  "force"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gate_agrees(flag, dtype):
    """Same shapes, same flags -> the same tier name in both packages (on
    meta tensors; the gate reads shape, dtype and device only)."""
    if flag != "auto":
        jflags.set("flash_attention", flag)
        pflags.set("flash_attention", flag)
    for qs, ks, h, causal, seq_len in _FLASH_GATE_SHAPES:
        jq = jax.ShapeDtypeStruct(qs, jnp.dtype(dtype))
        jk = jax.ShapeDtypeStruct(ks, jnp.dtype(dtype))
        pq = torch.empty(qs, dtype=getattr(torch, dtype), device="meta")
        pk = torch.empty(ks, dtype=getattr(torch, dtype), device="meta")
        j = jattn.backend_choice(jq, jk, h, causal, False, seq_len)
        p = pattn.backend_choice(pq, pk, h, causal, False, seq_len)
        assert p == j, (qs, ks, h, causal, seq_len, flag, p, j)


def test_long_windows_take_the_flash_kernel_on_the_card():
    """A tensor on the card: the 1000- and 2048-token causal prompt windows
    of transformer-base go to the flash kernel, 1024 stays on mha_block."""
    class _Card:
        def __init__(self, shape):
            self.shape = shape
            self.dtype = torch.float32
            self.device = torch.device("cuda", 0)

    choose = pattn._backend_choice
    for s, tier in ((1000, "flash"), (2048, "flash"), (1024, "mha_block")):
        assert choose(_Card((8, s, 512)), _Card((8, s, 512)), 8, True,
                      False, False) == (tier, "cuda"), s
