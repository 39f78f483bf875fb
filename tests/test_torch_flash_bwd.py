"""Kernels #4 and #5 (the streaming flash tier's backward): the port's
plain version, `flash_attention_bwd` and `FlashAttentionFunction`,
against `jax.vjp` of the JAX package's `flash_attention_lse` in interpret
mode (its Pallas backward kernels), and the fused_attention grad op in the
flash tier against the JAX package's.

Inputs and both cotangents (of out and of lse) are numpy arrays made from
a seed.  Tolerances: atol 1e-5 in float32 (two float32 implementations
that sum in other orders); in bfloat16, 2e-2 of each output's largest
magnitude (the two forwards round P to bfloat16 against different maxima,
so out, and with it delta, differ in the last bfloat16 bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import attention_ops as pattn
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.ops.cuda import flash_attention as pfa

ATOL = 1e-5
GATE_FLAGS = ("flash_attention", "attn_decode_min_keys")

# (b, sq, sk, h, d, causal, kv_len): tests/test_torch_flash.py's forward
# cases
CASES = {
    "causal": (2, 128, 128, 2, 64, True, None),
    "causal_offset": (2, 64, 192, 2, 64, True, None),
    "noncausal": (2, 96, 160, 2, 64, False, None),
    "ragged": (3, 128, 256, 2, 64, False, [256, 100, 7]),
    "s200": (2, 200, 200, 1, 128, True, [200, 133]),
    "zero_row": (2, 128, 128, 2, 64, True, [0, 90]),
}


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for name in GATE_FLAGS:
        jflags.reset(name)
        pflags.reset(name)


def _data(seed, b, sq, sk, h, hd):
    """q, k, v, the out cotangent and the lse cotangent."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.standard_normal((b, s, hd)).astype(np.float32)
                  for s in (sq, sk, sk, sq))
    g_lse = rng.standard_normal((b, h, sq)).astype(np.float32)
    return q, k, v, g, g_lse


def _jax_grads(q, k, v, g, g_lse, h, causal, scale, kl, dtype="float32"):
    jdt = jnp.dtype(dtype)

    def f(q_, k_, v_):
        return jfa.flash_attention_lse(
            q_, k_, v_, h, causal, scale, True,
            kv_len=None if kl is None else jnp.asarray(kl))

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads = vjp((jnp.asarray(g, jdt), jnp.asarray(g_lse)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _port_bwd(q, k, v, g, g_lse, h, causal, scale, kl, dtype=torch.float32):
    """flash_attention_bwd from the port's own forward residuals."""
    t = [torch.as_tensor(x).to(dtype) for x in (q, k, v, g)]
    kv_len = None if kl is None else torch.as_tensor(kl)
    out, lse = pfa.flash_attention_lse(*t[:3], h, causal, scale,
                                       kv_len=kv_len)
    return pfa.flash_attention_bwd(*t[:3], out, lse, t[3], h, causal, scale,
                                   kv_len=kv_len,
                                   g_lse=torch.as_tensor(g_lse))


def _port_function(q, k, v, g, g_lse, h, causal, scale, kl,
                   dtype=torch.float32):
    """torch.autograd.grad through FlashAttentionFunction."""
    leaves = [torch.as_tensor(x).to(dtype).requires_grad_(True)
              for x in (q, k, v)]
    out, lse = pfa.flash_attention_lse(
        *leaves, h, causal, scale,
        kv_len=None if kl is None else torch.as_tensor(kl))
    return torch.autograd.grad(
        (out, lse), leaves,
        (torch.as_tensor(g).to(dtype), torch.as_tensor(g_lse)))


@pytest.mark.parametrize("entry", ["flash_attention_bwd", "function"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_bwd_matches_jax_vjp(case, entry):
    b, sq, sk, h, d, causal, kv_len = CASES[case]
    q, k, v, g, g_lse = _data(sq + sk, b, sq, sk, h, h * d)
    kl = None if kv_len is None else np.asarray(kv_len, np.int64)
    ref = _jax_grads(q, k, v, g, g_lse, h, causal, 0.0, kl)
    run = _port_bwd if entry == "flash_attention_bwd" else _port_function
    got = run(q, k, v, g, g_lse, h, causal, 0.0, kl)
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        assert o.dtype == torch.float32 and o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=ATOL,
                                   err_msg=name)
    if kv_len is not None and kv_len[0] == 0:
        # no key block runs for the empty row in either sweep
        assert not any(o[0].any() for o in got)


def test_flash_bwd_bf16_and_scale():
    b, sq, sk, h, d = 2, 128, 256, 2, 64
    q, k, v, g, g_lse = _data(5, b, sq, sk, h, h * d)
    kl = np.asarray([256, 150], np.int64)
    ref = _jax_grads(q, k, v, g, g_lse, h, True, 0.2, kl, "bfloat16")
    got = _port_bwd(q, k, v, g, g_lse, h, True, 0.2, kl, torch.bfloat16)
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        assert o.dtype == torch.bfloat16, name
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0,
                                   atol=2e-2 * np.abs(r).max(), err_msg=name)


# the bf16 dK/dV kernel's tile edges, as in test_torch_flash.py:
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
def test_flash_bwd_bf16_tile_edges_match_jax_vjp(case):
    """bf16 at the shapes where the card's dK/dV kernel crosses its tile
    edges (16-key warps, 64- or 32-key blocks, 64- or 32-row q tiles): the
    plain version against jax.vjp of the Pallas kernel, 2e-2 of each
    gradient's largest magnitude."""
    b, sq, sk, h, d, causal, kv_len = BF16_EDGES[case]
    q, k, v, g, g_lse = _data(sq * sk, b, sq, sk, h, h * d)
    kl = None if kv_len is None else np.asarray(kv_len, np.int64)
    ref = _jax_grads(q, k, v, g, g_lse, h, causal, 0.0, kl, "bfloat16")
    got = _port_bwd(q, k, v, g, g_lse, h, causal, 0.0, kl, torch.bfloat16)
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape, name
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0,
                                   atol=2e-2 * np.abs(r).max(), err_msg=name)


def test_flash_bwd_clamps_kv_len_to_sk():
    """kv_len past Sk means every key is live, as in the composite: the
    gradients equal jax.vjp of the composite (the JAX kernel counts its
    zero padding keys as live there, ROADMAP.md C6)."""
    b, sq, sk, h, d = 2, 40, 200, 2, 64
    q, k, v, g, _ = _data(7, b, sq, sk, h, h * d)
    kl = np.asarray([260, 200], np.int64)

    def composite(q_, k_, v_):
        return jattn.attention_reference(
            q_, k_, v_, jattn._seq_len_bias(jnp.asarray(kl), b, sk),
            num_heads=h, causal=False, scale=0.0)

    _, vjp = jax.vjp(composite, *(jnp.asarray(x) for x in (q, k, v)))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    out = pfa.flash_attention(*leaves, h, kv_len=torch.as_tensor(kl))
    got = torch.autograd.grad(out, leaves, torch.as_tensor(g))
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=ATOL,
                                   err_msg=name)


def test_flash_bwd_entries_split_the_work():
    """Kernel #4's entry gives flash_attention_bwd's dq and kernel #5's its
    dk and dv, from the same lse and delta (plain versions on the CPU,
    where nothing is launched)."""
    b, sq, sk, h, d = 2, 72, 136, 2, 64
    q, k, v, g, g_lse = (torch.as_tensor(x)
                         for x in _data(9, b, sq, sk, h, h * d))
    kl = torch.as_tensor(np.asarray([136, 61], np.int64))
    out, lse = pfa.flash_attention_lse(q, k, v, h, True, kv_len=kl)
    delta = pfa.bwd_delta(out, g, h, g_lse)
    launched = (pfa.bwd_dq_launches, pfa.bwd_dkv_launches)
    dq = pfa.flash_attention_bwd_dq(q, k, v, g, lse, delta, h, True,
                                    kv_len=kl)
    dk, dv = pfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, h, True,
                                         kv_len=kl)
    want = pfa.flash_attention_bwd(q, k, v, out, lse, g, h, True,
                                   kv_len=kl, g_lse=g_lse)
    for a, w in zip((dq, dk, dv), want):
        assert torch.equal(a, w)
    assert (pfa.bwd_dq_launches, pfa.bwd_dkv_launches) == launched


def _grad_op(reg, backend, inputs, attrs):
    """fused_attention_grad through a package's registry."""
    info = reg.get_runtime_info("fused_attention_grad")
    out_names = {p + "@GRAD": [p.lower() + "@GRAD"] for p in ("Q", "K", "V")}
    if backend == "jax":
        ins = {p: [jnp.asarray(a) for a in lst] for p, lst in inputs.items()}
        outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names)
        return {p: np.asarray(v[0]) for p, v in outs.items()}
    ins = {p: [torch.as_tensor(a) for a in lst] for p, lst in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names,
                           device=torch.device("cpu"))
    return {p: v[0].numpy() for p, v in outs.items()}


@pytest.mark.parametrize("causal,seq_len", [(True, None), (False, [200, 90]),
                                            (True, [0, 150])],
                         ids=["causal", "seq_len", "zero_row"])
def test_fused_attention_grad_flash_tier_matches_jax(causal, seq_len):
    """The grad op on a 200-token window (the flash tier under
    "interpret" in both packages: off mha_block's 128 grid): the port
    recomputes out and lse, then runs the plain version of #4/#5; the JAX
    package replays the forward under jax.vjp into its Pallas kernels."""
    for f in (jflags, pflags):
        f.set("flash_attention", "interpret")
    b, s, h, d = 2, 200, 2, 64
    q, k, v, g, _ = _data(11, b, s, s, h, h * d)
    inputs = {"Q": [q], "K": [k], "V": [v], "Out@GRAD": [g]}
    if seq_len is not None:
        inputs["SeqLen"] = [np.asarray(seq_len, np.int64)]
    attrs = {"num_heads": h, "causal": causal, "scale": 0.0}
    pq = torch.empty((b, s, h * d), device="meta")
    assert pattn.backend_choice(pq, pq, h, causal, False, seq_len) == "flash"
    pattn.TIER_CALLS.clear()
    j = _grad_op(jreg, "jax", inputs, attrs)
    p = _grad_op(preg, "torch", inputs, attrs)
    assert dict(pattn.TIER_CALLS) == {}    # the grad op counts no forward
    assert sorted(p) == sorted(j)
    for name in j:
        np.testing.assert_allclose(p[name], j[name], rtol=0, atol=ATOL,
                                   err_msg=name)
