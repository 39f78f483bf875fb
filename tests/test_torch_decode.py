"""The serving slice end to end: transformer decode through decode.Generator
in both packages, on the same weights.

The JAX package builds a head_dim-64 transformer and runs its startup; its
scope is carried into the port with `convert.load_params`.  Both run with
flash_attention="interpret" and attn_decode_min_keys=200, so that at
src_len 128, a 128-token prefix and a 256-slot cache every kernel tier of
the slice runs: mha_block in the prefill (encoder, causal prefix, cross),
flash_decode for the step's self-attention over the 256-slot cache and
mha_decode for its cross-attention over the 128 source keys.  (At head_dim
16, e.g. transformer.tiny(), every gate picks the composite.)  The JAX
side runs its Pallas kernels in interpret mode, the port its kernels'
plain versions.  Prefill and teacher-forced step logits must agree to
atol 2e-4 (the bar of tests/test_decode.py); greedy tokens must be equal.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import decode as jdecode
from paddle_tpu import flags as jflags
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, flags as pflags
from paddle_tpu_torch import testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import attention_ops as pattn

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
S, P, MAX_LEN, B, STEPS = 128, 128, 256, 2, 4
ATOL = 2e-4


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for f in (jflags, pflags):
        f.reset("flash_attention")
        f.reset("attn_decode_min_keys")


def _feed():
    rng = np.random.RandomState(0)
    src = rng.randint(2, 64, size=(B, S)).astype(np.int64)
    trg = rng.randint(2, 64, size=(B, P + STEPS)).astype(np.int64)
    feed = {"src_ids": src, "src_lens": np.array([S, S - 37], np.int64),
            "trg_ids": trg[:, :P],
            "prefix_lens": np.array([P, P - 3], np.int64)}
    return feed, trg


def _teacher_forced(gen, feed, trg):
    """Prefill logits and STEPS step logits, each step fed the target
    token at the row's cursor."""
    _, states, lengths, logits = gen._prefill(feed)
    out = [np.asarray(logits)]
    for _ in range(STEPS):
        tok = trg[np.arange(B), lengths]
        logits, states = gen._step(tok, lengths, states, feed)
        lengths = lengths + 1
        out.append(np.asarray(logits))
    return out


def _port_generator(jscope, flag):
    pflags.set("flash_attention", flag)
    pflags.set("attn_decode_min_keys", 200)
    spec = PT.build_decode(PT.TransformerConfig(**SMALL), src_len=S,
                           prefix_len=P, max_len=MAX_LEN)
    progs = [spec.prefill_program, spec.step_program]
    declared = {v.name for p in progs for v in p.list_vars() if v.persistable}
    params = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names() if n in declared}
    scope = pt.Scope()
    convert.load_params(scope, params, pt.CPUPlace(), progs)
    return pdecode.Generator(spec, scope=scope, place=pt.CPUPlace())


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's logits and greedy tokens, and its weights."""
    jflags.set("flash_attention", "interpret")
    jflags.set("attn_decode_min_keys", 200)
    try:
        spec = JT.build_decode(JT.TransformerConfig(**SMALL), src_len=S,
                               prefix_len=P, max_len=MAX_LEN)
        jscope = JScope()
        gen = jdecode.Generator(spec, scope=jscope)
        feed, trg = _feed()
        logits = _teacher_forced(gen, feed, trg)
        tokens = np.asarray(gen.generate(feed, STEPS + 1))
    finally:
        jflags.reset("flash_attention")
        jflags.reset("attn_decode_min_keys")
    return jscope, logits, tokens


def test_port_matches_jax_through_every_kernel_tier(jax_run):
    jscope, jlogits, jtokens = jax_run
    gen = _port_generator(jscope, "interpret")
    feed, trg = _feed()
    pattn.TIER_CALLS.clear()
    plogits = _teacher_forced(gen, feed, trg)
    per_prefill = 3 * SMALL["n_layer"]
    assert dict(pattn.TIER_CALLS) == {
        "mha_block": per_prefill,
        "flash_decode": STEPS * SMALL["n_layer"],
        "mha_decode": STEPS * SMALL["n_layer"]}
    for i, (j, p) in enumerate(zip(jlogits, plogits, strict=True)):
        assert p.shape == j.shape
        err = np.abs(p - j).max()
        assert err < ATOL, f"{'prefill' if i == 0 else f'step {i}'}: {err}"
    tokens = gen.generate(feed, STEPS + 1)
    assert tokens.dtype == np.int64
    np.testing.assert_array_equal(tokens, jtokens)


def test_composite_tier_matches_the_kernel_tiers(jax_run):
    """The port's composite ("0": no kernel wrapper at all) against the
    JAX package's kernel tiers: the tiers are one function."""
    jscope, jlogits, jtokens = jax_run
    gen = _port_generator(jscope, "0")
    feed, trg = _feed()
    pattn.TIER_CALLS.clear()
    plogits = _teacher_forced(gen, feed, trg)
    assert set(pattn.TIER_CALLS) == {"composite"}
    for j, p in zip(jlogits, plogits, strict=True):
        assert np.abs(p - j).max() < ATOL
    np.testing.assert_array_equal(gen.generate(feed, STEPS + 1), jtokens)


def test_generator_defaults_to_the_card():
    spec = PT.build_decode(PT.TransformerConfig(**SMALL), src_len=S,
                           prefix_len=8, max_len=MAX_LEN)
    if torch.cuda.is_available():
        assert pdecode.Generator(spec).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CPUPlace"):
            pdecode.Generator(spec)


def test_generate_from_scratch_stops_at_eos_and_max_len():
    """Weights drawn by the startup programs; rows that emit eos pad with
    eos; the cache's max_len bounds the number of steps."""
    spec = PT.build_decode(PT.TransformerConfig(**SMALL), src_len=S,
                           prefix_len=8, max_len=12)
    gen = pdecode.Generator(spec, place=pt.CPUPlace())
    feed, _ = _feed()
    feed = dict(feed, trg_ids=feed["trg_ids"][:, :8],
                prefix_lens=np.array([8, 5], np.int64))
    tokens = gen.generate(feed, 10, eos_id=-1)
    # row 0 starts at 8 of 12 cache slots: prefill token + 4 steps
    assert tokens.shape == (B, 5)
    assert ((tokens >= 0) & (tokens < 64)).all()
    first = tokens[0, 1]
    forced = gen.generate(feed, 10, eos_id=int(first))
    assert (forced[0, 1:] == first).all()
