"""Speculative decoding in the port's serving.Scheduler against the JAX
package's, on the same weights: the twins of tests/test_spec_decode.py.

The JAX package builds the decode spec (with its Sq = K verify window) and
runs its startups; its weights are carried into the port with
`convert.load_params` over every program of the spec.  The bar is the
serving contract under speculative decoding: every request's greedy
tokens equal the sequential Generator's (the port's, and the JAX
Scheduler's for the same requests), however many proposals the draft got
right.  The verify window's logits and appended cache rows agree with the
JAX program's within 2e-4.

The scheduler logic runs at the JAX tests' tiny sizes (head_dim 16: every
attention takes the composite).  One case runs the head_dim-64 config of
tests/test_torch_serving.py under flash_attention="interpret", where the
prefill takes kernel #3's plain version, the cross-attention of every
step #1's (mha_decode) and every plain and draft step #7's
(flash_decode_paged); the verify window's ramp takes the paged reference.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import decode as jdecode
from paddle_tpu import flags as jflags
from paddle_tpu import serving as jserving
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import attention_ops as jattn
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, flags as pflags
from paddle_tpu_torch import serving, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import attention_ops as pattn

S, P, MAXLEN, V, K = 8, 3, 24, 40, 4
MNT = 12
ATOL = 2e-4
CPU = pt.CPUPlace()
GATE = ("flash_attention", "attn_decode_min_keys")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for name in GATE:
        jflags.reset(name)
        pflags.reset(name)


def _cfg(T, n_layer=2):
    cfg = T.tiny(vocab=V, max_length=16)
    cfg.n_layer = n_layer
    return cfg


def _mk_feed(seed):
    r = np.random.default_rng(seed)
    return {
        "src_ids": r.integers(2, V, size=(1, S)).astype(np.int64),
        "src_lens": np.array([int(r.integers(S // 2, S + 1))], np.int64),
        "trg_ids": r.integers(2, V, size=(1, P)).astype(np.int64),
        "prefix_lens": np.array([int(r.integers(1, P + 1))], np.int64),
    }


def _programs(spec):
    return [p for p in (spec.prefill_program, spec.step_program,
                        spec.verify_program, spec.chunk_program,
                        spec.encode_program) if p is not None]


def carry(jscope, spec):
    """A port scope holding the JAX scope's values of every persistable
    var the spec's programs declare."""
    progs = _programs(spec)
    declared = {v.name for p in progs for v in p.list_vars()
                if v.persistable}
    scope = pt.Scope()
    convert.load_params(scope, {n: np.asarray(jscope.find_var(n))
                                for n in jscope.local_var_names()
                                if n in declared}, CPU, progs)
    return scope


class _World:
    """Both packages' target specs (with the verify window), the JAX
    weights carried into the port, and both packages' trunc drafts."""

    def __init__(self, verify_len=K):
        with junique.guard():
            self.jspec = JT.build_decode(_cfg(JT), src_len=S, prefix_len=P,
                                         max_len=MAXLEN,
                                         verify_len=verify_len)
        self.jscope = JScope()
        self.jgen = jdecode.Generator(self.jspec, scope=self.jscope)
        self.spec = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                                    max_len=MAXLEN, verify_len=verify_len)
        self.scope = carry(self.jscope, self.spec)
        self.gen = pdecode.Generator(self.spec, scope=self.scope, place=CPU)

    def refs(self, feeds, mnt=MNT, eos=1):
        return [self.gen.generate(f, mnt, eos_id=eos)[0].tolist()
                for f in feeds]

    def jax_sched(self, **kw):
        with junique.guard():
            dspec, dscope = JT.build_draft(_cfg(JT), src_len=S, prefix_len=P,
                                           max_len=MAXLEN, tier="trunc",
                                           scope=self.jscope)
        return jserving.Scheduler(self.jspec, self.jscope, paged_kv=True,
                                  spec_decode=True, spec_k=K,
                                  draft_spec=dspec, draft_scope=dscope,
                                  **_sched_kw(kw))

    def sched(self, draft=None, **kw):
        if draft is None:
            draft, _ = PT.build_draft(_cfg(PT), src_len=S, prefix_len=P,
                                      max_len=MAXLEN, tier="trunc",
                                      scope=self.scope)
        return serving.Scheduler(self.spec, self.scope, place=CPU,
                                 paged_kv=True, spec_decode=True, spec_k=K,
                                 draft_spec=draft, **_sched_kw(kw))


def _sched_kw(kw):
    kw = dict(kw)
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 96)
    return kw


@pytest.fixture(scope="module")
def world():
    with testing.fresh_programs():
        return _World()


def _check(reqs, refs, jreqs=None):
    for i, (r, ref) in enumerate(zip(reqs, refs, strict=True)):
        assert r.status == "done", (i, r.status, r.error)
        assert r.tokens == ref, f"request {i} vs the sequential Generator"
        if jreqs is not None:
            assert r.tokens == [int(t) for t in jreqs[i].tokens], \
                f"request {i} vs the JAX Scheduler"


def _drive(sched, feeds, mnt=MNT, eos=1, wave=4, steps=2, **kw):
    """The JAX test's traffic: the first `wave` feeds, `steps` steps, the
    rest mid-flight, then run to idle."""
    reqs = [sched.submit(f, mnt, eos_id=eos, **kw) for f in feeds[:wave]]
    for _ in range(steps):
        sched.step()
    reqs += [sched.submit(f, mnt, eos_id=eos, **kw) for f in feeds[wave:]]
    sched.run_until_idle(max_steps=2000)
    return reqs


# ---------------------------------------------------------------------------
# the mask keystone: the Sq = k ramp collapses to the Sq = 1 SeqLen mask
# ---------------------------------------------------------------------------


def test_ramp_bias_reduces_to_seq_len_bias_at_sq1():
    """At Sq == 1 the port's ramp mask is its SeqLen mask bitwise, and both
    are the JAX package's."""
    lens = np.array([0, 3, 7, 16], np.int64)
    a = pattn._seq_len_bias(torch.as_tensor(lens), 4, 16).numpy()
    b = pattn._seq_len_bias_ramp(torch.as_tensor(lens), 4, 1, 16).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        b, np.asarray(jattn._seq_len_bias_ramp(lens, 4, 1, 16)))
    np.testing.assert_array_equal(
        a, np.asarray(jattn._seq_len_bias(lens, 4, 16)))


def test_ramp_bias_per_query_limits():
    """Query t admits exactly the keys at positions < len + t, as the JAX
    ramp does, bitwise."""
    lens = np.array([2, 5], np.int64)
    m = pattn._seq_len_bias_ramp(torch.as_tensor(lens), 2, 3, 8).numpy()
    assert m.shape == (2, 1, 3, 8) and m.dtype == np.float32
    for b, base in enumerate(lens):
        for t in range(3):
            lim = int(base) + t
            np.testing.assert_array_equal(m[b, 0, t, :lim], np.float32(0.0))
            np.testing.assert_array_equal(m[b, 0, t, lim:],
                                          np.float32(-1e30))
    np.testing.assert_array_equal(
        m, np.asarray(jattn._seq_len_bias_ramp(lens, 2, 3, 8)))


def test_verify_len_must_be_at_least_two():
    with pytest.raises(ValueError, match="verify"):
        PT.build_decode(_cfg(PT), src_len=S, prefix_len=P, max_len=MAXLEN,
                        verify_len=1)


# ---------------------------------------------------------------------------
# the verify window's program
# ---------------------------------------------------------------------------


def test_verify_window_logits_and_rows_match_jax(world):
    """The dense verify program (not the paged rewrite) after a prefill, in
    both packages on the same feeds: logits [B*K, V] and the appended
    cache rows within 2e-4; rows past a window stay as they were."""
    feed = {k: np.concatenate([_mk_feed(10 + i)[k] for i in range(3)])
            for k in _mk_feed(0)}
    window = np.random.RandomState(5).randint(2, V, (3, K)).astype(np.int64)
    got = _verify_outputs(world.gen, world.spec, feed, window)
    want = _verify_outputs(world.jgen, world.jspec, feed, window)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL,
                                   err_msg=name)
    cursor = feed["prefix_lens"]
    ck = got["cache_k_0"]
    for b in range(3):
        assert not np.any(ck[b, cursor[b] + K:]), "rows past the window"


def _verify_outputs(gen, spec, feed, window):
    """{verify logits, updated caches} as numpy after a prefill."""
    _, states, lengths, _ = gen._prefill(feed)
    vf = {spec.prev_ids_name: window,
          spec.lengths_name: np.asarray(lengths, np.int64)}
    for n in spec.step_feeds:
        vf[n] = feed[n]
    vf.update({n: states[n] for n in states})
    with torch.inference_mode():   # the port's caches are written in place
        outs = gen._run("verify", spec.verify_program, spec.verify_fetches(),
                        vf)
    out = {"logits": outs[spec.verify_logits]}
    for s in spec.states:
        if s.verify_update:
            out[s.feed] = outs[s.verify_update]
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# scheduler parity (the tentpole acceptance)
# ---------------------------------------------------------------------------


def test_spec_greedy_equals_plain_greedy(world):
    """Ragged prompts across shape buckets, admitted in two waves, with the
    trunc draft: every token equals the sequential Generator's and the
    JAX Scheduler's, and the verify path multi-emits."""
    feeds = [_mk_feed(100 + i) for i in range(6)]
    refs = world.refs(feeds)
    jreqs = _drive(world.jax_sched(), feeds)
    sched = world.sched()
    reqs = _drive(sched, feeds)
    _check(reqs, refs, jreqs)
    st = sched.stats()
    assert st["errors"] == 0 and st["spec_rounds"] > 0
    assert st["spec_proposed"] > 0 and st["spec_decode"] and st["spec_k"] == K
    # k-1 batched draft steps a round, whatever the lag
    assert st["draft_steps"] == st["spec_rounds"] * (K - 1)
    if st["spec_accepted"]:
        assert st["spec_tokens"] > st["spec_rounds"]
    sched.pool.assert_quiesced()


def test_spec_self_draft_accepts_every_proposal(world):
    """The draft is the target itself (a second build_decode of its
    configuration on its scope): every proposal is accepted.  The first
    round emits K tokens; a full acceptance leaves the draft one row
    behind (the JAX package's lag), so each later round spends its first
    draft step on the gap token and emits K - 1.  The lag and gap
    bookkeeping carries every request to the sequential tokens."""
    feeds = [_mk_feed(150 + i) for i in range(4)]
    refs = world.refs(feeds, eos=-1)
    draft = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                            max_len=MAXLEN)
    sched = world.sched(draft=draft)
    reqs = [sched.submit(f, MNT, eos_id=-1) for f in feeds]
    per_round = []
    while sched.step():
        per_round.append([len(r.tokens) for r in reqs])
    _check(reqs, refs)
    st = sched.stats()
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    # MNT = 12: 1 from the prefill, then rounds of 4, 3, 3 and the last 1
    assert per_round == [[1] * 4, [5] * 4, [8] * 4, [11] * 4, [12] * 4]
    assert st["spec_tokens"] == len(feeds) * (MNT - 1)
    assert st["spec_rounds"] == 4
    assert st["spec_proposed"] == len(feeds) * (K - 1 + 3 * (K - 2))
    sched.pool.assert_quiesced()


def test_spec_evict_replay_multi_token_parity(world):
    """Evict-and-replay with multi-token rounds in flight: the replayed
    chain (target and draft teacher-forced in lockstep) resumes on the
    sequential tokens, as the JAX Scheduler's does."""
    feeds = [_mk_feed(50 + i) for i in range(5)]
    refs = world.refs(feeds, mnt=14)
    out = []
    for sched in (world.jax_sched(prefix_cache=False),
                  world.sched(prefix_cache=False)):
        reqs = [sched.submit(f, 14, eos_id=1) for f in feeds]
        for _ in range(3):
            sched.step()
        sched.preempt(next(r for r in reqs if r.status == "running"),
                      evict=True)
        sched.run_until_idle(max_steps=2000)
        assert sched.counters["replays"] >= 1
        assert sched.counters["spec_rounds"] > 0
        out.append(reqs)
    _check(out[1], refs, out[0])
    sched.pool.assert_quiesced()


def test_spec_export_import_multi_token_parity(world):
    """Handoff to another Scheduler mid-generation with multi-token rounds
    in flight: the importer (its own pool and draft chain) finishes every
    request on the sequential tokens."""
    feeds = [_mk_feed(200 + i) for i in range(4)]
    refs = world.refs(feeds)
    a = world.sched()
    reqs_a = [a.submit(f, MNT, eos_id=1, request_id=f"r{i}")
              for i, f in enumerate(feeds)]
    for _ in range(3):
        a.step()
    records = a.export_requests(cancel=True)
    a.run_until_idle(max_steps=100)
    assert all(r.done for r in reqs_a)
    live = {rec["request_id"] for rec in records}
    assert live, "nothing survived to hand off"
    for i, r in enumerate(reqs_a):
        if f"r{i}" not in live:
            assert r.tokens == refs[i]
    b = world.sched()
    by_id = dict(zip([rec["request_id"] for rec in records],
                     b.import_requests(records)))
    b.run_until_idle(max_steps=2000)
    for i in range(len(feeds)):
        req = by_id.get(f"r{i}")
        if req is not None:
            assert req.status == "done", (i, req.status, req.error)
            assert req.tokens == refs[i], f"request {i} after import"
    assert b.counters["spec_rounds"] > 0 and b.counters["replays"] >= 1
    a.pool.assert_quiesced()
    b.pool.assert_quiesced()


def test_spec_prefix_cache_shared_chain_parity(world):
    """Draft KV rides the same copy-on-write chains as the target:
    identical prompts share the prefix (a hit), both tenants' rejected
    verify suffixes land past their own cursors only, and every request
    keeps the sequential tokens, as in the JAX Scheduler."""
    base = _mk_feed(300)
    feeds = [base, {k: v.copy() for k, v in base.items()}, _mk_feed(301)]
    refs = world.refs(feeds)
    out = []
    for sched in (world.jax_sched(prefix_cache=True),
                  world.sched(prefix_cache=True)):
        reqs = [sched.submit(feeds[0], MNT, eos_id=1)]
        sched.step()   # admit and register the prefix chain
        sched.step()   # the first round appends into the shared tail
        reqs += [sched.submit(f, MNT, eos_id=1) for f in feeds[1:]]
        sched.run_until_idle(max_steps=2000)
        assert sched.stats()["pool"]["prefix_hits"] >= 1
        out.append(reqs)
    _check(out[1], refs, out[0])
    sched.pool.assert_quiesced()


def test_spec_requires_paged_and_matching_k(world):
    """The JAX package's init checks, in the same order and words."""
    dspec, _ = PT.build_draft(_cfg(PT), src_len=S, prefix_len=P,
                              max_len=MAXLEN, scope=world.scope)
    kw = dict(place=CPU, spec_decode=True, draft_spec=dspec)
    with pytest.raises(ValueError, match="paged"):
        serving.Scheduler(world.spec, world.scope, paged_kv=False,
                          spec_k=K, **kw)
    with pytest.raises(ValueError, match="verify_len"):
        serving.Scheduler(world.spec, world.scope, paged_kv=True,
                          spec_k=K + 1, **kw)
    with pytest.raises(ValueError, match="spec_k"):
        serving.Scheduler(world.spec, world.scope, paged_kv=True, spec_k=1,
                          **kw)
    with pytest.raises(ValueError, match="draft"):
        serving.Scheduler(world.spec, world.scope, place=CPU, paged_kv=True,
                          spec_decode=True, spec_k=K)
    plain = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                            max_len=MAXLEN)
    with pytest.raises(ValueError, match="verify"):
        serving.Scheduler(plain, world.scope, paged_kv=True, spec_k=K, **kw)
    chunked = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                              max_len=MAXLEN, verify_len=K, chunk_len=3)
    with pytest.raises(ValueError, match="chunked prefill \\+ spec"):
        serving.Scheduler(chunked, world.scope, paged_kv=True, spec_k=K,
                          prefill_chunk=3, **kw)


def test_int8_draft_tier_raises_and_trunc_shares_the_scope(world):
    """The trunc tier is the bottom half of the decoder on the target's
    own scope and parameter names (the JAX package's spec, op for op);
    the int8 tier waits for int8_ops (ROADMAP A4)."""
    dspec, dscope = PT.build_draft(_cfg(PT), src_len=S, prefix_len=P,
                                   max_len=MAXLEN, tier="trunc",
                                   scope=world.scope)
    assert dscope is world.scope
    with junique.guard():
        jd, _ = JT.build_draft(_cfg(JT), src_len=S, prefix_len=P,
                               max_len=MAXLEN, tier="trunc",
                               scope=world.jscope)
    for which in ("prefill_program", "step_program"):
        assert getattr(dspec, which).to_dict() == \
            getattr(jd, which).to_dict()
    assert sum(s.feed.startswith("cache_k_") for s in dspec.states) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PT.build_draft(_cfg(PT), src_len=S, prefix_len=P, max_len=MAXLEN,
                       tier="int8", scope=world.scope)
    with pytest.raises(ValueError, match="tier"):
        PT.build_draft(_cfg(PT), tier="fp4", scope=world.scope)
    clone = PT.clone_scope(world.scope)
    assert sorted(clone.local_var_names()) == \
        sorted(world.scope.local_var_names())
    clone.set_var("dec_ln.w_0", torch.zeros(1))
    assert world.scope.find_var("dec_ln.w_0").shape != (1,)


def test_spec_pool_pressure_no_leak_no_livelock(world):
    """Pool pressure under spec decode: six tenants decode 16 tokens each
    (no eos) through 4 slots over 14 blocks of 4 rows; each round needs K
    rows, so _ensure_block preempts victims that wait for room and replay
    (target and draft in lockstep).  Every request finishes with the
    sequential tokens and no block leaks (ROADMAP.md C7: the JAX
    Scheduler is no oracle under pool pressure)."""
    feeds = [dict(f, prefix_lens=np.asarray([1 + i % 3], np.int64))
             for i, f in enumerate(_mk_feed(500 + i) for i in range(6))]
    refs = world.refs(feeds, mnt=16, eos=-1)
    sched = world.sched(num_blocks=14, prefix_cache=False)
    reqs = [sched.submit(f, 16, eos_id=-1) for f in feeds]
    for _ in range(4):
        sched.step()
    sched.preempt(next(r for r in reqs if r.status == "running"),
                  evict=True)
    n = sched.run_until_idle(max_steps=3000)
    assert n < 3000, "livelock: the scheduler never went idle"
    _check(reqs, refs)
    assert sched.counters["preemptions"] >= 2
    assert sched.counters["replays"] >= 2
    assert sched.counters["spec_rounds"] > 0
    sched.pool.assert_quiesced()


# ---------------------------------------------------------------------------
# the head_dim-64 config: the kernels' plain versions on the path
# ---------------------------------------------------------------------------

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
HD_S, HD_WINDOW, HD_MAX_LEN, HD_MNT = 128, 200, 256, 8


def _hd_feeds(n, seed):
    rng = np.random.RandomState(seed)
    return [{
        "src_ids": rng.randint(2, 64, size=(1, HD_S)).astype(np.int64),
        "src_lens": np.asarray([rng.randint(HD_S // 2, HD_S + 1)], np.int64),
        "trg_ids": rng.randint(2, 64, size=(1, HD_WINDOW)).astype(np.int64),
        "prefix_lens": np.asarray([rng.randint(HD_WINDOW - 40,
                                               HD_WINDOW + 1)], np.int64),
    } for _ in range(n)]


def _sharpen(jscope):
    """The JAX startup's weight matrices and embedding times 3, as in
    tests/test_torch_serving.py: greedy tokens then do not collapse onto
    one token within a few steps."""
    import jax.numpy as jnp

    for n in jscope.local_var_names():
        if n.endswith(".w_0") or n == "src_word_emb":
            jscope.set_var(n, jnp.asarray(jscope.find_var(n)) * 3.0)


def test_spec_decode_head_dim_64_runs_the_kernel_tiers():
    """flash_attention="interpret" and attn_decode_min_keys 200 in both
    packages: the 200-token prefill windows take kernel #3's plain version,
    the Sq = 1 cross-attention #1's (mha_decode), every plain and draft
    step #7's (flash_decode_paged) and the verify window the paged
    reference.  Every token equals the sequential Generator's in both
    packages."""
    for f in (jflags, pflags):
        f.set("flash_attention", "interpret")
        f.set("attn_decode_min_keys", 200)
    kw = dict(src_len=HD_S, prefix_len=HD_WINDOW, max_len=HD_MAX_LEN)
    feeds = _hd_feeds(3, 7)
    with junique.guard():
        jspec = JT.build_decode(JT.TransformerConfig(**SMALL), verify_len=K,
                                **kw)
    jscope = JScope()
    jgen = jdecode.Generator(jspec, scope=jscope)
    _sharpen(jscope)
    jtok = [np.asarray(jgen.generate(f, HD_MNT, eos_id=1))[0].tolist()
            for f in feeds]
    spec = PT.build_decode(PT.TransformerConfig(**SMALL), verify_len=K, **kw)
    scope = carry(jscope, spec)
    gen = pdecode.Generator(spec, scope=scope, place=CPU)
    refs = [gen.generate(f, HD_MNT, eos_id=1)[0].tolist() for f in feeds]
    assert refs == jtok
    draft, _ = PT.build_draft(PT.TransformerConfig(**SMALL), tier="trunc",
                              scope=scope, **kw)
    sched = serving.Scheduler(spec, scope, place=CPU, max_batch=4,
                              block_size=16, paged_kv=True, spec_decode=True,
                              spec_k=K, draft_spec=draft)
    pattn.TIER_CALLS.clear()
    reqs = [sched.submit(f, HD_MNT, eos_id=1) for f in feeds]
    sched.run_until_idle(max_steps=500)
    _check(reqs, refs)
    assert sched.counters["spec_rounds"] > 0
    assert {"flash", "mha_decode", "flash_decode_paged",
            "paged_reference"} <= set(pattn.TIER_CALLS)
    sched.pool.assert_quiesced()
