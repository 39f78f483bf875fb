"""Chunked prefill and the two-tier KV handoff in the port's
serving.Scheduler against the JAX package's, on the same weights: the
twins of tests/test_disagg.py:73-238.

The JAX package builds the decode spec with its Sq = CHUNK window and its
encoder-only pass and runs its startups; its weights are carried into the
port with `convert.load_params` over every program of the spec.  The bar
is unchanged from the rest of the serving tier: every request's greedy
tokens equal the sequential Generator's (the port's, and the JAX
Scheduler's for the same requests), whether the prompt ran as one prefill,
as interleaved chunk windows, or was prefilled on one Scheduler and
decoded on another with another block size.  The chunk window's logits
and rows and the encode pass's states agree with the JAX programs' within
2e-4.

The scheduler logic runs at the JAX tests' tiny sizes (one layer,
head_dim 16).  One case runs the head_dim-64 config of
tests/test_torch_serving.py under flash_attention="interpret": the encode
pass and the chunk windows' cross-attention take #1's plain version
(mha_block), short prompts prefill through #3's, and every step's
self-attention takes #7's (flash_decode_paged).
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
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, flags as pflags
from paddle_tpu_torch import serving, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import attention_ops as pattn

# P = 7, so that CHUNK = 3 splits prompts: plen 1 does not chunk, 3 is
# exactly one chunk (no chunking either), 4 and 7 leave a remainder of 1
S, P, MAXLEN, V = 8, 7, 28, 40
CHUNK = 3
MNT = 10
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


def _cfg(T):
    cfg = T.tiny(vocab=V, max_length=16)
    cfg.n_layer = 1
    return cfg


def _mk_feed(seed, plen=None):
    r = np.random.default_rng(seed)
    return {
        "src_ids": r.integers(2, V, size=(1, S)).astype(np.int64),
        "src_lens": np.array([int(r.integers(S // 2, S + 1))], np.int64),
        "trg_ids": r.integers(2, V, size=(1, P)).astype(np.int64),
        "prefix_lens": np.array(
            [int(r.integers(1, P + 1)) if plen is None else plen],
            np.int64),
    }


def carry(jscope, spec):
    """A port scope holding the JAX scope's values of every persistable
    var the spec's programs declare."""
    progs = [p for p in (spec.prefill_program, spec.step_program,
                         spec.verify_program, spec.chunk_program,
                         spec.encode_program) if p is not None]
    declared = {v.name for p in progs for v in p.list_vars()
                if v.persistable}
    scope = pt.Scope()
    convert.load_params(scope, {n: np.asarray(jscope.find_var(n))
                                for n in jscope.local_var_names()
                                if n in declared}, CPU, progs)
    return scope


def _sharpen(jscope):
    """The JAX startup's weight matrices and embedding times 3, as in
    tests/test_torch_serving.py, so that greedy tokens do not collapse."""
    import jax.numpy as jnp

    for n in jscope.local_var_names():
        if n.endswith(".w_0") or n == "src_word_emb":
            jscope.set_var(n, jnp.asarray(jscope.find_var(n)) * 3.0)


class _World:
    def __init__(self):
        with junique.guard():
            self.jspec = JT.build_decode(_cfg(JT), src_len=S, prefix_len=P,
                                         max_len=MAXLEN, chunk_len=CHUNK)
        self.jscope = JScope()
        self.jgen = jdecode.Generator(self.jspec, scope=self.jscope)
        self.spec = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                                    max_len=MAXLEN, chunk_len=CHUNK)
        self.scope = carry(self.jscope, self.spec)
        self.gen = pdecode.Generator(self.spec, scope=self.scope, place=CPU)

    def refs(self, feeds, mnt=MNT):
        return [self.gen.generate(f, mnt, eos_id=1)[0].tolist()
                for f in feeds]

    def jax_sched(self, chunk=CHUNK, block_size=4, **kw):
        return jserving.Scheduler(self.jspec, self.jscope, max_batch=4,
                                  block_size=block_size, num_blocks=96,
                                  paged_kv=True, prefill_chunk=chunk, **kw)

    def sched(self, chunk=CHUNK, block_size=4, **kw):
        kw.setdefault("num_blocks", 96)
        return serving.Scheduler(self.spec, self.scope, place=CPU,
                                 max_batch=4, block_size=block_size,
                                 paged_kv=True, prefill_chunk=chunk, **kw)


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


# ---------------------------------------------------------------------------
# the chunk window and the encode pass
# ---------------------------------------------------------------------------


def test_chunk_window_and_encode_pass_match_jax(world):
    """The encode program's cross k/v equal the prefill's (same ops, same
    weights) and the JAX encode's; two chunk windows over an empty cache
    give logits and rows within 2e-4 of the JAX chunk program's."""
    feed = {k: np.concatenate([_mk_feed(20 + i, plen=P)[k] for i in range(2)])
            for k in _mk_feed(0)}
    got = _window_outputs(world.gen, world.spec, feed)
    want = _window_outputs(world.jgen, world.jspec, feed)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got["enc_k_0"], got["prefill:enc_k_0"])


def _window_outputs(gen, spec, feed):
    """{encode fetches, the prefill's enc_k_0, two chunk windows' logits
    and caches} as numpy."""
    def host(v):
        return np.asarray(v.float() if isinstance(v, torch.Tensor) else v)

    with torch.inference_mode():
        enc = gen._run("encode", spec.encode_program, spec.encode_fetches(),
                       {n: feed[n] for n in ("src_ids", "src_lens")})
        _, states, _, _ = gen._prefill(feed)
        out = {s.feed: host(enc[s.encode_from]) for s in spec.states
               if s.encode_from}
        out["prefill:enc_k_0"] = host(states["enc_k_0"])
        caches = {s.feed: states[s.feed] * 0 for s in spec.states
                  if s.chunk_update}
        if not isinstance(states["enc_k_0"], torch.Tensor):
            caches = {n: np.asarray(v) for n, v in caches.items()}
        for w in range(2):
            cf = {spec.prev_ids_name: feed["trg_ids"][:, w * CHUNK:
                                                      (w + 1) * CHUNK],
                  spec.lengths_name: np.full(2, w * CHUNK, np.int64),
                  "src_lens": feed["src_lens"]}
            cf.update(caches)
            cf.update({s.feed: states[s.feed] for s in spec.states
                       if s.encode_from})
            outs = gen._run("chunk", spec.chunk_program,
                            spec.chunk_fetches(), cf)
            out[f"logits{w}"] = host(outs[spec.chunk_logits])
            caches = {s.feed: outs[s.chunk_update] for s in spec.states
                      if s.chunk_update}
        out.update({n: host(v) for n, v in caches.items()})
    return out


def test_generator_stages_every_startup_of_the_spec():
    """Generator._ensure_vars stages the verify, chunk and encode startups
    too (the JAX package's decode/__init__.py:198): on a spec built with
    verify_len and chunk_len, a fresh scope ends up holding every var that
    any of its programs reads, and each program runs."""
    spec = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P, max_len=40,
                           verify_len=4, chunk_len=CHUNK)
    gen = pdecode.Generator(spec, scope=pt.Scope(), place=CPU)
    for prog in (spec.prefill_program, spec.step_program,
                 spec.verify_program, spec.chunk_program,
                 spec.encode_program):
        for v in prog.list_vars():
            if v.persistable:
                assert gen.scope.find_var(v.name) is not None, v.name
    # the windows' position table is their own (max_len 40, no step
    # startup var of that name existed before the windows read it)
    assert gen.scope.find_var("src_word_emb_pos_m40") is not None
    with torch.inference_mode():
        outs = gen._run("encode", spec.encode_program, spec.encode_fetches(),
                        {"src_ids": _mk_feed(1)["src_ids"],
                         "src_lens": _mk_feed(1)["src_lens"]})
    assert all(torch.isfinite(v).all() for v in outs.values())


# ---------------------------------------------------------------------------
# chunked prefill on one scheduler
# ---------------------------------------------------------------------------


def test_chunked_prefill_parity_mid_flight_and_edges(world):
    """Chunked prefill under continuous batching: requests admitted while
    others are mid-chunk, a full-length prompt (P = 7: two full chunks
    after a remainder of 1), a prompt of exactly one chunk and a 1-token
    prompt (neither chunks).  Every token equals the sequential
    Generator's and the JAX Scheduler's."""
    feeds = [_mk_feed(100 + i) for i in range(6)]
    feeds += [_mk_feed(200, plen=P), _mk_feed(201, plen=1),
              _mk_feed(202, plen=CHUNK), _mk_feed(203, plen=CHUNK + 1)]
    refs = world.refs(feeds)
    out = []
    for sched in (world.jax_sched(), world.sched()):
        reqs = [sched.submit(f, MNT, eos_id=1) for f in feeds[:4]]
        for _ in range(3):
            sched.step()   # some prompts are mid-chunk now
        reqs += [sched.submit(f, MNT, eos_id=1) for f in feeds[4:]]
        sched.run_until_idle(max_steps=4000)
        out.append((reqs, sched.stats()))
    _check(out[1][0], refs, out[0][0])
    jst, st = out[0][1], out[1][1]
    for key in ("chunked", "chunk_passes", "prefill_batches", "steps"):
        assert st[key] == jst[key], key
    long = sum(int(f["prefix_lens"][0]) > CHUNK for f in feeds)
    assert st["chunked"] == long >= 4
    assert st["chunk_passes"] == sum(
        -(-int(f["prefix_lens"][0]) // CHUNK) for f in feeds
        if int(f["prefix_lens"][0]) > CHUNK)
    assert st["prefill_chunk"] == CHUNK
    assert st["ttft_ms"]["count"] == len(feeds)
    assert st["ttft_ms"]["p99"] >= st["ttft_ms"]["p50"] > 0
    assert st["prefill_chunk_ms"]["count"] == st["chunk_passes"]
    sched.pool.assert_quiesced()


def test_chunked_requires_paged_kv_and_chunk_program(world):
    """The JAX package's refusals: no chunk program, the host pool, a
    chunk width other than the program's."""
    plain = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                            max_len=MAXLEN)
    with pytest.raises(ValueError, match="chunk program"):
        serving.Scheduler(plain, world.scope, place=CPU, block_size=4,
                          num_blocks=32, paged_kv=True, prefill_chunk=CHUNK)
    with pytest.raises(ValueError, match="paged"):
        serving.Scheduler(world.spec, world.scope, place=CPU, block_size=4,
                          num_blocks=32, paged_kv=False, prefill_chunk=CHUNK)
    with pytest.raises(ValueError, match="chunk_len"):
        world.sched(chunk=CHUNK + 1)


def test_chunk_pool_pressure_requeues_mid_prefill(world):
    """A chunk window that finds no room and nothing to evict drops its
    partial chain and goes back to the front of the queue; it re-chunks
    from 0 once the pool has room, and keeps the sequential tokens."""
    feeds = [_mk_feed(700 + i, plen=P) for i in range(3)]
    refs = world.refs(feeds)
    sched = world.sched(num_blocks=5, prefix_cache=False)
    reqs = [sched.submit(f, MNT, eos_id=1) for f in feeds]
    sched.run_until_idle(max_steps=4000)
    _check(reqs, refs)
    assert sched.counters["preemptions"] >= 1
    sched.pool.assert_quiesced()


def test_mid_prefill_export_import_parity(world):
    """A request exported mid-chunk ships as a plain record (its chunk
    cursor is recomputed, not shipped: the importer re-chunks from 0) and
    resumes with the sequential tokens on the importing Scheduler."""
    feeds = [_mk_feed(300 + i, plen=P) for i in range(3)]
    refs = world.refs(feeds)
    a = world.sched()
    reqs_a = [a.submit(f, MNT, eos_id=1, request_id=f"r{i}")
              for i, f in enumerate(feeds)]
    a.step()   # admission: all three enter the chunk queue
    a.step()   # one chunk pass lands: a request is mid-prefill
    assert a.stats()["prefilling"] >= 1
    assert any(0 < r._chunk_pos < int(f["prefix_lens"][0])
               for r, f in zip(reqs_a, feeds))
    records = a.export_requests(cancel=True)
    a.run_until_idle(max_steps=100)
    assert all(r.done for r in reqs_a)
    assert {rec["request_id"] for rec in records} == {"r0", "r1", "r2"}
    assert all(rec["tokens"] == [] for rec in records)
    b = world.sched()
    by_id = dict(zip([rec["request_id"] for rec in records],
                     b.import_requests(records)))
    b.run_until_idle(max_steps=2000)
    _check([by_id[f"r{i}"] for i in range(3)], refs)
    a.pool.assert_quiesced()
    b.pool.assert_quiesced()


# ---------------------------------------------------------------------------
# two-tier handoff (KV payload export and adoption)
# ---------------------------------------------------------------------------


def _payload(rec):
    return {"cursor": rec["cursor"], "rows": rec["kv"],
            "states": rec["states"], "last_tok": rec["last_tok"],
            "n_tokens": rec["n_tokens"]}


def _resume(dec, rec):
    return dec.submit(serving.decode_feed(rec["feed"]),
                      rec["max_new_tokens"], eos_id=rec["eos_id"],
                      bos_id=rec["bos_id"], recorded_tokens=rec["tokens"],
                      kv_payload=_payload(rec))


def test_handoff_kv_payload_parity_across_block_geometries(world):
    """A prefill-tier Scheduler (chunked, blocks of 4) runs each prompt,
    and a decode-tier Scheduler with blocks of 8 adopts the record's KV
    payload; the continued tokens equal the sequential Generator's and the
    JAX two-tier run's."""
    feeds = [_mk_feed(400 + i) for i in range(5)] + [_mk_feed(500, plen=P)]
    refs = world.refs(feeds)
    runs = []
    for make in (world.jax_sched, world.sched):
        pre, dec = make(), make(chunk=None, block_size=8)
        outs = []
        for f in feeds:
            h = pre.submit(f, MNT, eos_id=1, prefill_only=True)
            pre.run_until_idle(max_steps=2000)
            if h.status == "done":   # eos at the first token: no handoff
                outs.append([int(t) for t in h.tokens])
                continue
            assert h.status == "prefilled", (h.status, h.error)
            rec = h.handoff
            assert rec["cursor"] == int(f["prefix_lens"][0])
            assert rec["tokens"] == [rec["last_tok"]]
            h2 = _resume(dec, rec)
            dec.run_until_idle(max_steps=2000)
            assert h2.status == "done", (h2.status, h2.error)
            outs.append([int(t) for t in h2.tokens])
        assert pre.counters["handoffs"] >= 3
        assert dec.counters["adopted"] == pre.counters["handoffs"]
        runs.append((outs, pre))
    assert runs[1][0] == refs
    assert runs[1][0] == runs[0][0]
    pre = runs[1][1]
    assert pre.counters["completed"] == len(feeds)
    pre.pool.assert_quiesced()


def test_adopted_request_survives_evict_and_replay(world):
    """Evicting an adopted request on the decode tier falls back to plain
    evict-and-replay (the record ships the whole feed, so the importer can
    prefill from scratch), and the replayed tokens stay the sequential
    ones; a recorded tail past the payload is teacher-forced at
    adoption."""
    feed = _mk_feed(600, plen=P)
    (ref,) = world.refs([feed], mnt=14)
    pre = world.sched()
    dec = world.sched(chunk=None, block_size=8)
    h = pre.submit(feed, 14, eos_id=1, prefill_only=True)
    pre.run_until_idle(max_steps=2000)
    assert h.status == "prefilled", (h.status, h.error)
    rec = h.handoff
    h2 = _resume(dec, rec)
    dec.step()   # admission adopts and activates
    for _ in range(2):
        dec.step()
    assert h2.status == "running", (h2.status, h2.error)
    dec.preempt(h2, evict=True)
    dec.run_until_idle(max_steps=2000)
    assert h2.status == "done", (h2.status, h2.error)
    assert h2.tokens == ref
    assert dec.counters["replays"] >= 1 and dec.counters["adopted"] == 1
    # the same payload with two more recorded tokens: the tail is
    # teacher-forced at adoption
    tail = dict(rec, tokens=ref[:3])
    h3 = _resume(dec, tail)
    dec.run_until_idle(max_steps=2000)
    assert h3.status == "done" and h3.tokens == ref
    assert dec.counters["adopted"] == 2
    dec.pool.assert_quiesced()


# ---------------------------------------------------------------------------
# the head_dim-64 config: the kernels' plain versions on the path
# ---------------------------------------------------------------------------

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
HD_S, HD_WINDOW, HD_MAX_LEN, HD_CHUNK, HD_MNT = 128, 200, 256, 64, 6


def test_chunked_and_handoff_head_dim_64_run_the_kernel_tiers():
    """flash_attention="interpret" and attn_decode_min_keys 200 in both
    packages; prompts of 150-200 tokens run 3-4 chunk windows of 64 (the
    encode pass and the windows' cross-attention through mha_block's
    plain version), a 40-token prompt the monolithic prefill through the
    flash tier's, every step the paged kernel's; a prefill-only request
    hands off to a Scheduler with blocks of 32.  Every token equals the
    sequential Generator's in both packages."""
    for f in (jflags, pflags):
        f.set("flash_attention", "interpret")
        f.set("attn_decode_min_keys", 200)
    kw = dict(src_len=HD_S, prefix_len=HD_WINDOW, max_len=HD_MAX_LEN)
    rng = np.random.RandomState(9)
    feeds = [{
        "src_ids": rng.randint(2, 64, size=(1, HD_S)).astype(np.int64),
        "src_lens": np.asarray([rng.randint(HD_S // 2, HD_S + 1)], np.int64),
        "trg_ids": rng.randint(2, 64, size=(1, HD_WINDOW)).astype(np.int64),
        "prefix_lens": np.asarray([n], np.int64),
    } for n in (200, 150, 40)]
    with junique.guard():
        jspec = JT.build_decode(JT.TransformerConfig(**SMALL),
                                chunk_len=HD_CHUNK, **kw)
    jscope = JScope()
    jgen = jdecode.Generator(jspec, scope=jscope)
    _sharpen(jscope)
    jtok = [np.asarray(jgen.generate(f, HD_MNT, eos_id=1))[0].tolist()
            for f in feeds]
    spec = PT.build_decode(PT.TransformerConfig(**SMALL), chunk_len=HD_CHUNK,
                           **kw)
    scope = carry(jscope, spec)
    gen = pdecode.Generator(spec, scope=scope, place=CPU)
    refs = [gen.generate(f, HD_MNT, eos_id=1)[0].tolist() for f in feeds]
    assert refs == jtok
    sched = serving.Scheduler(spec, scope, place=CPU, max_batch=4,
                              block_size=16, paged_kv=True,
                              prefill_chunk=HD_CHUNK)
    pattn.TIER_CALLS.clear()
    reqs = [sched.submit(f, HD_MNT, eos_id=1) for f in feeds[:2]]
    sched.step()
    sched.step()
    reqs.append(sched.submit(feeds[2], HD_MNT, eos_id=1))
    sched.run_until_idle(max_steps=500)
    _check(reqs, refs)
    assert sched.counters["chunked"] == 2
    assert sched.counters["chunk_passes"] == 4 + 3
    assert {"mha_block", "flash", "flash_decode_paged",
            "paged_reference"} <= set(pattn.TIER_CALLS)
    h = sched.submit(feeds[1], HD_MNT, eos_id=1, prefill_only=True,
                     request_id="h")
    sched.run_until_idle(max_steps=500)
    dec = serving.Scheduler(spec, scope, place=CPU, max_batch=4,
                            block_size=32, paged_kv=True)
    h2 = _resume(dec, h.handoff)
    dec.run_until_idle(max_steps=500)
    assert h2.status == "done" and h2.tokens == refs[1]
    sched.pool.assert_quiesced()
    dec.pool.assert_quiesced()
