"""The serving slice end to end: the port's serving.Scheduler against the
JAX package's decode.Generator and the port's own sequential Generator,
on the same weights.

The JAX package builds a head_dim-64 transformer and runs its startup;
its weights are carried into the port with `convert.load_params`.  Both
packages run with flash_attention="interpret" and attn_decode_min_keys
200, so that with src_len 128 and a 256-slot cache a 200-token prompt
window prefills through the streaming flash tier (kernel #3: 200 is off
the 128 grid), a 128-token window through mha_block, the dense step
through flash_decode and mha_decode, and the paged step through
flash_decode_paged (kernel #7).  The JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.

The bar is the JAX package's serving contract: every request's greedy
tokens equal the sequential Generator's, here in both packages, on both
decode paths (the host pool's dense gather and the device pool's paged
step), through mid-flight admission, a prefix-cache hit, evict-and-replay
and pool pressure.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import decode as jdecode
from paddle_tpu import flags as jflags
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, flags as pflags
from paddle_tpu_torch import serving, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import attention_ops as pattn

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
S, MAX_LEN, MNT, EOS = 128, 256, 8, 1
GATE = (("flash_attention", "interpret"), ("attn_decode_min_keys", 200))


@pytest.fixture(autouse=True)
def _fresh_port():
    for name, value in GATE:
        pflags.set(name, value)
    with testing.fresh_programs():
        yield
    for name, _ in GATE:
        pflags.reset(name)


def _feeds(window, n, seed):
    """n single-sequence feeds: ragged sources and prompts.  The first four
    prompts end on a 16-row block edge, so their first decode step needs
    a fresh block (the pool-pressure test)."""
    rng = np.random.RandomState(seed)
    edge = window // 16 * 16
    out = []
    for i in range(n):
        out.append({
            "src_ids": rng.randint(2, 64, size=(1, S)).astype(np.int64),
            "src_lens": np.asarray([rng.randint(S // 2, S + 1)], np.int64),
            "trg_ids": rng.randint(2, 64, size=(1, window)).astype(np.int64),
            "prefix_lens": np.asarray(
                [edge - 16 * (i % 2) if i < 4
                 else rng.randint(window - 40, window + 1)], np.int64),
        })
    return out


def _until_eos(row):
    row = [int(t) for t in row]
    return row[:row.index(EOS) + 1] if EOS in row else row


def _sharpen(jscope):
    """Scale the startup's weight matrices and the embedding by 3: at the
    startup's scale this model's greedy tokens collapse onto one token
    within a few steps, and equal tokens would prove little."""
    import jax.numpy as jnp

    for n in jscope.local_var_names():
        if n.endswith(".w_0") or n == "src_word_emb":
            jscope.set_var(n, jnp.asarray(jscope.find_var(n)) * 3.0)


class _World:
    """One window's specs, weights and reference tokens."""

    def __init__(self, window):
        self.window = window
        self.feeds = _feeds(window, 8, window)
        for name, value in GATE:
            jflags.set(name, value)
        try:
            with junique.guard():
                jspec = JT.build_decode(JT.TransformerConfig(**SMALL),
                                        src_len=S, prefix_len=window,
                                        max_len=MAX_LEN)
            jscope = JScope()
            jgen = jdecode.Generator(jspec, scope=jscope)
            _sharpen(jscope)
            batched = {k: np.concatenate([f[k] for f in self.feeds])
                       for k in self.feeds[0]}
            jtok = np.asarray(jgen.generate(batched, MNT, eos_id=EOS))
        finally:
            for name, _ in GATE:
                jflags.reset(name)
        self.jax_tokens = [_until_eos(r) for r in jtok]
        self.spec = PT.build_decode(PT.TransformerConfig(**SMALL), src_len=S,
                                    prefix_len=window, max_len=MAX_LEN)
        progs = [self.spec.prefill_program, self.spec.step_program]
        declared = {v.name for p in progs for v in p.list_vars()
                    if v.persistable}
        self.scope = pt.Scope()
        convert.load_params(self.scope, {
            n: np.asarray(jscope.find_var(n))
            for n in jscope.local_var_names() if n in declared},
            pt.CPUPlace(), progs)


@pytest.fixture(scope="module", params=[200, 128], ids=["flash200",
                                                         "mha128"])
def world(request):
    w = _World(request.param)
    for name, value in GATE:
        pflags.set(name, value)
    try:
        gen = pdecode.Generator(w.spec, scope=w.scope, place=pt.CPUPlace())
        w.seq_tokens = [_until_eos(gen.generate(f, MNT, eos_id=EOS)[0])
                        for f in w.feeds]
    finally:
        for name, _ in GATE:
            pflags.reset(name)
    return w


def _sched(world, paged, **kw):
    kw.setdefault("max_batch", 4)
    return serving.Scheduler(world.spec, scope=world.scope,
                             place=pt.CPUPlace(), block_size=16,
                             paged_kv=paged, **kw)


def _check_tokens(world, reqs, idx):
    for r, i in zip(reqs, idx, strict=True):
        assert r.status == "done", (i, r.status, r.error)
        assert r.tokens == world.seq_tokens[i], f"request {i} vs sequential"
        assert r.tokens == world.jax_tokens[i], f"request {i} vs JAX"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_scheduler_tokens_equal_both_generators(world, paged):
    """Mid-flight admission, a shared prompt (a prefix-cache hit), an
    evicted request that replays, cancel(), an expired deadline and
    request_id dedup; every served request's tokens equal the sequential
    Generator's in both packages."""
    sched = _sched(world, paged, num_blocks=96)
    pattn.TIER_CALLS.clear()
    idx = [0, 1, 2, 3]
    reqs = [sched.submit(world.feeds[i], MNT, eos_id=EOS,
                         request_id=f"r{i}") for i in idx]
    assert sched.submit(world.feeds[0], MNT, eos_id=EOS,
                        request_id="r0") is reqs[0]
    for _ in range(3):
        sched.step()
    # the second wave joins mid-flight; feed 0 again hits the prefix cache
    idx2 = [4, 5, 6, 0]
    reqs += [sched.submit(world.feeds[i], MNT, eos_id=EOS) for i in idx2]
    gone = sched.submit(world.feeds[7], MNT, eos_id=EOS)
    gone.cancel()
    late = sched.submit(world.feeds[7], MNT, eos_id=EOS, deadline_ms=0.0)
    sched.step()
    victim = next(r for r in reqs if r.status == "running")
    sched.preempt(victim, evict=True)
    sched.run_until_idle(max_steps=500)

    _check_tokens(world, reqs, idx + idx2)
    assert gone.status == "cancelled" and late.status == "expired"
    st = sched.stats()
    assert st["paged_kv"] is paged
    assert st["completed"] == 8 and st["errors"] == 0
    assert st["cancelled"] == 1 and st["expired"] == 1
    assert st["dedup_hits"] == 1 and st["replays"] >= 1
    assert st["pool"]["prefix_hits"] >= 1
    assert st["ttft_ms"]["count"] == 8
    tiers = set(pattn.TIER_CALLS)
    assert ("flash_decode_paged" in tiers) is paged
    assert ("flash" in tiers) is (world.window == 200)
    sched.pool.assert_quiesced()
    assert sched.pool.used_blocks() == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pool_pressure_evicts_and_replays(world, paged):
    """The JAX package's pool-pressure case (tests/test_serving_scheduler.py
    :179) with a smaller pool: six tenants with 1-3 token prompts decode 16
    tokens each through 4 slots over 14 blocks of 4 rows, so _ensure_block
    has to preempt victims, which wait for room and replay by teacher
    forcing; an explicit eviction on top.  Tokens equal the sequential
    Generator's, and no block leaks (ROADMAP.md C7: the JAX loop livelocks
    at this size and leaks a block at its own)."""
    feeds = []
    for i, f in enumerate(world.feeds[:6]):
        feeds.append(dict(f, prefix_lens=np.asarray([1 + i % 3], np.int64)))
    gen = pdecode.Generator(world.spec, scope=world.scope,
                            place=pt.CPUPlace())
    # no eos: every tenant decodes all 16 tokens, so the pool must give
    refs = [gen.generate(f, 16, eos_id=-1)[0].tolist() for f in feeds]
    sched = serving.Scheduler(world.spec, scope=world.scope,
                              place=pt.CPUPlace(), max_batch=4, block_size=4,
                              num_blocks=14, prefix_cache=False,
                              paged_kv=paged)
    reqs = [sched.submit(f, 16, eos_id=-1) for f in feeds]
    for _ in range(4):
        sched.step()
    sched.preempt(next(r for r in reqs if r.status == "running"),
                  evict=True)
    sched.run_until_idle(max_steps=2000)
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        assert r.status == "done", (i, r.status, r.error)
        assert r.tokens == ref, i
    assert sched.counters["preemptions"] >= 2
    assert sched.counters["replays"] >= 2
    sched.pool.assert_quiesced()


def test_export_import_resumes_on_another_scheduler(world):
    a = _sched(world, True, num_blocks=64)
    reqs = [a.submit(world.feeds[i], MNT, eos_id=EOS) for i in (1, 2)]
    for _ in range(3):
        a.step()
    records = a.export_requests(cancel=True)
    a.run_until_idle()
    b = _sched(world, False, num_blocks=64)
    moved = b.import_requests(records)
    b.run_until_idle(max_steps=500)
    assert [r.status for r in reqs] == ["cancelled"] * 2
    _check_tokens(world, moved, (1, 2))
    assert b.counters["imported"] == 2 and b.counters["replays"] == 2


def test_background_loop_streams_tokens(world):
    sched = _sched(world, True, num_blocks=64).start()
    try:
        req = sched.submit(world.feeds[3], MNT, eos_id=EOS)
        streamed = list(req.stream(timeout=60))
        assert req.result(timeout=60).tolist() == streamed
    finally:
        sched.close()
    assert streamed == world.seq_tokens[3]


def test_later_slices_and_the_card_default_raise():
    spec = PT.build_decode(PT.TransformerConfig(**SMALL), src_len=S,
                           prefix_len=8, max_len=MAX_LEN)
    if torch.cuda.is_available():
        assert serving.Scheduler(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CPUPlace"):
            serving.Scheduler(spec)
    cpu = pt.CPUPlace()
    # spec decode and chunked prefill are ported and, as in the JAX
    # package, ride the paged pool only; admission is still a later slice
    for kw in (dict(spec_decode=True), dict(prefill_chunk=4)):
        with pytest.raises(ValueError, match="paged"):
            serving.Scheduler(spec, place=cpu, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serving.Scheduler(spec, place=cpu, admission=True)
    sched = serving.Scheduler(spec, place=cpu)
    feed = _feeds(8, 1, 0)[0]
    for kw in (dict(prefill_only=True), dict(kv_payload={})):
        req = sched.submit(feed, 4, **kw)
        assert req.status == "queued"
        assert req.prefill_only is ("prefill_only" in kw)
        assert (req._kv_payload == {}) is ("kv_payload" in kw)
    sched.close()
    sched.drain()
    with pytest.raises(serving.SchedulerDraining):
        sched.submit(feed, 4)
    assert serving.prompt_key(feed) == serving.prompt_key(
        {k: v.copy() for k, v in feed.items()})
