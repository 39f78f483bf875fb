"""The int8 serving tier in the port against the JAX package's: the twins
of tests/test_serving_int8.py, on the JAX package's weights.

`build_draft(tier="int8")` freezes both decode programs to
quantized_matmul on a clone of the target's scope and serves as the
Scheduler's target.  The port's frozen programs and baked scope equal the
JAX package's (bit for bit), its sequential int8 Generator and its int8
Scheduler give the JAX package's tokens on the same feeds at the same
batch composition, and the JAX tests' agreement rates hold: the
activation scale is one abs-max over the whole batch, so batched rows
couple and a Scheduler's int8 tokens agree with a sequential run at a
rate, not token for token (ROADMAP C4).
"""

import numpy as np
import pytest

from paddle_tpu import decode as jdecode
from paddle_tpu import serving as jserving
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, serving, testing
from paddle_tpu_torch.models import transformer as PT

S, P, MAXLEN, V, NEW, STREAMS = 8, 3, 24, 40, 8, 4
CPU = pt.CPUPlace()


def _cfg(T):
    cfg = T.tiny(vocab=V, max_length=16)
    cfg.n_layer = 2
    return cfg


def _mk_feed(seed):
    r = np.random.RandomState(seed)
    return {
        "src_ids": r.randint(2, V, (1, S)).astype(np.int64),
        "src_lens": np.full(1, S, np.int64),
        "trg_ids": r.randint(2, V, (1, P)).astype(np.int64),
        "prefix_lens": np.full(1, P, np.int64),
    }


class _World:
    """Both packages' float decode specs on the JAX startup's weights, and
    each package's int8 tier built from them."""

    def __init__(self):
        with junique.guard():
            self.jspec = JT.build_decode(_cfg(JT), src_len=S, prefix_len=P,
                                         max_len=MAXLEN)
        self.jscope = JScope()
        self.jgen = jdecode.Generator(self.jspec, scope=self.jscope)
        self.spec = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                                    max_len=MAXLEN)
        progs = [self.spec.prefill_program, self.spec.step_program]
        declared = {v.name for p in progs for v in p.list_vars()
                    if v.persistable}
        self.scope = pt.Scope()
        convert.load_params(self.scope, {
            n: np.asarray(self.jscope.find_var(n))
            for n in self.jscope.local_var_names() if n in declared},
            CPU, progs)
        self.gen = pdecode.Generator(self.spec, scope=self.scope, place=CPU)
        with junique.guard():
            self.jspec8, self.jscope8 = JT.build_draft(
                _cfg(JT), src_len=S, prefix_len=P, max_len=MAXLEN,
                tier="int8", scope=self.jscope)
        self.spec8, self.scope8 = PT.build_draft(
            _cfg(PT), src_len=S, prefix_len=P, max_len=MAXLEN, tier="int8",
            scope=self.scope)


# module-scoped: every test only reads the weight scopes
@pytest.fixture(scope="module")
def world():
    with testing.fresh_programs():
        return _World()


def _rate(got, ref):
    n = min(len(got), len(ref))
    return float(np.mean(np.asarray(got[:n]) == np.asarray(ref[:n])))


def test_int8_spec_serves_from_scheduler_with_agreement(world):
    """Every request done at full length through the stock Scheduler; one
    batched round agrees with the float tier and with a sequential int8
    Generator on the same frozen scope at the JAX test's rate (0.75)."""
    feeds = [_mk_feed(500 + i) for i in range(STREAMS)]
    refs = [world.gen.generate(f, NEW, eos_id=-1)[0].tolist() for f in feeds]
    gen8 = pdecode.Generator(world.spec8, scope=world.scope8, place=CPU)
    refs8 = [gen8.generate(f, NEW, eos_id=-1)[0].tolist() for f in feeds]
    sched = serving.Scheduler(world.spec8, scope=world.scope8, place=CPU,
                              max_batch=STREAMS)
    try:
        reqs = [sched.submit(f, NEW, eos_id=-1) for f in feeds]
        sched.run_until_idle(max_steps=10000)
        assert all(r.status == "done" for r in reqs), \
            [r.status for r in reqs]
        assert all(len(r.tokens) == NEW for r in reqs)
        agree_float = [_rate(r.tokens, ref) for r, ref in zip(reqs, refs)]
        agree_seq = [_rate(r.tokens, ref) for r, ref in zip(reqs, refs8)]
        assert np.mean(agree_float) >= 0.75, agree_float
        assert np.mean(agree_seq) >= 0.75, agree_seq
    finally:
        sched.close()


def test_int8_scope_is_cloned_not_shared(world):
    """Freezing does not touch the float world: the int8 scope is a clone,
    the float scope holds no int8 artifact, the clone the baked grids and
    their sidecars."""
    assert world.scope8 is not world.scope
    assert not [n for n in world.scope.local_var_names() if "int8" in n]
    assert [n for n in world.scope8.local_var_names() if "int8" in n]


def test_int8_spec_and_scope_equal_the_jax_packages(world):
    """The frozen prefill and step programs equal the JAX package's op for
    op (every `mul` a quantized_matmul), and the frozen
    scope's grids and sidecars equal the JAX one's bit for bit."""
    for which in ("prefill_program", "step_program"):
        assert getattr(world.spec8, which).to_dict() == \
            getattr(world.jspec8, which).to_dict()
    types = [op.type for op in world.spec8.step_program.global_block().ops]
    assert "mul" not in types and types.count("quantized_matmul") > 0
    touched = PT._int8_touched(world.spec8.step_program) | \
        PT._int8_touched(world.spec8.prefill_program)
    assert touched
    for n in sorted(touched):
        np.testing.assert_array_equal(world.scope8.find_var(n).numpy(),
                                      np.asarray(world.jscope8.find_var(n)),
                                      n)


@pytest.mark.parametrize("n_requests", [STREAMS, STREAMS - 1])
def test_int8_scheduler_tokens_equal_the_jax_scheduler(world, n_requests):
    """The same feeds at the same batch composition through both
    packages' int8 Schedulers, and two of them one at a time through both
    packages' sequential int8 Generators: equal tokens.  The activation scales
    couple a batch's rows, idle slots included, so the comparison holds
    the composition fixed; with 3 requests in a bucket of 4 the idle
    slot's rows must be the JAX Scheduler's too."""
    feeds = [_mk_feed(700 + i) for i in range(n_requests)]
    jgen8 = jdecode.Generator(world.jspec8, scope=world.jscope8)
    gen8 = pdecode.Generator(world.spec8, scope=world.scope8, place=CPU)
    for f in feeds[:2]:
        assert gen8.generate(f, NEW, eos_id=-1)[0].tolist() == \
            np.asarray(jgen8.generate(f, max_new_tokens=NEW,
                                      eos_id=-1))[0].tolist()
    jsched = jserving.Scheduler(world.jspec8, scope=world.jscope8,
                                max_batch=STREAMS)
    sched = serving.Scheduler(world.spec8, scope=world.scope8, place=CPU,
                              max_batch=STREAMS)
    try:
        jreqs = [jsched.submit(f, NEW, eos_id=-1) for f in feeds]
        jsched.run_until_idle(max_steps=10000)
        reqs = [sched.submit(f, NEW, eos_id=-1) for f in feeds]
        sched.run_until_idle(max_steps=10000)
        for i, (r, jr) in enumerate(zip(reqs, jreqs)):
            assert r.status == jr.status == "done", (i, r.status, jr.status)
            assert r.tokens == [int(t) for t in jr.tokens], i
    finally:
        sched.close()
        jsched.close()
