"""Beam search in the port against the JAX package's.

The `beam_search` op (one step, dense form) on seeded inputs: finished
beams, the first step by attr and by the IsFirstStep input, an
all-finished row and tied scores (ties go to the lower pooled index, as
`jax.lax.top_k` breaks them); `kv_cache.gather_beams`; and
`decode.Generator.generate(method="beam")` on a tiny transformer (head_dim
16: every attention takes the composite) whose JAX startup's weights,
times 3 so that the beams do not tie, are carried into the port: beam 1
gives greedy's tokens, beam 4 the JAX search's tokens with scores within
the number of steps times the bound below.

The bound is the JAX package's own float32 spread on this world, measured
here on one teacher-forced history (its greedy tokens): the largest
change of a step's log-probabilities when the same programs are compiled
at XLA's default backend optimization level instead of the suite's
(tests/conftest.py), or when every float32 weight moves by one unit in
the last place.  The weights times 3 push the logits to ~30, where one
rounding of the weights moves a step's log-probabilities by up to ~1e-3;
a port that sums in another order may differ from the reference by as
much, and must differ by no more, at every step of the history.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_reference import XLA_DEFAULT_LEVEL, jit_at_level

from paddle_tpu import decode as jdecode
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import kv_cache as jkv
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import kv_cache as pkv
from paddle_tpu_torch.ops import registry as preg

S, P, MAXLEN, V = 8, 3, 24, 40
MNT = 10


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _step_inputs(seed, b, beam, k, end_id, ties=False):
    rng = np.random.RandomState(seed)
    pre_ids = rng.randint(2, 20, size=(b, beam)).astype(np.int64)
    pre_ids[0, 1] = end_id                      # a finished beam
    pre_scores = -rng.uniform(0, 5, size=(b, beam)).astype(np.float32)
    ids = rng.randint(0, 20, size=(b, beam, k)).astype(np.int64)
    scores = -rng.uniform(0, 8, size=(b, beam, k)).astype(np.float32)
    if ties:   # few distinct values: ties across beams and candidates
        scores = -rng.randint(1, 4, size=(b, beam, k)).astype(np.float32)
        pre_scores = -rng.randint(1, 4, size=(b, beam)).astype(np.float32)
    if b > 1:
        pre_ids[-1] = end_id                    # an all-finished row
    return {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
            "scores": scores}


def _run(reg, backend, inputs, attrs):
    info = reg.get_op_info("beam_search")
    if backend == "jax":
        ins = {n: [jnp.asarray(v)] for n, v in inputs.items()}
    else:
        ins = {n: [torch.as_tensor(v)] for n, v in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs))
    return {n: np.asarray(v[0]) for n, v in outs.items()}


@pytest.mark.parametrize("case", [
    dict(seed=1),
    dict(seed=2, ties=True),
    dict(seed=3, attrs={"is_first_step": True}),
    dict(seed=4, first_input=True),
    dict(seed=5, first_input=False),
    dict(seed=6, ties=True, attrs={"is_first_step": True}),
])
def test_beam_search_op_matches_jax(case):
    b, beam, k, end_id = 3, 4, 5, 1
    inputs = _step_inputs(case["seed"], b, beam, k, end_id,
                          case.get("ties", False))
    if "first_input" in case:
        inputs["IsFirstStep"] = np.asarray([case["first_input"]])
    attrs = {"beam_size": beam, "end_id": end_id, **case.get("attrs", {})}
    j = _run(jreg, "jax", inputs, attrs)
    p = _run(preg, "torch", inputs, attrs)
    assert sorted(p) == sorted(j) == ["parent_idx", "selected_ids",
                                      "selected_scores"]
    np.testing.assert_array_equal(p["selected_ids"],
                                  j["selected_ids"].astype(np.int64))
    np.testing.assert_array_equal(p["parent_idx"], j["parent_idx"])
    np.testing.assert_array_equal(p["selected_scores"],
                                  j["selected_scores"])
    assert p["selected_ids"].dtype == np.int64
    assert p["parent_idx"].dtype == np.int32
    # the all-finished row keeps its beams
    np.testing.assert_array_equal(p["selected_ids"][-1],
                                  inputs["pre_ids"][-1])
    np.testing.assert_array_equal(p["parent_idx"][-1], np.arange(beam))


def test_beam_search_op_refusals():
    inputs = _step_inputs(7, 2, 4, 3, 1)
    with pytest.raises(ValueError, match="beam dim"):
        _run(preg, "torch", inputs, {"beam_size": 3, "end_id": 1})
    with pytest.raises(ValueError, match="K >= beam_size"):
        _run(preg, "torch", inputs, {"beam_size": 4, "end_id": 1,
                                     "is_first_step": True})


def test_gather_beams_matches_jax():
    b, k = 3, 4
    rng = np.random.RandomState(8)
    cache = rng.standard_normal((b * k, 6, 5)).astype(np.float32)
    parent = rng.randint(0, k, size=(b, k)).astype(np.int32)
    want = np.asarray(jkv.gather_beams(jnp.asarray(cache),
                                       jnp.asarray(parent), b, k))
    got = pkv.gather_beams(torch.as_tensor(cache), torch.as_tensor(parent),
                           b, k)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- Generator(beam)


def _feed():
    r = np.random.default_rng(12)
    return {
        "src_ids": r.integers(2, V, size=(2, S)).astype(np.int64),
        "src_lens": np.asarray([S, S - 3], np.int64),
        "trg_ids": r.integers(2, V, size=(2, P)).astype(np.int64),
        "prefix_lens": np.asarray([P, 1], np.int64),
    }


@pytest.fixture(scope="module")
def world():
    """The JAX Generator on its startup's weights times 3, and the port's
    on the same weights."""
    with junique.guard():
        jspec = JT.build_decode(JT.tiny(vocab=V, max_length=16), src_len=S,
                                prefix_len=P, max_len=MAXLEN)
    jscope = JScope()
    jgen = jdecode.Generator(jspec, scope=jscope)
    for n in jscope.local_var_names():
        if n.endswith(".w_0") or n.endswith("word_emb"):
            jscope.set_var(n, jscope.find_var(n) * 3.0)
    with testing.fresh_programs():
        spec = PT.build_decode(PT.tiny(vocab=V, max_length=16), src_len=S,
                               prefix_len=P, max_len=MAXLEN)
    progs = [spec.prefill_program, spec.step_program]
    declared = {v.name for p in progs for v in p.list_vars()
                if v.persistable}
    scope = pt.Scope()
    convert.load_params(scope, {n: np.asarray(jscope.find_var(n))
                                for n in jscope.local_var_names()
                                if n in declared}, pt.CPUPlace(), progs)
    return jgen, pdecode.Generator(spec, scope=scope, place=pt.CPUPlace())


def test_beam_1_gives_greedy_tokens(world):
    jgen, gen = world
    greedy = gen.generate(_feed(), MNT, eos_id=-1)
    tokens, scores = gen.generate(_feed(), MNT, method="beam", beam_size=1,
                                  eos_id=-1)
    assert tokens.shape == (2, 1, MNT) and scores.shape == (2, 1)
    np.testing.assert_array_equal(tokens[:, 0], greedy)
    np.testing.assert_array_equal(
        greedy, np.asarray(jgen.generate(_feed(), MNT, eos_id=-1)))


@pytest.mark.parametrize("eos", [-1, 1])
def test_beam_4_matches_jax(world, spread, eos):
    jgen, gen = world
    jtok, jscores = jgen.generate(_feed(), MNT, method="beam", beam_size=4,
                                  eos_id=eos)
    tok, scores = gen.generate(_feed(), MNT, method="beam", beam_size=4,
                               eos_id=eos)
    assert tok.dtype == np.int64 and tok.shape == np.asarray(jtok).shape
    np.testing.assert_array_equal(tok, np.asarray(jtok))
    # a score sums at most MNT steps' log-probabilities
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0,
                               atol=MNT * spread["bound"])
    assert (np.diff(scores, axis=1) <= 0).all()   # best beam first



def _teacher_forced_log_probs(gen, tokens):
    """[T, B, V] float64 log_softmax of the prefill's logits, then of each
    step's, feeding the history `tokens` [B, T]."""
    def log_probs(logits):
        x = np.asarray(logits.float() if torch.is_tensor(logits)
                       else logits, np.float64)
        x = x - x.max(axis=-1, keepdims=True)
        return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

    _, states, lengths, logits = gen._prefill(_feed())
    out = [log_probs(logits)]
    for t in range(tokens.shape[1] - 1):
        logits, states = gen._step(tokens[:, t], lengths, states, _feed())
        lengths += 1
        out.append(log_probs(logits))
    return np.stack(out)


def _one_ulp_scope(scope, seed):
    """A copy of a JAX scope whose float32 tensors each moved by one unit
    in the last place, up or down at random."""
    rng = np.random.RandomState(seed)
    out = JScope()
    for n in scope.local_var_names():
        v = scope.find_var(n)
        a = np.asarray(v)
        if a.dtype == np.float32 and a.size > 1:
            step = rng.choice([-1.0, 1.0], a.shape).astype(np.float32)
            v = jnp.asarray(np.nextafter(a, a + step * np.inf))
        out.set_var(n, v)
    return out


@pytest.fixture(scope="module")
def spread(world):
    """The JAX package against itself on one teacher-forced history, per
    step: compiled at XLA's default level (`levels`), and on weights one
    unit in the last place away (`ulp`); `bound`, the largest of both;
    and both packages' log-probabilities on that history."""
    jgen, gen = world
    tokens = np.asarray(jgen.generate(_feed(), MNT, eos_id=-1))
    ref = _teacher_forced_log_probs(jgen, tokens)
    other = jdecode.Generator(jgen.spec, scope=jgen.scope)
    with jit_at_level(XLA_DEFAULT_LEVEL):
        at_default = _teacher_forced_log_probs(other, tokens)
    moved = _teacher_forced_log_probs(
        jdecode.Generator(jgen.spec, scope=_one_ulp_scope(jgen.scope, 0)),
        tokens)
    levels = np.abs(at_default - ref).max(axis=(1, 2))
    ulp = np.abs(moved - ref).max(axis=(1, 2))
    return {"levels": levels, "ulp": ulp,
            "bound": float(max(levels.max(), ulp.max())), "jax": ref,
            "port": _teacher_forced_log_probs(gen, tokens)}


def test_step_log_probs_within_the_reference_spread(spread):
    """Each step's log-probabilities, port against JAX, within the JAX
    package's own spread; the measurement saw both effects."""
    assert spread["levels"].max() > 0 and spread["ulp"].max() > 0
    err = np.abs(spread["port"] - spread["jax"]).max(axis=(1, 2))
    print(f"per step: across XLA levels {spread['levels']}, one ulp of "
          f"the weights {spread['ulp']}, port vs JAX {err}")
    assert (err <= spread["bound"]).all(), (err, spread["bound"])
