"""The GRU translator (models/machine_translation.py) against the JAX
package's (paddle_tpu/models/machine_translation.py), trained and served.

At a small size (src and trg 12, dict 40, emb 16, batch 4; hidden 24,
where every attention takes the composite, and hidden 64 with
`flash_attention="interpret"`, where the JAX package runs its Pallas
kernels in interpret mode and the port its kernel wrappers' plain
versions: the flash tier in training, and in decode kernel #6
(`flash_decode`) over 12 keys, fewer than one key block):

  * `build()` + Adam and `build_decode()`'s prefill and step programs are
    the JAX package's, op for op and var for var, in float32 and (the
    train program) under bf16 AMP;
  * from the JAX startup's persistables (`convert.load_params`), three
    Adam steps give the same losses within rtol 2e-4 and the first
    step's param grads within rtol 1e-4 / atol 1e-5; the AMP step's loss
    within 2e-2 (the JAX package's input projection runs with float32
    operands on the CPU, tests/jax_reference.py); jit = interpret;
  * served from the same weights through `decode.Generator` (the GRU
    hidden carried as a state, the encoder projection seeded by the
    prefill, bos first): each teacher-forced step's logits within 2e-4 of
    the train program's at that position (the JAX test's check,
    tests/test_decode.py:188-231); greedy and beam-4 tokens equal to the
    JAX Generator's, beam scores within 1e-5, on the jit path and the
    interpreter alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from jax_reference import f32_rnn_projection
from paddle_tpu import amp as jamp
from paddle_tpu import decode as jdecode
from paddle_tpu import flags as jflags
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import machine_translation as JM
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import convert, decode as pdecode
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import testing
from paddle_tpu_torch.models import machine_translation as PM
from paddle_tpu_torch.ops import attention_ops as pattn

S, V, E, BATCH, STEPS, LR = 12, 40, 16, 4, 3, 1e-3
NEW = 8
WIDTHS = {"composite": 24, "interpret": 64}


@pytest.fixture(autouse=True)
def _fresh_port(monkeypatch):
    f32_rnn_projection(monkeypatch)
    with testing.fresh_programs():
        yield
    for f in (jflags, pflags):
        f.reset("flash_attention")


def _tier(tier):
    """Route both packages' attention: the default gate, or "interpret"."""
    for f in (jflags, pflags):
        if tier == "interpret":
            f.set("flash_attention", "interpret")
        else:
            f.reset("flash_attention")


def _build(pkg, model, amp, guard, hidden, use_amp, optimize=True):
    main, startup = pkg.Program(), pkg.Program()
    pg = None
    with pkg.program_guard(main, startup), guard():
        loss, logits = model.build(src_seq_len=S, trg_seq_len=S,
                                   dict_size=V, emb_dim=E, hidden_dim=hidden)
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        if optimize:
            _, pg = pkg.optimizer.Adam(
                LR, multi_precision=use_amp).minimize(loss)
    return main, startup, loss, logits, pg


def _jax_build(hidden, use_amp=False, optimize=True):
    return _build(fluid, JM, jamp, jun.guard, hidden, use_amp, optimize)


def _port_build(hidden, use_amp=False):
    return _build(pt, PM, pamp, pt.unique_name.guard, hidden, use_amp)


def _feeds(n=STEPS):
    rng = np.random.RandomState(0)
    return [{name: rng.randint(2, V, shape).astype(np.int64)
             for name, (shape, _) in JM.feed_shapes(BATCH, S, S).items()}
            for _ in range(n)]


def _normalized(prog):
    """The program dict with integer var dtypes read as one kind (the JAX
    package narrows int64 to int32 with x64 off)."""
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _same_program(j, p):
    jd, pd = _normalized(j), _normalized(p)
    jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in pops] == [o["type"] for o in jops]
    for jo, po in zip(jops, pops):
        assert po == jo, jo["type"]
    assert pd == jd


def _jax_train(tier, use_amp, steps):
    _tier(tier)
    main, startup, loss, logits, pg = _jax_build(WIDTHS[tier], use_amp)
    scope = JScope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable}
    grads = [g.name for _, g in pg]
    losses, first = [], None
    for step, feed in enumerate(_feeds()[:steps]):
        outs = exe.run(main, feed=feed, scope=scope,
                       fetch_list=[loss.name] + (grads if not step else []))
        losses.append(float(np.asarray(outs[0], np.float32).ravel()[0]))
        if not step:
            first = {n: np.asarray(o, np.float32)
                     for n, o in zip(grads, outs[1:])}
    _tier("composite")
    return dict(params=params, losses=losses, grads=first)


@pytest.fixture(scope="module", params=list(WIDTHS))
def jax_f32(request):
    with testing.fresh_programs():
        run = _jax_train(request.param, False, STEPS)
    run["tier"] = request.param
    return run


def _port_train(jrun, tier, use_amp, steps, mode=None):
    _tier(tier)
    main, _, loss, _, pg = _port_build(WIDTHS[tier], use_amp)
    scope = pt.Scope()
    convert.load_params(scope, jrun["params"], pt.CPUPlace(), [main])
    exe = pt.Executor(pt.CPUPlace(), mode=mode)
    grads = [g.name for _, g in pg]
    losses, first = [], None
    pattn.TIER_CALLS.clear()
    for step, feed in enumerate(_feeds()[:steps]):
        outs = exe.run(main, feed=feed, scope=scope,
                       fetch_list=[loss] + (grads if not step else []))
        losses.append(float(outs[0].ravel()[0]))
        if not step:
            first = dict(zip(grads, outs[1:]))
    return dict(losses=losses, grads=first, tiers=dict(pattn.TIER_CALLS))


@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "amp"])
def test_training_programs_are_identical(use_amp):
    jm, js, _, _, jpg = _jax_build(WIDTHS["composite"], use_amp)
    pm, ps, _, _, ppg = _port_build(WIDTHS["composite"], use_amp)
    _same_program(jm, pm)
    _same_program(js, ps)
    assert [(a.name, b.name) for a, b in ppg] == \
        [(a.name, b.name) for a, b in jpg]
    grus = [op for op in pm.global_block().ops if op.type == "fused_gru"]
    assert [op.attrs["is_reverse"] for op in grus] == [False, True, False]


def test_decode_programs_are_identical():
    """build_decode: the prefill (encoder + attention kv projection) and the
    step (embedding of prev_ids, the GRU carried from dec_h, attention,
    the output projection) are the JAX package's; the spec's states and
    fetches name the same vars."""
    kw = dict(src_seq_len=S, dict_size=V, emb_dim=E,
              hidden_dim=WIDTHS["composite"])
    jspec = JM.build_decode(**kw)
    pspec = PM.build_decode(**kw)
    for name in ("prefill_program", "prefill_startup", "step_program",
                 "step_startup"):
        _same_program(getattr(jspec, name), getattr(pspec, name))
    assert pspec.prefill_logits is None and pspec.max_len is None
    assert pspec.step_fetches() == jspec.step_fetches()
    assert pspec.prefill_fetches() == jspec.prefill_fetches()
    assert [(s.feed, s.init_from, s.update, s.zeros) for s in pspec.states] \
        == [(s.feed, s.init_from, s.update, s.zeros) for s in jspec.states]


def test_adam_losses_and_grads_match_jax(jax_f32):
    tier = jax_f32["tier"]
    got = _port_train(jax_f32, tier, False, STEPS)
    np.testing.assert_allclose(got["losses"], jax_f32["losses"], rtol=2e-4)
    assert sorted(got["grads"]) == sorted(jax_f32["grads"])
    for name, want in jax_f32["grads"].items():
        np.testing.assert_allclose(got["grads"][name], want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # Sq = Sk = 12: the composite by default; the flash tier's plain
    # version under "interpret" (Sk % 128 != 0 keeps it off mha_block)
    want = "flash" if tier == "interpret" else "composite"
    assert set(got["tiers"]) == {want}, got["tiers"]


def test_amp_loss_matches_jax():
    with testing.fresh_programs():
        jrun = _jax_train("composite", True, 1)
    got = _port_train(jrun, "composite", True, 1)
    np.testing.assert_allclose(got["losses"], jrun["losses"], rtol=2e-2)


def test_jit_path_equals_the_interpreter(jax_f32):
    tier = jax_f32["tier"]
    jit = _port_train(jax_f32, tier, False, STEPS, mode="jit")
    eager = _port_train(jax_f32, tier, False, STEPS, mode="interpret")
    assert jit["losses"] == eager["losses"]


# ------------------------------------------------------------- serving


@pytest.fixture(scope="module", params=list(WIDTHS))
def served(request):
    """The JAX train program's startup weights, times 3 so that greedy
    and beam tokens do not tie; the JAX Generator and the port's (jit and
    interpret) on them, and the train program's logits on one batch."""
    tier = request.param
    hidden = WIDTHS[tier]
    with testing.fresh_programs():
        _tier(tier)
        main, startup, _, logits, _ = _jax_build(hidden, optimize=False)
        jscope = JScope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=jscope)
        for n in jscope.local_var_names():
            if n.endswith((".w_0", "_wx", "_wh", "_w")):
                jscope.set_var(n, jscope.find_var(n) * 3.0)
        feed = _feeds(1)[0]
        (ref,) = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=[logits.name], scope=jscope)
        kw = dict(src_seq_len=S, dict_size=V, emb_dim=E, hidden_dim=hidden)
        jgen = jdecode.Generator(JM.build_decode(**kw), scope=jscope)
        spec = PM.build_decode(**kw)
        progs = [spec.prefill_program, spec.step_program]
        declared = {v.name for p in progs for v in p.list_vars()
                    if v.persistable}
        params = {n: np.asarray(jscope.find_var(n))
                  for n in jscope.local_var_names() if n in declared}
        gens = {}
        for mode in ("jit", "interpret"):
            scope = pt.Scope()
            convert.load_params(scope, params, pt.CPUPlace(), progs)
            gens[mode] = pdecode.Generator(spec, scope=scope,
                                           place=pt.CPUPlace(), mode=mode)
        _tier("composite")
    return dict(tier=tier, jgen=jgen, gens=gens, feed=feed,
                ref=np.asarray(ref).reshape(BATCH, S, V))


def test_teacher_forced_steps_equal_the_train_logits(served):
    """Step t, fed trg[:, t], gives the train program's logits at t within
    2e-4: the carried GRU hidden is the whole decode state."""
    _tier(served["tier"])
    gen, feed = served["gens"]["jit"], served["feed"]
    pattn.TIER_CALLS.clear()
    _, states, lengths, pl = gen._prefill({"src_ids": feed["src_ids"]})
    assert pl is None                     # bos first: no prefill logits
    for t in range(S):
        lg, states = gen._step(feed["trg_ids"][:, t], lengths, states, {})
        err = np.abs(lg.float().numpy() - served["ref"][:, t]).max()
        assert err < 2e-4, (t, err)
    # every step's attention: Sq = 1 over 12 keys
    want = ("flash_decode" if served["tier"] == "interpret"
            else "composite")
    assert pattn.TIER_CALLS == {want: S}, pattn.TIER_CALLS


def test_greedy_and_beam_tokens_equal_the_jax_generators(served):
    _tier(served["tier"])
    src = {"src_ids": served["feed"]["src_ids"]}
    jgreedy = np.asarray(served["jgen"].generate(src, NEW, eos_id=-1))
    jtok, jscores = served["jgen"].generate(src, NEW, method="beam",
                                            beam_size=4, eos_id=-1)
    for mode, gen in served["gens"].items():
        greedy = gen.generate(src, NEW, eos_id=-1)
        np.testing.assert_array_equal(greedy, jgreedy, err_msg=mode)
        beam1, _ = gen.generate(src, NEW, method="beam", beam_size=1,
                                eos_id=-1)
        np.testing.assert_array_equal(beam1[:, 0], greedy, err_msg=mode)
        tok, scores = gen.generate(src, NEW, method="beam", beam_size=4,
                                   eos_id=-1)
        assert tok.shape == (BATCH, 4, NEW)
        np.testing.assert_array_equal(tok, np.asarray(jtok), err_msg=mode)
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0,
                                   atol=1e-5, err_msg=mode)


def test_load_params_carries_the_train_scope_into_both_decode_programs():
    """The train scope's weights (explicit names: src_emb_w, the three
    GRUs' _wx/_wh and biases, attn_q/attn_kv, dec_proj) serve both decode
    programs unchanged, bit for bit."""
    hidden = WIDTHS["composite"]
    main, startup, *_ = _jax_build(hidden)
    jscope = JScope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=jscope)
    spec = PM.build_decode(src_seq_len=S, dict_size=V, emb_dim=E,
                             hidden_dim=hidden)
    progs = [spec.prefill_program, spec.step_program]
    declared = {v.name for p in progs for v in p.list_vars()
                if v.persistable}
    trained = {v.name for v in main.list_vars() if v.persistable
               and not any(k in v.name for k in ("_moment", "_pow_acc",
                                                 "learning_rate"))}
    assert declared == trained
    assert {"enc_gru_fwd_wx", "enc_gru_bwd_wh", "dec_gru_wx",
            "dec_gru_b"} <= declared
    scope = pt.Scope()
    convert.load_params(scope, {n: np.asarray(jscope.find_var(n))
                                for n in declared}, pt.CPUPlace(), progs)
    for n in declared:
        np.testing.assert_array_equal(
            scope.find_var(n).numpy(),
            np.asarray(jnp.asarray(jscope.find_var(n))), err_msg=n)
