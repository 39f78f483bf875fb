"""The stacked-LSTM text classifier (models/stacked_lstm.py) against the
JAX package's (paddle_tpu/models/stacked_lstm.py).

At a small size (seq 12, dict 50, emb 16, hidden 24, two stacked LSTMs as
bench.py's stacked_lstm leg stacks them, the second reversed, batch 4),
`build()` + Adam gives the same Program in both packages, op for op and
var for var, in float32 and under bf16 AMP with multi_precision.  From
the JAX startup's persistables (carried with `convert.load_params`, which
takes the whole JAX scope: weights, Adam's moments and beta powers, the
learning rate, f32 master weights), three Adam steps give the same losses
within rtol 2e-4 and the first step's param grads within rtol 1e-4 / atol
1e-5; the AMP step's loss agrees within 2e-2 (both packages round to
bfloat16 at other points; the JAX package's input projection runs with
float32 operands on the CPU, tests/jax_reference.py).  The Executor's jit
path gives the interpreter's losses exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from jax_reference import f32_rnn_projection
from paddle_tpu import amp as jamp
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import stacked_lstm as JS
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.models import stacked_lstm as PS

SMALL = dict(seq_len=12, dict_size=50, emb_dim=16, hidden_dim=24,
             stacked_num=2)
BATCH, STEPS, LR = 4, 3, 1e-3


@pytest.fixture(autouse=True)
def _fresh_port(monkeypatch):
    f32_rnn_projection(monkeypatch)
    with testing.fresh_programs():
        yield


def _build(pkg, model, amp, guard, use_amp):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        loss, prob, acc = model.build(**SMALL)
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        _, pg = pkg.optimizer.Adam(LR, multi_precision=use_amp).minimize(
            loss)
    return main, startup, loss, pg


def _jax_build(use_amp):
    return _build(fluid, JS, jamp, jun.guard, use_amp)


def _port_build(use_amp):
    return _build(pt, PS, pamp, pt.unique_name.guard, use_amp)


def _feeds():
    """bench.py's draws at this size: each word batch twice, labels
    independent."""
    rng = np.random.RandomState(0)
    words = rng.randint(0, SMALL["dict_size"], (STEPS, BATCH,
                                                SMALL["seq_len"]))
    labels = rng.randint(0, 2, (STEPS, BATCH, 1))
    return [{"words": words[i].astype(np.int64),
             "label": labels[i].astype(np.int64)} for i in range(STEPS)]


def _normalized(prog):
    """The program dict with integer var dtypes read as one kind (the JAX
    package narrows int64 to int32 with x64 off)."""
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _jax_train(use_amp, steps):
    main, startup, loss, pg = _jax_build(use_amp)
    scope = JScope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable}
    grads = [g.name for _, g in pg]
    losses, first = [], None
    for step, feed in enumerate(_feeds()[:steps]):
        # every step fetches the grads: one fetch list, one compiled plan
        outs = exe.run(main, feed=feed, scope=scope,
                       fetch_list=[loss.name] + grads)
        losses.append(float(np.asarray(outs[0], np.float32).ravel()[0]))
        if not step:
            first = {n: np.asarray(o, np.float32)
                     for n, o in zip(grads, outs[1:])}
    return dict(params=params, losses=losses, grads=first)


@pytest.fixture(scope="module")
def jax_f32():
    with testing.fresh_programs():
        return _jax_train(False, STEPS)


def _port_train(jrun, use_amp, steps, mode=None):
    main, _, loss, pg = _port_build(use_amp)
    scope = pt.Scope()
    convert.load_params(scope, jrun["params"], pt.CPUPlace(), [main])
    exe = pt.Executor(pt.CPUPlace(), mode=mode)
    grads = [g.name for _, g in pg]
    losses, first = [], None
    for step, feed in enumerate(_feeds()[:steps]):
        outs = exe.run(main, feed=feed, scope=scope,
                       fetch_list=[loss] + (grads if not step else []))
        losses.append(float(outs[0].ravel()[0]))
        if not step:
            first = dict(zip(grads, outs[1:]))
    return dict(losses=losses, grads=first, scope=scope, main=main)


@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "amp"])
def test_programs_are_identical(use_amp):
    """build + Adam.minimize: the same main and startup programs, with one
    fused_lstm (and its grad) a layer, the second reversed, and the max
    over time as reduce_max."""
    jm, js, _, jpg = _jax_build(use_amp)
    pm, ps, _, ppg = _port_build(use_amp)
    for j, p in ((jm, pm), (js, ps)):
        jd, pd = _normalized(j), _normalized(p)
        jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
        assert [o["type"] for o in pops] == [o["type"] for o in jops]
        for jo, po in zip(jops, pops):
            assert po == jo, jo["type"]
        assert pd == jd
    assert [(a.name, b.name) for a, b in ppg] == \
        [(a.name, b.name) for a, b in jpg]
    lstms = [op for op in pm.global_block().ops if op.type == "fused_lstm"]
    assert [op.attrs["is_reverse"] for op in lstms] == [False, True]
    assert sum(op.type == "reduce_max_grad"
               for op in pm.global_block().ops) == 1


def test_adam_losses_and_grads_match_jax(jax_f32):
    got = _port_train(jax_f32, False, STEPS)
    np.testing.assert_allclose(got["losses"], jax_f32["losses"], rtol=2e-4)
    assert sorted(got["grads"]) == sorted(jax_f32["grads"])
    for name, want in jax_f32["grads"].items():
        np.testing.assert_allclose(got["grads"][name], want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_amp_loss_matches_jax():
    with testing.fresh_programs():
        jrun = _jax_train(True, 1)
    got = _port_train(jrun, True, 1)
    np.testing.assert_allclose(got["losses"], jrun["losses"], rtol=2e-2)
    # the bf16 parameters and their f32 master copies both came across
    masters = [n for n in jrun["params"] if "_master_" in n]
    assert masters and all(got["scope"].find_var(n) is not None
                           for n in masters)


def test_jit_path_equals_the_interpreter(jax_f32):
    jit = _port_train(jax_f32, False, STEPS, mode="jit")
    eager = _port_train(jax_f32, False, STEPS, mode="interpret")
    assert jit["losses"] == eager["losses"]


def test_load_params_carries_the_whole_jax_scope(jax_f32):
    """Every persistable of the JAX scope after its startup (weights,
    moments, beta powers, learning rate) lands in the port's scope under
    the same name, bit for bit."""
    main, _, _, _ = _port_build(False)
    scope = pt.Scope()
    convert.load_params(scope, jax_f32["params"], pt.CPUPlace(), [main])
    names = {v.name for v in main.list_vars() if v.persistable}
    assert names == set(jax_f32["params"])
    # WeightX, WeightH and Bias of each layer
    assert {f"lstm_{i}.w_{j}" for i in (0, 1) for j in (0, 1, 2)} <= names
    for n, want in jax_f32["params"].items():
        np.testing.assert_array_equal(scope.find_var(n).numpy(),
                                      np.asarray(jnp.asarray(want)))
