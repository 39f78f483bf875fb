"""The training API's tail against the JAX package: gradient clipping
(paddle_tpu_torch/clip.py), L1Decay (regularizer.py), the learning-rate
schedules (layers/learning_rate_scheduler.py, the lr_schedule op) and
`fc` over several inputs.

A small MLP is built in both packages with each clip class (an error clip
on a hidden activation; the three gradient clips through
set_gradient_clip, small enough that they bind) or with L1Decay; the
programs are equal, and from the JAX startup's weights 3 SGD steps give
the JAX package's losses and parameters within rtol 1e-5.  Each of the
seven schedules gives the JAX package's rate over 12 runs (rtol 1e-6),
noam's 0 at step 0 included.  Adam under noam_decay with a global-norm
clip runs the same on the jit path as on the interpreter (rtol 1e-5),
and its counter reads 3 after 3 runs.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import clip as jclip
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
import paddle_tpu_torch as pt
from paddle_tpu_torch import clip as pclip
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch import regularizer as preg

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _normalized(prog):
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, 12).astype(np.float32),
            "z": rng.randn(8, 6).astype(np.float32),
            "y": rng.randint(0, 4, (8, 1)).astype(np.int64)}


def _mlp(pkg, clip, decay, two_inputs=False):
    """x -> fc(tanh) -> fc -> softmax cross entropy, SGD(0.5).  -> loss"""
    L = pkg.layers
    x = L.data("x", shape=[12], dtype="float32")
    y = L.data("y", shape=[1], dtype="int64")
    if two_inputs:
        z = L.data("z", shape=[6], dtype="float32")
        h = L.fc([x, z], size=16, act="tanh")
    else:
        h = L.fc(x, size=16, act="tanh")
    mods = (jclip, jreg) if pkg is fluid else (pclip, preg)
    if clip == "error":
        h.error_clip = mods[0].ErrorClipByValue(max=1e-3)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=4), y))
    grad_clip = {"value": lambda c: c.GradientClipByValue(max=0.02),
                 "norm": lambda c: c.GradientClipByNorm(clip_norm=0.05),
                 "global_norm": lambda c: c.GradientClipByGlobalNorm(
                     clip_norm=0.1)}.get(clip)
    if grad_clip is not None:
        mods[0].set_gradient_clip(grad_clip(mods[0]))
    reg = mods[1].L1Decay(0.01) if decay else None
    pkg.optimizer.SGD(0.5, regularization=reg).minimize(loss)
    return loss


def _both(clip=None, decay=False, two_inputs=False):
    """-> (JAX program, port program, JAX losses and params, port losses
    and params) after STEPS SGD steps from the JAX startup's weights."""
    jm, js = fluid.Program(), fluid.Program()
    with fluid.program_guard(jm, js), jun.guard():
        jloss = _mlp(fluid, clip, decay, two_inputs)
    pm, ps = pt.Program(), pt.Program()
    with pt.program_guard(pm, ps), pt.unique_name.guard():
        ploss = _mlp(pt, clip, decay, two_inputs)
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    params = [p.name for p in jm.global_block().all_parameters()]
    start = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jm.list_vars() if v.persistable}
    scope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    convert.load_params(scope, start, pt.CPUPlace(), [pm])
    jl, pl = [], []
    for _ in range(STEPS):
        jl.append(float(np.asarray(jexe.run(
            jm, feed=_feed(), fetch_list=[jloss.name],
            scope=jscope)[0]).ravel()[0]))
        pl.append(float(pexe.run(pm, feed=_feed(), fetch_list=[ploss],
                                 scope=scope)[0].ravel()[0]))
    jp = {n: np.asarray(jscope.find_var(n)) for n in params}
    pp = {n: scope.find_var(n).numpy() for n in params}
    return jm, pm, (jl, jp), (pl, pp), start


def _assert_trained_alike(clip=None, decay=False, two_inputs=False):
    jm, pm, (jl, jp), (pl, pp), start = _both(clip, decay, two_inputs)
    assert _normalized(pm) == _normalized(jm)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for n, want in jp.items():
        np.testing.assert_allclose(pp[n], want, rtol=1e-5, atol=1e-7,
                                   err_msg=n)
    return pm, jp, start


@pytest.mark.parametrize("clip", ["error", "value", "norm", "global_norm"])
def test_clips_train_to_the_jax_steps(clip):
    pm, _, _ = _assert_trained_alike(clip=clip)
    types = [op.type for op in pm.global_block().ops]
    want = {"error": {"clip": 1}, "value": {"clip": 4},
            "norm": {"clip_by_norm": 4},
            "global_norm": {"squared_l2_norm": 4, "sqrt": 1,
                            "elementwise_max": 1, "elementwise_div": 1,
                            "elementwise_mul": 4}}[clip]
    assert {t: types.count(t) for t in want} == want


def test_clips_bind():
    """The clips above change the update: without them the parameters
    after 3 steps differ."""
    _, clipped, _ = _assert_trained_alike(clip="global_norm")
    _, plain, _ = _assert_trained_alike()
    assert any(not np.allclose(clipped[n], plain[n]) for n in plain)


def test_l1_decay_trains_to_the_jax_steps():
    pm, _, _ = _assert_trained_alike(decay=True)
    types = [op.type for op in pm.global_block().ops]
    assert types.count("sign") == 4


def test_fc_over_two_inputs():
    """One mul a input, their sum, then the bias: the JAX program, and its
    steps."""
    pm, _, start = _assert_trained_alike(two_inputs=True)
    first = [op.type for op in pm.global_block().ops[:5]]
    assert first == ["mul", "mul", "sum", "elementwise_add", "tanh"]
    assert start["fc_0.w_0"].shape == (12, 16)
    assert start["fc_0.w_1"].shape == (6, 16)


SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 4),
    "exponential": lambda L: L.exponential_decay(0.5, 3, 0.7),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.5, 3, 0.7, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.5, 3, 0.7),
    "inverse_time": lambda L: L.inverse_time_decay(0.5, 3, 0.7,
                                                   staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.5, 8, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.5, 5, 0.01,
                                                     cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 5, 9], [0.4, 0.3, 0.2,
                                                         0.1]),
    "cosine": lambda L: L.cosine_decay(0.5, 2, 6),
}


@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_schedules_match_jax(kind):
    rates = {}
    for pkg, guard, scope in ((fluid, jun.guard, JScope()),
                              (pt, pt.unique_name.guard, pt.Scope())):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            lr = SCHEDULES[kind](pkg.layers)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        rates[pkg] = [float(np.asarray(exe.run(
            main, fetch_list=[lr.name], scope=scope)[0]).ravel()[0])
            for _ in range(12)]
        if pkg is pt:
            assert _normalized(main) == _normalized(jmain)
            assert main.global_block().ops[0].type == "increment"
        jmain = main
    np.testing.assert_allclose(rates[pt], rates[fluid], rtol=1e-6)


def test_noam_at_step_0_is_0():
    """min(inf, 0) = 0, as in the JAX lowering (a counter's first run
    reads 1: its increment comes first)."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import registry as jops
    from paddle_tpu_torch.ops import registry as pops

    attrs = {"kind": "noam", "d_model": 64.0, "warmup_steps": 4.0}
    j = jops.run_forward(jops.get_op_info("lr_schedule"),
                         {"Step": [jnp.zeros((1,), jnp.int32)]}, attrs,
                         out_names={"Out": ["lr"]})["Out"][0]
    p = pops.run_forward(pops.get_op_info("lr_schedule"),
                         {"Step": [torch.zeros(1, dtype=torch.int64)]},
                         attrs, out_names={"Out": ["lr"]},
                         device=torch.device("cpu"))["Out"][0]
    assert float(np.asarray(j)[0]) == float(p[0]) == 0.0


def test_noam_adam_with_global_norm_clip_jit_equals_interpret():
    """The counter advances once a run on both paths (3 after 3 runs), the
    update reads each run's rate, and the losses and rates agree."""
    runs = {}
    for mode in ("interpret", "jit"):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 3
        with pt.program_guard(main, startup), pt.unique_name.guard():
            L = pt.layers
            x = L.data("x", shape=[12], dtype="float32")
            y = L.data("y", shape=[1], dtype="int64")
            h = L.fc(x, size=16, act="tanh")
            loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=4), y))
            pclip.set_gradient_clip(
                pclip.GradientClipByGlobalNorm(clip_norm=0.5))
            lr = L.noam_decay(16, 2)
            pt.optimizer.Adam(lr).minimize(loss)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), mode=mode)
        exe.run(startup, scope=scope)
        runs[mode] = [[float(np.asarray(v).ravel()[0]) for v in exe.run(
            main, feed=_feed(1), fetch_list=[loss, lr], scope=scope)]
            for _ in range(STEPS)]
        counter = scope.find_var("@LR_DECAY_COUNTER@")
        assert int(counter.reshape(-1)[0]) == STEPS
    np.testing.assert_allclose(runs["jit"], runs["interpret"], rtol=1e-5)
    rates = [r[1] for r in runs["jit"]]
    want = [16 ** -0.5 * min(s ** -0.5, s * 2 ** -1.5)
            for s in range(1, STEPS + 1)]
    np.testing.assert_allclose(rates, want, rtol=1e-6)
