"""Activation recompute (paddle_tpu_torch/recompute.py apply_recompute,
optimizer.RecomputeOptimizer, the rc_barrier op, and the executor's
`__rng_idx` draw replay) against the JAX package.

apply_recompute rewrites transformer.tiny(), bert.tiny() and the JAX
test's MLP with mid-chain checkpoints (tests/test_recompute.py:115) into
the JAX package's program, op for op and var for var (types, input and
output names, the clones' `__rng_idx`), and returns its clone count.
From the JAX startup's weights the remat programs train to the JAX
package's losses within rtol 2e-4, and to the port's own losses without
remat within 1e-5.  At dropout 0.1 each cloned dropout draws its
original's mask in the same run (equal exactly), so remat equals no
remat over 3 steps (rtol 1e-5), on the jit path and the interpreter's,
which agree.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import recompute as jrecompute
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import bert as JB
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, recompute, testing
from paddle_tpu_torch.models import bert as PB
from paddle_tpu_torch.models import transformer as PT

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _mlp(pkg, ckpts):
    x = pkg.layers.data("x", shape=[16], dtype="float32")
    lbl = pkg.layers.data("y", shape=[1], dtype="int64")
    h = x
    for _ in range(4):
        h = pkg.layers.fc(h, size=32, act="tanh")
        ckpts.append(h)
    logits = pkg.layers.fc(h, size=4)
    return pkg.layers.mean(
        pkg.layers.softmax_with_cross_entropy(logits, lbl))


def _model(kind, pkg, ckpts, dropout=0.0):
    """-> loss; `ckpts` filled with the model's checkpoints."""
    if kind == "mlp":
        return _mlp(pkg, ckpts)
    if kind == "bert":
        mod = JB if pkg is fluid else PB
        cfg = mod.tiny()
        cfg.dropout = dropout
        return mod.build(cfg, checkpoints=ckpts)[0]
    mod = JT if pkg is fluid else PT
    cfg = mod.tiny(vocab=64, max_length=16)
    cfg.dropout = dropout
    return mod.build(cfg, checkpoints=ckpts)[0]


def _feed(kind):
    if kind == "mlp":
        rng = np.random.RandomState(0)
        return {"x": rng.randn(8, 16).astype("float32"),
                "y": rng.randint(0, 4, (8, 1)).astype("int64")}
    if kind == "bert":
        return JB.synthetic_batch(4, JB.tiny(), seed=3)
    return JT.synthetic_batch(4, JT.tiny(vocab=64, max_length=16), seed=3)


def _build(kind, pkg, remat, dropout=0.0):
    """-> (main, startup, loss, clone count or None)."""
    guard = jun.guard if pkg is fluid else pt.unique_name.guard
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    ckpts = []
    with pkg.program_guard(main, startup), guard():
        loss = _model(kind, pkg, ckpts, dropout)
        opt = (pkg.optimizer.SGD(0.5) if kind == "mlp"
               else pkg.optimizer.Adam(1e-3))
        opt.minimize(loss)
    n = None
    if remat:
        n = (jrecompute if pkg is fluid else recompute).apply_recompute(
            main, ckpts)
    return main, startup, loss, n


def _normalized(prog):
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


KINDS = ["transformer", "bert", "mlp"]


@pytest.mark.parametrize("kind,dropout", [
    ("transformer", 0.0), ("transformer", 0.1), ("bert", 0.0),
    ("bert", 0.1), ("mlp", 0.0)])
def test_rewrite_is_the_jax_packages(kind, dropout):
    jm, _, _, jn = _build(kind, fluid, True, dropout)
    pm, _, _, pn = _build(kind, pt, True, dropout)
    assert pn == jn > 0
    jops = _normalized(jm)["blocks"][0]["ops"]
    pops = _normalized(pm)["blocks"][0]["ops"]
    assert [o["type"] for o in pops] == [o["type"] for o in jops]
    for jo, po in zip(jops, pops):
        assert po == jo, jo["type"]
    assert _normalized(pm) == _normalized(jm)
    assert "rc_barrier" in [o["type"] for o in pops]
    # the dicts leave out "_" attrs (runtime scratch): compare the pins
    pins = [op.attrs.get("__rng_idx") for op in pm.global_block().ops]
    assert pins == [op.attrs.get("__rng_idx")
                    for op in jm.global_block().ops]
    cloned = [op for op in pm.global_block().ops
              if op.type == "dropout" and "__rng_idx" in op.attrs]
    assert bool(cloned) == bool(dropout)
    for op in cloned:
        orig = pm.global_block().ops[op.attrs["__rng_idx"]]
        assert orig.type == "dropout" and orig.input("X")[0] in \
            op.input("X")[0]


def test_recompute_optimizer_is_minimize_then_apply_recompute():
    """RecomputeOptimizer delegates to the inner optimizer and rewrites
    after its minimize: the same program as doing both by hand."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    ckpts = []
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = _model("transformer", pt, ckpts)
        opt = pt.optimizer.RecomputeOptimizer(pt.optimizer.Adam(1e-3),
                                              checkpoints=ckpts)
        assert opt.type == "adam"          # delegated
        opt.minimize(loss)
    want, _, _, _ = _build("transformer", pt, True)
    assert _normalized(main) == _normalized(want)


def _jax_losses(kind, remat):
    jm, js, jloss, _ = _build(kind, fluid, remat)
    scope, exe = JScope(), fluid.Executor(fluid.CPUPlace())
    exe.run(js, scope=scope)
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in jm.list_vars() if v.persistable}
    losses = [float(np.asarray(exe.run(jm, feed=_feed(kind),
                                       fetch_list=[jloss.name],
                                       scope=scope)[0]).ravel()[0])
              for _ in range(STEPS)]
    return params, losses


def _port_losses(kind, remat, params=None, dropout=0.0, mode="jit",
                 fetch=()):
    """STEPS steps of the port: losses, and the values of `fetch(main)`
    at every step."""
    main, startup, loss, _ = _build(kind, pt, remat, dropout)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), mode=mode)
    if params is None:
        exe.run(startup, scope=scope)
    else:
        convert.load_params(scope, params, pt.CPUPlace(), [main])
    names = list(fetch(main)) if fetch else []
    losses, fetched = [], []
    for _ in range(STEPS):
        outs = exe.run(main, feed=_feed(kind), fetch_list=[loss] + names,
                       scope=scope)
        losses.append(float(outs[0].ravel()[0]))
        fetched.append(outs[1:])
    return losses, fetched


@pytest.mark.parametrize("kind", KINDS)
def test_remat_trains_to_the_jax_losses(kind):
    params, want = _jax_losses(kind, True)
    got, _ = _port_losses(kind, True, params)
    plain, _ = _port_losses(kind, False, params)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    np.testing.assert_allclose(got, plain, rtol=1e-5)
    assert got[-1] < got[0]


def _mask_pairs(main):
    """[(a forward dropout's Mask, its clone's Mask)]."""
    ops = main.global_block().ops
    pairs = []
    for op in ops:
        if op.type == "dropout" and "__rng_idx" in op.attrs:
            orig = ops[op.attrs["__rng_idx"]]
            pairs.append((orig.output("Mask")[0], op.output("Mask")[0]))
    return pairs


@pytest.mark.parametrize("kind", ["transformer", "bert"])
def test_dropout_clones_replay_the_forward_masks(kind):
    """At dropout 0.1: every cloned dropout draws its original's mask in
    the same run; remat losses equal no-remat losses over 3 steps (rtol
    1e-5) on the jit path and the interpreter's, and the two paths agree
    (rtol 1e-5); the masks change from step to step."""
    def names(main):
        return [n for pair in _mask_pairs(main) for n in pair]

    runs = {}
    for mode in ("jit", "interpret"):
        plain, _ = _port_losses(kind, False, dropout=0.1, mode=mode)
        remat, masks = _port_losses(kind, True, dropout=0.1, mode=mode,
                                    fetch=names)
        np.testing.assert_allclose(remat, plain, rtol=1e-5)
        for step in masks:
            assert step
            for orig, clone in zip(step[::2], step[1::2]):
                np.testing.assert_array_equal(clone, orig)
                assert 0.0 < (orig == 0).mean() < 0.3
        assert not np.array_equal(masks[0][0], masks[1][0])
        runs[mode] = remat
    np.testing.assert_allclose(runs["jit"], runs["interpret"], rtol=1e-5)
