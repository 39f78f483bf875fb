"""GoogLeNet (models/googlenet.py) against the JAX package's
(paddle_tpu/models/googlenet.py).

At batch 2, 3x224x224 (the topology fixes the size: the last average
pool is 7x7) and class_dim 10, `build()` + Momentum(0.01, 0.9) gives the
same Program in both packages, op for op and var for var.  From the JAX
startup's weights (carried with `convert.load_params`), the
`clone(for_test=True)` forward (dropout scaling by 1 - p) agrees with the
JAX package's: every max pool with ceil_mode and every inception concat
has the JAX shape and values, the probabilities and the loss within rtol
1e-4.  One Momentum step with both packages' dropout drawing the same
masks (`testing.seeded_dropout`) gives the loss within rtol 1e-4 and
every param grad as close to the JAX package's as the problem allows: in
float32 at random init the grads are ill conditioned (a 1e-7 relative
change of the image moves the first conv's grad by 1.2e-3 of its largest
magnitude on the port's own path, the ResNet-50 finding of
tests/test_torch_resnet.py), so each grad is held to 2x the larger move
of the port's own grad under a +-1e-7 relative change of the image, plus
1e-4 of its largest magnitude (elementwise and in L2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import googlenet as JG
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.models import googlenet as PG
from paddle_tpu_torch.ops import registry as preg

BATCH, CLASSES, LR = 2, 10, 0.01


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _build(pkg, model, guard):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        loss, prob, _ = model.build(class_dim=CLASSES)
        _, pg = pkg.optimizer.Momentum(learning_rate=LR,
                                       momentum=0.9).minimize(loss)
    return main, startup, loss, prob, pg


def _normalized(prog):
    """The program dict with integer var dtypes read as one kind (the JAX
    package narrows int64 to int32 with x64 off)."""
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _feed():
    rng = np.random.RandomState(0)
    return {"img": rng.standard_normal((BATCH, 3, 224, 224)).astype(
                np.float32),
            "label": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def both():
    """Both builds, the JAX startup's persistables and a JAX scope."""
    with testing.fresh_programs():
        j = _build(fluid, JG, jun.guard)
        p = _build(pt, PG, pt.unique_name.guard)
    jscope = JScope()
    fluid.Executor(fluid.CPUPlace()).run(j[1], scope=jscope)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    return j, p, params


def _port_scope(p, params):
    scope = pt.Scope()
    convert.load_params(scope, params, pt.CPUPlace(), [p[0]])
    return scope


def test_programs_are_identical(both):
    """build + Momentum.minimize: the same main and startup programs in
    both packages, with the two aux heads' dropout 0.7, the final dropout
    0.4 and their grads."""
    (jm, js, *_, jpg), (pm, ps, *_, ppg), _ = both
    for j, p in ((jm, pm), (js, ps)):
        jd, pd = _normalized(j), _normalized(p)
        jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
        assert [o["type"] for o in pops] == [o["type"] for o in jops]
        for jo, po in zip(jops, pops):
            assert po == jo, jo["type"]
        assert pd == jd
    assert [(a.name, b.name) for a, b in ppg] == \
        [(a.name, b.name) for a, b in jpg]
    probs = sorted(op.attrs["dropout_prob"] for op in pm.global_block().ops
                   if op.type == "dropout")
    assert probs == [0.4, 0.7, 0.7]


def test_for_test_forward_matches_jax_layer_by_layer(both):
    """clone(for_test=True): each pool2d (ceil_mode max pools included) and
    each concat has the JAX shape and agrees within rtol 1e-4 of the
    output's largest magnitude; the probabilities and the loss within
    rtol 1e-4."""
    (jm, _, jloss, jprob, _), p, params = both
    pm, _, ploss, pprob, _ = p
    jt, ptest = jm.clone(for_test=True), pm.clone(for_test=True)
    ops = ptest.global_block().ops
    layers = [op.output("Out")[0] for op in ops
              if op.type in ("pool2d", "concat")]
    ceil = [op for op in ops if op.type == "pool2d" and op.attrs["ceil_mode"]]
    assert len(ceil) == 4 and len(layers) == 9 + 4 + 9 + 2 + 1
    feed = _feed()
    jscope = JScope()
    for n, v in params.items():
        jscope.set_var(n, jnp.asarray(v))
    jouts = fluid.Executor(fluid.CPUPlace()).run(
        jt, feed=feed, fetch_list=[jloss.name, jprob.name] + layers,
        scope=jscope)
    pouts = pt.Executor(pt.CPUPlace()).run(
        ptest, feed=feed, fetch_list=[ploss, pprob] + layers,
        scope=_port_scope(p, params))
    for name, a, b in zip(["loss", "prob"] + layers, jouts, pouts):
        a = np.asarray(a)
        assert b.shape == a.shape, (name, b.shape, a.shape)
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)
    shapes = {n: o.shape for n, o in zip(layers, pouts[2:])}
    assert [shapes[op.output("Out")[0]][2:] for op in ceil] == \
        [(56, 56), (28, 28), (14, 14), (7, 7)]


def test_momentum_step_grads_match_jax_with_carried_masks(both,
                                                          monkeypatch):
    """One Momentum step of the training program with both packages'
    dropout drawing the same masks: the loss within rtol 1e-4; every
    param@GRAD within 2x the port's own move under a +-1e-7 relative
    change of the image, plus 1e-4 of the grad's largest magnitude, both
    elementwise and in L2 (see the module docstring)."""
    (jm, _, jloss, _, jpg), p, params = both
    pm, _, ploss, _, ppg = p
    for reg, as_array in (
            (jreg, lambda k, x: jnp.asarray(k, dtype=x.dtype)),
            (preg, lambda k, x: torch.as_tensor(k).to(x.device, x.dtype))):
        info = reg.OPS["dropout"]
        monkeypatch.setattr(info, "forward",
                            testing.seeded_dropout(info.forward, as_array))
    grads = [g.name for _, g in jpg]
    feed = _feed()
    jscope = JScope()
    for n, v in params.items():
        jscope.set_var(n, jnp.asarray(v))
    jouts = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=[jloss.name] + grads, scope=jscope)
    runs = [pt.Executor(pt.CPUPlace()).run(
        pm, feed=dict(feed, img=feed["img"] * scale),
        fetch_list=[ploss] + grads, scope=_port_scope(p, params))
        for scale in (1.0, 1 + 1e-7, 1 - 1e-7)]
    pouts = runs[0]
    np.testing.assert_allclose(pouts[0], np.asarray(jouts[0]), rtol=1e-4)
    for i, name in enumerate(grads, 1):
        a = np.asarray(jouts[i], np.float64)
        b = pouts[i]
        moved = [r[i] - b for r in runs[1:]]
        for norm in (lambda d: np.abs(d).max(), np.linalg.norm):
            bar = 2 * max(norm(d) for d in moved) + 1e-4 * norm(a)
            assert norm(b - a) <= bar, (name, norm(b - a), bar)
