"""The image tail (ops/nn_ops.py depthwise_conv2d, ops/sequence_ops.py
sequence_pool, models/mnist.py, models/se_resnext.py) against the JAX
package.

- `layers.conv2d(groups=C)` emits `depthwise_conv2d` in both packages
  (grouped convs with other groups stay `conv2d`); output, Input and
  Filter grads through each package's Executor after `append_backward`
  within rtol 1e-5 of their largest magnitude.
- `layers.sequence_pool`, every pool type (the default AVERAGE
  included), with and without SeqLen and with an empty row: Out, MaxIndex
  and X's grad through both Executors (rtol 1e-5).
- SE's gate, `elementwise_mul(x=[N, C, H, W], y=[N, C], axis=0)`: Y's
  grad sums over H and W back to [N, C], as the JAX package's.
- MNIST's `build_mlp` and `build_conv` + Momentum: identical programs,
  and 3 Momentum losses from the JAX startup's weights within rtol 2e-4.
- SE-ResNeXt from the module's own blocks at reduced cardinality and
  depth (a stem, an identity-shortcut and a strided bottleneck, 3x16x16,
  batch 4): identical programs, every param grad of the first step within
  rtol 1e-4 of its largest magnitude and 3 Momentum losses within 2e-4,
  both packages' dropout drawing the same masks
  (`testing.seeded_dropout`).  `se_resnext50` itself: identical programs
  and the `clone(for_test=True)` forward at batch 2, 3x32x32, within rtol
  1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import mnist as JM
from paddle_tpu.models import se_resnext as JS
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.models import mnist as PM
from paddle_tpu_torch.models import se_resnext as PS
from paddle_tpu_torch.ops import registry as preg

CLASSES, LR, STEPS = 10, 1e-3, 3
BOTH = ((fluid, jun.guard), (pt, pt.unique_name.guard))


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _normalized(prog):
    """The program dict with integer var dtypes read as one kind (the JAX
    package narrows int64 to int32 with x64 off)."""
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _assert_same_program(jprog, pprog):
    jd, pd = _normalized(jprog), _normalized(pprog)
    jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in pops] == [o["type"] for o in jops]
    for jo, po in zip(jops, pops):
        assert po == jo, jo["type"]
    assert pd == jd


def _run_both(j, p, feed, fetch):
    """j and p: (main, startup) of each package.  The JAX startup's
    persistables seed both scopes; -> (jax outs, port outs) as numpy."""
    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(j[1], scope=jscope)
    want = [np.asarray(a) for a in jexe.run(j[0], feed=feed,
                                            fetch_list=fetch, scope=jscope)]
    pscope = pt.Scope()
    for v in p[0].list_vars():
        if v.persistable:
            pscope.set_var(v.name, torch.as_tensor(
                np.asarray(jscope.find_var(v.name))))
    got = pt.Executor(pt.CPUPlace()).run(p[0], feed=feed, fetch_list=fetch,
                                         scope=pscope)
    return want, got


def _assert_close(got, want, names, rtol):
    for name, g, w in zip(names, got, want, strict=True):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=name)


def _seeded_dropout(monkeypatch):
    for reg, as_array in (
            (jreg, lambda k, x: jnp.asarray(k, dtype=x.dtype)),
            (preg, lambda k, x: torch.as_tensor(k).to(x.device, x.dtype))):
        info = reg.OPS["dropout"]
        monkeypatch.setattr(info, "forward",
                            testing.seeded_dropout(info.forward, as_array))


# ------------------------------------------------- depthwise_conv2d (C13)


@pytest.mark.parametrize("groups,filters,size,stride,pad", [
    (6, 6, 3, 1, 1), (6, 12, 3, 2, 1), (6, 6, 1, 1, 0), (6, 6, 5, 1, 2),
    (3, 6, 3, 1, 1)],
    ids=["depthwise", "depthwise_x2_strided", "depthwise_1x1",
         "depthwise_5x5", "grouped"])
def test_grouped_conv_output_and_grads_match_jax(groups, filters, size,
                                                 stride, pad):
    built = []
    for pkg, guard in BOTH:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            img = pkg.layers.data(name="img", shape=[6, 9, 9],
                                  dtype="float32")
            img.stop_gradient = False
            out = pkg.layers.conv2d(img, num_filters=filters,
                                    filter_size=size, stride=stride,
                                    padding=pad, groups=groups, act="relu")
            cot = pkg.layers.data(name="cot", shape=list(out.shape[1:]),
                                  dtype="float32")
            pkg.append_backward(pkg.layers.reduce_sum(
                pkg.layers.elementwise_mul(out, cot)))
        built.append((main, startup, out))
    (jm, js, jout), (pm, ps, _) = built
    _assert_same_program(jm, pm)
    conv = pm.global_block().ops[0]
    assert conv.type == ("depthwise_conv2d" if groups == 6 else "conv2d")
    rng = np.random.RandomState(groups + size)
    feed = {"img": rng.standard_normal((2, 6, 9, 9)).astype(np.float32),
            "cot": rng.standard_normal((2,) + tuple(jout.shape[1:])).astype(
                np.float32)}
    fetch = [jout.name, "img@GRAD", conv.input("Filter")[0] + "@GRAD"]
    want, got = _run_both((jm, js), (pm, ps), feed, fetch)
    _assert_close(got, want, fetch, 1e-5)


# --------------------------------------------------- sequence_pool (C14)


@pytest.mark.parametrize("with_len", [True, False], ids=["seq_len", "full"])
@pytest.mark.parametrize("pool_type", [None, "sum", "sqrt", "last", "first",
                                       "max"])
def test_sequence_pool_matches_jax(pool_type, with_len):
    """pool_type None is the layer's default ("average").  Rows of 5, 0
    (empty: pools to 0), 2 and 1 steps."""
    built = []
    for pkg, guard in BOTH:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            x = pkg.layers.data(name="x", shape=[5, 3], dtype="float32")
            x.stop_gradient = False
            lens = (pkg.layers.data(name="lens", shape=[], dtype="int64")
                    if with_len else None)
            kw = {} if pool_type is None else {"pool_type": pool_type}
            out = pkg.layers.sequence_pool(x, seq_len=lens, **kw)
            cot = pkg.layers.data(name="cot", shape=[3], dtype="float32")
            pkg.append_backward(pkg.layers.reduce_sum(
                pkg.layers.elementwise_mul(out, cot)))
        built.append((main, startup, out))
    (jm, js, jout), (pm, ps, _) = built
    _assert_same_program(jm, pm)
    op = pm.global_block().ops[0]
    assert op.type == "sequence_pool"
    assert op.attrs["pooltype"] == (pool_type or "average").upper()
    rng = np.random.RandomState(7)
    feed = {"x": rng.standard_normal((4, 5, 3)).astype(np.float32),
            "cot": rng.standard_normal((4, 3)).astype(np.float32)}
    if with_len:
        feed["lens"] = np.array([5, 0, 2, 1], np.int64)
    fetch = [jout.name, "x@GRAD"]
    if pool_type == "max":
        fetch.append(op.output("MaxIndex")[0])
    want, got = _run_both((jm, js), (pm, ps), feed, fetch)
    _assert_close(got, want, fetch, 1e-5)
    if with_len:
        assert not got[0][1].any() and not got[1][1].any()
    if pool_type == "max":
        assert got[2].dtype == np.int32
        np.testing.assert_array_equal(got[2], want[2])


# ------------------------------------------------------------ SE's gate


def test_se_gate_y_grad_sums_over_h_and_w():
    rng = np.random.RandomState(8)
    x = rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
    y = rng.standard_normal((2, 6)).astype(np.float32)
    gy = rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
    res = []
    for reg, as_arr, back in (
            (jreg, jnp.asarray, np.asarray),
            (preg, lambda a: torch.as_tensor(a), lambda t: t.numpy())):
        kw = {} if reg is jreg else {"device": torch.device("cpu")}
        fwd = reg.run_forward(reg.get_runtime_info("elementwise_mul"),
                              {"X": [as_arr(x)], "Y": [as_arr(y)]},
                              {"axis": 0}, out_names={"Out": ["o"]}, **kw)
        grads = reg.run_forward(
            reg.get_runtime_info("elementwise_mul_grad"),
            {"X": [as_arr(x)], "Y": [as_arr(y)], "Out": fwd["Out"],
             "Out@GRAD": [as_arr(gy)]}, {"axis": 0},
            out_names={"X@GRAD": ["gx"], "Y@GRAD": ["gy"]}, **kw)
        res.append([back(fwd["Out"][0]), back(grads["X@GRAD"][0]),
                    back(grads["Y@GRAD"][0])])
    (jo, jgx, jgy), (po, pgx, pgy) = res
    assert pgy.shape == (2, 6)
    np.testing.assert_allclose(pgy, (gy * x).sum(axis=(2, 3)), rtol=1e-5,
                               atol=1e-5)
    _assert_close([po, pgx, pgy], [jo, jgx, jgy], ["Out", "X@GRAD",
                                                    "Y@GRAD"], 1e-5)


# ---------------------------------------------------------------- MNIST


def _train_build(pkg, guard, model):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.program_guard(main, startup), guard():
        loss, prob, _ = model()
        _, pg = pkg.optimizer.Momentum(learning_rate=LR,
                                       momentum=0.9).minimize(loss)
    return main, startup, loss, prob, pg


def _image_feed(shape, batch, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.standard_normal((batch,) + tuple(shape)).astype(
                np.float32),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}


def _losses(j, p, feed, fetch_grads=()):
    """STEPS training steps in both packages from the JAX startup's
    weights -> (jax losses, port losses, jax first grads, port first
    grads)."""
    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(j[1], scope=jscope)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    pscope = pt.Scope()
    convert.load_params(pscope, params, pt.CPUPlace(), [p[0]])
    pexe = pt.Executor(pt.CPUPlace())
    jl, pl, jg, pg = [], [], None, None
    for i in range(STEPS):
        extra = list(fetch_grads) if i == 0 else []
        jo = jexe.run(j[0], feed=feed, fetch_list=[j[2].name] + extra,
                      scope=jscope)
        po = pexe.run(p[0], feed=feed, fetch_list=[p[2]] + extra,
                      scope=pscope)
        jl.append(float(np.asarray(jo[0]).ravel()[0]))
        pl.append(float(po[0].ravel()[0]))
        if i == 0:
            jg, pg = [np.asarray(a) for a in jo[1:]], po[1:]
    return jl, pl, jg, pg


@pytest.mark.parametrize("name", ["build_mlp", "build_conv"])
def test_mnist_programs_and_momentum_losses_match_jax(name):
    j = _train_build(fluid, jun.guard, getattr(JM, name))
    p = _train_build(pt, pt.unique_name.guard, getattr(PM, name))
    _assert_same_program(j[0], p[0])
    _assert_same_program(j[1], p[1])
    assert PM.feed_shapes(8) == JM.feed_shapes(8)
    jl, pl, _, _ = _losses(j, p, _image_feed((1, 28, 28), 8))
    assert np.all(np.isfinite(pl)) and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=2e-4)


# ---------------------------------------------------------- SE-ResNeXt


def _small_se(mod):
    """The module's own blocks at cardinality 4 and reduction 4: a 3x3
    stem of 16, an identity-shortcut bottleneck of 8 (16 out) and a
    strided one of 16 (a conv shortcut), then se_resnext50's head."""
    def model():
        layers = pt.layers if mod is PS else fluid.layers
        img = layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        x = mod.conv_bn_layer(img, 16, 3, act="relu")
        x = mod.bottleneck_block(x, 8, stride=1, cardinality=4,
                                 reduction_ratio=4)
        x = mod.bottleneck_block(x, 16, stride=2, cardinality=4,
                                 reduction_ratio=4)
        x = layers.pool2d(input=x, pool_type="avg", global_pooling=True)
        x = layers.dropout(x=x, dropout_prob=0.5)
        prediction = layers.fc(input=x, size=CLASSES, act="softmax")
        loss = layers.mean(layers.cross_entropy(input=prediction,
                                                label=label))
        return loss, prediction, None
    return model


def test_small_se_resnext_grads_and_losses_match_jax(monkeypatch):
    j = _train_build(fluid, jun.guard, _small_se(JS))
    p = _train_build(pt, pt.unique_name.guard, _small_se(PS))
    _assert_same_program(j[0], p[0])
    ops = [op.type for op in p[0].global_block().ops]
    assert ops.count("sigmoid") == 2 and ops.count("sigmoid_grad") == 2
    groups = sorted(op.attrs["groups"] for op in p[0].global_block().ops
                    if op.type == "conv2d")
    assert groups == [1] * 6 + [4, 4]
    _seeded_dropout(monkeypatch)
    grads = [g.name for _, g in p[4]]
    jl, pl, jg, pg = _losses(j, p, _image_feed((3, 16, 16), 4, seed=1),
                             grads)
    _assert_close(pg, jg, grads, 1e-4)
    assert np.all(np.isfinite(pl)) and pl[-1] != pl[0]
    np.testing.assert_allclose(pl, jl, rtol=2e-4)


def test_se_resnext50_program_and_test_forward_match_jax():
    j = _train_build(fluid, jun.guard,
                     lambda: JS.build(image_shape=(3, 32, 32),
                                      class_dim=CLASSES))
    p = _train_build(pt, pt.unique_name.guard,
                     lambda: PS.build(image_shape=(3, 32, 32),
                                      class_dim=CLASSES))
    _assert_same_program(j[0], p[0])
    _assert_same_program(j[1], p[1])
    ops = [op.type for op in p[0].global_block().ops]
    assert ops.count("sigmoid") == 16 and ops.count("dropout") == 1
    jt, ptest = j[0].clone(for_test=True), p[0].clone(for_test=True)
    fetch = [j[2].name, j[3].name]
    want, got = _run_both((jt, j[1]), (ptest, p[1]),
                          _image_feed((3, 32, 32), 2), fetch)
    _assert_close(got, want, ["loss", "prob"], 1e-4)
