"""The optimizer tail (paddle_tpu_torch/ops/optimizer_ops.py,
paddle_tpu_torch/optimizer.py, paddle_tpu_torch/average.py) against the
JAX package's.

Each of the ten update ops takes one step from the same params, grads and
state in both registries (rtol 1e-6: the same float32 operations, with
the norms and powers reduced or rounded in another order).  Each
optimizer class appends the JAX package's ops (the program dicts after
`minimize` are equal) and, from the JAX startup's weights, runs
tests/test_optimizer.py's 60-step least-squares problem through both
packages: both losses fall below 0.7 of the first, and the two
trajectories agree at rtol 1e-3 (decayed_adagrad at lr 0.3 oscillates
with a growing amplitude after ~50 steps, which lifts the per-step 1e-7
differences to 6e-4).  ModelAverage's accumulators and
averaged parameters equal the JAX package's, and apply/restore gives the
live tensors back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.ops import registry as preg

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _f32(rng, *shape, positive=False):
    a = rng.standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.1 if positive else a


def _update_case(name):
    rng = np.random.RandomState(21)
    p, g = _f32(rng, 5, 3), _f32(rng, 5, 3)
    g[0, 0] = 0.0
    lr = {"LearningRate": [np.array([0.05], np.float32)]}
    base = dict({"Param": [p], "Grad": [g]}, **lr)
    pos = _f32(rng, 5, 3, positive=True)
    cases = {
        "lars_momentum": ("lars_momentum",
                          dict(base, Velocity=[_f32(rng, 5, 3)]),
                          {"mu": 0.9, "lars_coeff": 0.001,
                           "lars_weight_decay": 0.0005}),
        "adamax": ("adamax", dict(base, Moment=[_f32(rng, 5, 3)],
                                  InfNorm=[pos],
                                  Beta1Pow=[np.array([0.81], np.float32)]),
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ("adagrad", dict(base, Moment=[pos]), {"epsilon": 1e-6}),
        "decayed_adagrad": ("decayed_adagrad", dict(base, Moment=[pos]),
                            {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": ("adadelta", {"Param": [p], "Grad": [g],
                                  "AvgSquaredGrad": [pos],
                                  "AvgSquaredUpdate": [pos * 0.5]},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "rmsprop": ("rmsprop", dict(base, MeanSquare=[pos],
                                    Moment=[_f32(rng, 5, 3)],
                                    MeanGrad=[_f32(rng, 5, 3) * 0.1]),
                    {"decay": 0.9, "epsilon": 1e-10, "momentum": 0.5,
                     "centered": False}),
        "rmsprop_centered": ("rmsprop", dict(base, MeanSquare=[pos + 1],
                                             Moment=[_f32(rng, 5, 3)],
                                             MeanGrad=[_f32(rng, 5, 3)
                                                       * 0.1]),
                             {"decay": 0.9, "epsilon": 1e-10,
                              "momentum": 0.5, "centered": True}),
        "ftrl": ("ftrl", dict(base, SquaredAccumulator=[pos],
                              LinearAccumulator=[_f32(rng, 5, 3)]),
                 {"l1": 0.0, "l2": 0.0, "lr_power": -0.5}),
        "ftrl_l1_l2": ("ftrl", dict(base, SquaredAccumulator=[pos],
                                    LinearAccumulator=[_f32(rng, 5, 3)]),
                       {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
        "proximal_gd": ("proximal_gd", base, {"l1": 0.0, "l2": 0.1}),
        "proximal_gd_l1": ("proximal_gd", base, {"l1": 0.3, "l2": 0.1}),
        "proximal_adagrad": ("proximal_adagrad",
                             dict(base, Moment=[np.zeros((5, 3),
                                                         np.float32)]),
                             {"l1": 0.0, "l2": 0.0}),
        "proximal_adagrad_l1": ("proximal_adagrad",
                                dict(base, Moment=[pos]),
                                {"l1": 0.2, "l2": 0.1}),
    }
    for tag, (n_upd, n_acc, old) in {
            "average_accumulates": (5, 3, 1),
            "average_accumulates_shift": (9, 7, 2),
            "average_accumulates_roll": (16383, 4, 0)}.items():
        cases[tag] = ("average_accumulates", {
            "Param": [p], "InSum1": [pos], "InSum2": [pos * 2],
            "InSum3": [pos * 3],
            "InNumAccumulates": [np.array([n_acc], np.int64)],
            "InOldNumAccumulates": [np.array([old], np.int64)],
            "InNumUpdates": [np.array([n_upd], np.int64)]},
            {"average_window": 0.5, "min_average_window": 2,
             "max_average_window": 8 if tag != "average_accumulates_roll"
             else 100000})
    return cases[name]


@pytest.mark.parametrize("case", [
    "lars_momentum", "adamax", "adagrad", "decayed_adagrad", "adadelta",
    "rmsprop", "rmsprop_centered", "ftrl", "ftrl_l1_l2", "proximal_gd",
    "proximal_gd_l1", "proximal_adagrad", "proximal_adagrad_l1",
    "average_accumulates", "average_accumulates_shift",
    "average_accumulates_roll"])
def test_update_op_matches_jax(case):
    op_type, inputs, attrs = _update_case(case)
    j = jreg.run_forward(jreg.get_op_info(op_type),
                         {k: [jnp.asarray(a) for a in v]
                          for k, v in inputs.items()}, dict(attrs))
    p = preg.run_forward(preg.get_op_info(op_type),
                         {k: [torch.as_tensor(np.array(a)) for a in v]
                          for k, v in inputs.items()}, dict(attrs),
                         device=CPU)
    assert sorted(j) == sorted(p)
    for k in j:
        want = np.asarray(j[k][0])
        got = p[k][0].numpy()
        assert got.shape == want.shape, k
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want.astype(got.dtype), rtol=1e-6,
                                   atol=1e-7, err_msg=f"{case}.{k}")


# ---------------------------------------------------------------------------
# the optimizer classes: tests/test_optimizer.py's problem in both packages
# ---------------------------------------------------------------------------

# name -> (class name, kwargs): tests/test_optimizer.py's OPTIMIZERS, and
# the two proximal optimizers
OPTIMIZERS = {
    "sgd": ("SGD", {"learning_rate": 0.1}),
    "momentum": ("Momentum", {"learning_rate": 0.05, "momentum": 0.9}),
    "adagrad": ("Adagrad", {"learning_rate": 0.3}),
    "adam": ("Adam", {"learning_rate": 0.1}),
    "adamax": ("Adamax", {"learning_rate": 0.1}),
    "decayed_adagrad": ("DecayedAdagrad", {"learning_rate": 0.3}),
    "adadelta": ("Adadelta", {"learning_rate": 10.0, "rho": 0.9}),
    "rmsprop": ("RMSProp", {"learning_rate": 0.05}),
    "ftrl": ("Ftrl", {"learning_rate": 0.5}),
    "lars": ("LarsMomentum", {"learning_rate": 0.05, "momentum": 0.9}),
    "proximal_gd": ("ProximalGD", {"learning_rate": 0.1, "l2": 0.01}),
    "proximal_adagrad": ("ProximalAdagrad",
                         {"learning_rate": 0.3, "l1": 0.001}),
}


def _problem(pkg, opt_name, seed=1):
    cls, kw = OPTIMIZERS[opt_name]
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    guard = jun.guard() if pkg is fluid else pt.unique_name.guard()
    with pkg.program_guard(main, startup), guard:
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        ops, _ = getattr(pkg.optimizer, cls)(**kw).minimize(loss)
    return main, startup, loss, ops


def _carried(jmain, jstart, pmain):
    """(JAX scope after its startup, port scope with the same values)."""
    jscope = JScope()
    with jscope_guard(jscope):
        fluid.Executor(fluid.CPUPlace()).run(jstart)
    pscope = pt.Scope()
    convert.load_params(pscope, {
        v.name: np.asarray(jscope.find_var(v.name))
        for v in jmain.list_vars()
        if v.persistable and jscope.find_var(v.name) is not None},
        pt.CPUPlace(), [pmain])
    return jscope, pscope


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_reduces_loss_like_jax(name):
    jmain, jstart, jloss, jops = _problem(fluid, name)
    pmain, pstart, ploss, pops = _problem(pt, name)
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    assert [op.type for op in pops] == [op.type for op in jops]
    rng = np.random.RandomState(0)
    true_w = rng.rand(4, 1).astype("float32")
    xs = rng.rand(64, 4).astype("float32")
    feed = {"x": xs, "y": xs @ true_w + 1.0}
    jscope, pscope = _carried(jmain, jstart, pmain)
    jexe = fluid.Executor(fluid.CPUPlace())
    pexe = pt.Executor(pt.CPUPlace())
    jl, pl = [], []
    for _ in range(60):
        with jscope_guard(jscope):
            (a,) = jexe.run(jmain, feed=feed, fetch_list=[jloss.name])
        (b,) = pexe.run(pmain, feed=feed, fetch_list=[ploss.name],
                        scope=pscope)
        jl.append(float(np.asarray(a).reshape(-1)[0]))
        pl.append(float(b.reshape(-1)[0]))
    for losses in (jl, pl):
        assert losses[-1] < losses[0] * 0.7, (name, losses[0], losses[-1])
    np.testing.assert_allclose(pl, jl, rtol=1e-3)


def test_model_average_matches_jax_and_restores(tmp_path):
    """ModelAverage(0.5, 2, 4) after SGD in both packages (the JAX
    test's problem): after 6 steps its sums and counters equal the JAX
    package's (sums rtol 1e-6), apply() binds the JAX averages (rtol
    1e-6) and exit binds the live tensors back (the same objects);
    apply(need_restore=False) then restore() does too."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 4).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}
    built = {}
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        guard = jun.guard() if pkg is fluid else pt.unique_name.guard()
        with pkg.program_guard(main, startup), guard:
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            y = pkg.layers.data("y", shape=[1], dtype="float32")
            pred = pkg.layers.fc(x, size=1, param_attr="w", bias_attr="b")
            loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            ma = pkg.optimizer.ModelAverage(
                0.5, min_average_window=2, max_average_window=4,
                program=main)
        built[pkg] = (main, startup, loss, ma)
    jmain, jstart, jloss, jma = built[fluid]
    pmain, pstart, ploss, pma = built[pt]
    assert pmain.to_dict() == jmain.to_dict()
    jscope, pscope = _carried(jmain, jstart, pmain)
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for _ in range(6):
        with jscope_guard(jscope):
            jexe.run(jmain, feed=feed, fetch_list=[jloss.name])
        pexe.run(pmain, feed=feed, fetch_list=[ploss.name], scope=pscope)
    for v in pmain.list_vars():
        if "ma_" in v.name:
            np.testing.assert_allclose(
                pscope.find_var(v.name).numpy(),
                np.asarray(jscope.find_var(v.name)).astype(
                    pscope.find_var(v.name).numpy().dtype),
                rtol=1e-6, err_msg=v.name)
    live = {n: pscope.find_var(n) for n in ("w", "b")}
    with jscope_guard(jscope), jma.apply(jexe, scope=jscope):
        javg = {n: np.asarray(jscope.find_var(n)).copy() for n in live}
    with pma.apply(pexe, scope=pscope):
        for n in live:
            assert not torch.equal(pscope.find_var(n), live[n])
            np.testing.assert_allclose(pscope.find_var(n).numpy(), javg[n],
                                       rtol=1e-6)
    assert all(pscope.find_var(n) is live[n] for n in live)
    with pma.apply(pexe, need_restore=False, scope=pscope):
        pass
    assert not torch.equal(pscope.find_var("w"), live["w"])
    pma.restore(pexe)
    assert all(pscope.find_var(n) is live[n] for n in live)


def test_weighted_average_matches_jax():
    pairs = [(0.5, 2), (np.array([1.5]), 1), (np.float32(3.0), 4)]
    got, want = pt.average.WeightedAverage(), fluid.average.WeightedAverage()
    for v, w in pairs:
        got.add(v, w)
        want.add(v, w)
    assert got.eval() == want.eval()
    got.reset()
    with pytest.raises(ValueError, match="no data"):
        got.eval()
    with pytest.raises(ValueError, match="scalar"):
        got.add(np.ones(2), 1)
