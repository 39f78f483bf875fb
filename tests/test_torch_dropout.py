"""dropout (paddle_tpu/ops/random_ops.py:77-117) and
`Program.clone(for_test=True)` (paddle_tpu/framework/framework.py:442-477)
against the JAX package, and the port's draws on its two Executor paths.

The op's test-mode outputs and its grad are deterministic, so they are
compared with the JAX package's on the same numpy inputs (atol 1e-6, in
float32 and bfloat16, both implementations).  The training draws cannot
match value for value (threefry vs torch's generator): they are held to
Out == X * Mask exactly, a kept share within 5 binomial sigmas of 1 - p,
a new mask on the next run and the same one in a fresh scope, and the
same masks on the jit path as on the interpreter's for the same seed and
run counter.  The grad is held to central differences (the method of
tests/op_test.py::check_grad) with the masks carried by
`testing.seeded_dropout`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.ops import registry as preg

IMPLS = ("downgrade_in_infer", "upscale_in_train")
ATOL = 1e-6
OUT_NAMES = {"Out": ["out"], "Mask": ["mask"]}


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _both(op_type, inputs, attrs, out_names, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = jreg.run_forward(
        jreg.get_op_info(op_type),
        {k: [jnp.asarray(a, dtype=jdt) for a in v] for k, v in inputs.items()},
        dict(attrs), out_names=out_names)
    p = preg.run_forward(
        preg.get_op_info(op_type),
        {k: [torch.as_tensor(a).to(getattr(torch, dtype)) for a in v]
         for k, v in inputs.items()},
        dict(attrs), out_names=out_names, device=torch.device("cpu"))
    assert sorted(p) == sorted(j)
    for param in j:
        (a,), (b,) = j[param], p[param]
        assert b.dtype == getattr(torch, dtype), param
        assert tuple(b.shape) == tuple(a.shape), param
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=0, atol=ATOL, err_msg=param)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_is_test_outputs_match_jax(impl, dtype):
    """x * (1 - p) under downgrade_in_infer, x under upscale_in_train, and a
    mask of ones, in X's dtype."""
    x = np.random.RandomState(0).standard_normal((4, 3, 33))
    _both("dropout", {"X": [x]},
          {"dropout_prob": 0.3, "is_test": True, "seed": 0,
           "dropout_implementation": impl}, OUT_NAMES, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_grad_matches_jax(impl, dtype):
    """dOut * Mask, whatever the mask holds (here keep / (1 - p) for
    upscale_in_train)."""
    rng = np.random.RandomState(1)
    p = 0.3
    mask = (rng.random_sample((5, 17)) < 1 - p).astype(np.float32)
    if impl == "upscale_in_train":
        mask /= 1 - p
    _both("dropout_grad",
          {"Mask": [mask], "Out@GRAD": [rng.standard_normal((5, 17))]},
          {"dropout_prob": p, "is_test": False, "seed": 0,
           "dropout_implementation": impl},
          {"X@GRAD": ["x@GRAD"]}, dtype)


def _dropout_program(p, impl, width=256, n_drop=1):
    """x [B, width] through `n_drop` dropouts in a row; -> (program, the
    Out names, the Mask names)."""
    main = pt.Program()
    main.random_seed = 7
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard():
        h = pt.layers.data("x", shape=[width], dtype="float32")
        for _ in range(n_drop):
            h = pt.layers.dropout(h, p, dropout_implementation=impl)
    drops = [op for op in main.global_block().ops if op.type == "dropout"]
    return (main, [op.output("Out")[0] for op in drops],
            [op.output("Mask")[0] for op in drops])


def _x(b=64, width=256):
    return np.random.RandomState(2).standard_normal((b, width)).astype(
        np.float32)


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("impl", IMPLS)
def test_training_draws(impl, p):
    """Out == X * Mask exactly; the mask is keep (or keep / (1 - p)); the
    kept share is within 5 binomial sigmas of 1 - p; the next run in the
    same scope draws a new mask, a fresh scope the first one again."""
    main, (out,), (mask,) = _dropout_program(p, impl)
    x = _x()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    o1, m1 = exe.run(main, feed={"x": x}, fetch_list=[out, mask], scope=scope)
    o2, m2 = exe.run(main, feed={"x": x}, fetch_list=[out, mask], scope=scope)
    assert m1.dtype == np.float32 and m1.shape == x.shape
    np.testing.assert_array_equal(o1, x * m1)
    scale = 1.0 / (1 - p) if impl == "upscale_in_train" else 1.0
    assert set(np.unique(m1)) <= {0.0, np.float32(scale)}
    kept = (m1 != 0).mean()
    sigma = np.sqrt(p * (1 - p) / m1.size)
    assert abs(kept - (1 - p)) <= 5 * sigma, kept
    assert not np.array_equal(m1, m2)
    (m3,) = exe.run(main, feed={"x": x}, fetch_list=[mask], scope=pt.Scope())
    np.testing.assert_array_equal(m3, m1)


@pytest.mark.parametrize("p,want", [(1.0, 0.0), (0.0, 1.0)])
def test_upscale_edges(p, want):
    """upscale_in_train at p == 1 gives a zero mask (no 1 / 0), at p == 0
    a mask of ones."""
    main, (out,), (mask,) = _dropout_program(p, "upscale_in_train")
    o, m = pt.Executor(pt.CPUPlace()).run(main, feed={"x": _x()},
                                          fetch_list=[out, mask])
    assert np.all(m == want)
    np.testing.assert_array_equal(o, _x() * want)


def test_jit_path_draws_what_the_interpreter_draws():
    """Three dropouts in one segment, three runs in one scope: the jit
    path's masks equal the interpreter's run for run (a generator a
    dropout, seeded from the program's seed, the run counter and the
    op's rng index), and differ from run to run and from op to op."""
    main, _, masks = _dropout_program(0.3, "upscale_in_train", n_drop=3)
    x = _x(16)
    runs = {}
    for mode in ("jit", "interpret"):
        exe, scope = pt.Executor(pt.CPUPlace(), mode=mode), pt.Scope()
        runs[mode] = [exe.run(main, feed={"x": x}, fetch_list=masks,
                              scope=scope) for _ in range(3)]
    for jit_run, eager_run in zip(runs["jit"], runs["interpret"]):
        for a, b in zip(jit_run, eager_run):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs["jit"][0][0], runs["jit"][1][0])
    assert not np.array_equal(runs["jit"][0][0], runs["jit"][0][1])


def test_program_as_function_reseeds_per_call():
    """program_as_function's own generators: each call draws anew, and a
    new function over the same program draws the same sequence."""
    from paddle_tpu_torch.framework.executor import program_as_function

    main, _, (mask,) = _dropout_program(0.5, "downgrade_in_infer")
    x = _x(8)
    draws = []
    for _ in range(2):
        fn = program_as_function(main, pt.Scope(), [mask],
                                 place=pt.CPUPlace())
        draws.append([fn({"x": x})[0].numpy() for _ in range(2)])
    assert not np.array_equal(draws[0][0], draws[0][1])
    for a, b in zip(draws[0], draws[1]):
        np.testing.assert_array_equal(a, b)


def _torch_array(keep, x):
    return torch.as_tensor(keep).to(device=x.device, dtype=x.dtype)


@pytest.mark.parametrize("impl", IMPLS)
def test_grad_through_carried_mask_matches_central_differences(
        monkeypatch, impl):
    """x -> fc -> dropout -> loss = sum(out * W): x@GRAD from the grad ops
    against central differences of the loss (delta 5e-3, max relative
    error 5e-3), the mask held fixed by testing.seeded_dropout."""
    info = preg.OPS["dropout"]
    monkeypatch.setattr(info, "forward",
                        testing.seeded_dropout(info.forward, _torch_array))
    rng = np.random.RandomState(3)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", shape=[4, 8], dtype="float32",
                           append_batch_size=False, stop_gradient=False)
        h = pt.layers.fc(x, size=12, name="h")
        d = pt.layers.dropout(h, 0.4, dropout_implementation=impl)
        w = pt.layers.assign(rng.uniform(0.5, 1.5, (4, 12)).astype(
            np.float32))
        loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(d, w))
        (dx,) = pt.backward.gradients(loss, [x])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    xv = rng.standard_normal((4, 8)).astype(np.float32)
    (got,) = exe.run(main, feed={"x": xv}, fetch_list=[dx], scope=scope)
    delta = 5e-3
    num = np.zeros_like(xv, dtype=np.float64)
    for i in np.ndindex(xv.shape):
        lo, hi = xv.copy(), xv.copy()
        lo[i] -= delta
        hi[i] += delta
        (l_hi,) = exe.run(main, feed={"x": hi}, fetch_list=[loss],
                          scope=scope)
        (l_lo,) = exe.run(main, feed={"x": lo}, fetch_list=[loss],
                          scope=scope)
        num[i] = (float(l_hi[0]) - float(l_lo[0])) / (2 * delta)
    rel = np.abs(got - num).max() / max(np.abs(num).max(), 1e-3)
    assert rel <= 5e-3, rel


def _eval_net(pkg, guard):
    """x -> fc -> batch_norm -> dropout 0.5 -> fc softmax -> cross entropy
    + Momentum; -> (main, startup, loss, probabilities)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        h = pkg.layers.fc(input=x, size=32, act="relu", name="h")
        h = pkg.layers.batch_norm(input=h)
        h = pkg.layers.dropout(x=h, dropout_prob=0.5)
        prob = pkg.layers.fc(input=h, size=4, act="softmax", name="o")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(input=prob,
                                                        label=label))
        pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
            loss)
    return main, startup, loss, prob


def test_clone_for_test_matches_jax():
    """clone(for_test=True) in both packages: the same op types, the same
    is_test attrs, no Backward or Optimize op, no `_` scratch attr; the
    source keeps its training ops; clone() with no argument is a plain
    deep copy.  Run from the same weights, both test programs give the
    same probabilities (1e-5): dropout scales by 1 - p, batch_norm reads
    its running statistics."""
    jm, js, jloss, jprob = _eval_net(fluid, jun.guard)
    pm, ps, ploss, pprob = _eval_net(pt, pt.unique_name.guard)
    jt, ptest = jm.clone(for_test=True), pm.clone(for_test=True)
    jops, pops = jt.global_block().ops, ptest.global_block().ops
    assert [o.type for o in pops] == [o.type for o in jops]
    assert [o.attrs.get("is_test") for o in pops] == \
        [o.attrs.get("is_test") for o in jops]
    assert {o.type for o in pops} == {"mul", "elementwise_add", "relu",
                                      "batch_norm", "dropout", "softmax",
                                      "cross_entropy", "mean"}
    roles = pt.framework.OpRole
    for op in pops:
        role = op.attrs[roles.ATTR_NAME]
        assert not role & roles.Backward and role != roles.Optimize
        assert not [k for k in op.attrs if k.startswith("_")]
        if op.type in ("dropout", "batch_norm"):
            assert op.attrs["is_test"] is True
    assert any(op.type == "momentum" for op in pm.global_block().ops)
    assert not any(op.attrs.get("is_test")
                   for op in pm.global_block().ops)
    plain = pm.clone()
    assert plain.to_dict() == pm.to_dict()
    assert plain.global_block().ops[0] is not pm.global_block().ops[0]

    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    rng = np.random.RandomState(4)
    feed = {"x": rng.standard_normal((6, 16)).astype(np.float32),
            "label": rng.randint(0, 4, (6, 1)).astype(np.int64)}
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jm.list_vars() if v.persistable}
    # move the running statistics off their initial 0 / 1
    for n in params:
        if n.endswith(("mean", "variance")) or "batch_norm" in n:
            params[n] = params[n] + rng.uniform(0.1, 0.5, params[n].shape
                                                ).astype(np.float32)
            jscope.set_var(n, params[n])
    (want,) = jexe.run(jt, feed=feed, fetch_list=[jprob.name], scope=jscope)
    scope = pt.Scope()
    convert.load_params(scope, params, pt.CPUPlace(), [pm])
    (got,) = pt.Executor(pt.CPUPlace()).run(ptest, feed=feed,
                                            fetch_list=[pprob], scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
