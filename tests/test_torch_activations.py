"""The activation family, the compare and logical ops (ops/activation_ops.py,
ops/math_ops.py, layers/ops.py) against the JAX package.

Each of the 35 activation op types runs in a small program in both
packages: X (a data var that takes a gradient) -> the op -> reduce_sum of
the output times a random cotangent, then `append_backward`.  The two
programs are identical op for op (Out-based grads included), and the
output and X's grad from each package's Executor agree at rtol 1e-5 /
atol 1e-6 in float32.  Inputs are drawn from a seed and kept 0.1 away from
each op's kinks and inside the domains of log, sqrt, rsqrt and reciprocal;
round meets exact halves.  A few ops also run a bfloat16 forward at 2e-2.
The six compare and logical op types match the JAX lowerings bit for bit,
and the layer wrappers build the JAX package's programs.
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
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import registry as preg

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (2, 4, 3, 3)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


# op type -> (attrs, kinks to keep 0.1 away from, (low, high) of the draw)
_WIDE = (-3.0, 3.0)
_POSITIVE = (0.5, 3.0)
ACTIVATIONS = {
    "sigmoid": ({}, (), _WIDE),
    "logsigmoid": ({}, (), _WIDE),
    "exp": ({}, (), _WIDE),
    "relu": ({}, (0.0,), _WIDE),
    "tanh": ({}, (), _WIDE),
    "tanh_shrink": ({}, (), _WIDE),
    "sqrt": ({}, (), _POSITIVE),
    "rsqrt": ({}, (), _POSITIVE),
    "abs": ({}, (0.0,), _WIDE),
    "ceil": ({}, (), _WIDE),
    "floor": ({}, (), _WIDE),
    "round": ({}, (), _WIDE),
    "cos": ({}, (), _WIDE),
    "sin": ({}, (), _WIDE),
    "reciprocal": ({}, (), _POSITIVE),
    "log": ({}, (), _POSITIVE),
    "square": ({}, (), _WIDE),
    "softplus": ({}, (), (-30.0, 30.0)),
    "softsign": ({}, (), _WIDE),
    "gelu": ({}, (), _WIDE),
    "relu6": ({}, (0.0, 6.0), (-3.0, 8.0)),
    "leaky_relu": ({}, (0.0,), _WIDE),
    "elu": ({"alpha": 0.7}, (0.0,), _WIDE),
    "brelu": ({"t_min": -1.0, "t_max": 2.0}, (-1.0, 2.0), _WIDE),
    "soft_relu": ({"threshold": 2.0}, (-2.0, 2.0), _WIDE),
    "stanh": ({}, (), _WIDE),
    "hard_sigmoid": ({}, (-2.5, 2.5), (-4.0, 4.0)),
    "thresholded_relu": ({}, (1.0,), _WIDE),
    "hard_shrink": ({}, (-0.5, 0.5), _WIDE),
    "softshrink": ({"lambda": 0.8}, (-0.8, 0.8), _WIDE),
    "swish": ({"beta": 1.5}, (), _WIDE),
    "softmax": ({}, (), _WIDE),
    "log_softmax": ({"axis": 1}, (), _WIDE),
    "maxout": ({"groups": 2}, (), _WIDE),
    "prelu": ({"mode": "channel"}, (0.0,), _WIDE),
}


def _draw(op_type, seed=0):
    attrs, kinks, (lo, hi) = ACTIVATIONS[op_type]
    rng = np.random.RandomState(seed)
    x = rng.uniform(lo, hi, SHAPE).astype(np.float32)
    for k in kinks:
        x = np.where(np.abs(x - k) < 0.1,
                     x + np.where(x >= k, 0.1, -0.1), x).astype(np.float32)
    if op_type == "round":   # halves round to even
        x.reshape(-1)[:6] = [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5]
    return x


def test_the_family_is_the_jax_packages():
    assert sorted(ACTIVATIONS) == sorted(
        t for t in jreg.OPS
        if jreg.OPS[t].forward.__module__.endswith("activation_ops"))
    assert all(preg.is_registered(t) for t in ACTIVATIONS)


def _build(pkg, guard, op_type, attrs):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        x = pkg.layers.data(name="x", shape=list(SHAPE[1:]),
                            dtype="float32")
        x.stop_gradient = False
        if op_type == "prelu":
            out = pkg.layers.prelu(x, **attrs)
        elif op_type == "log_softmax":
            out = pkg.layers.log_softmax(x, **attrs)
        elif op_type == "softmax":
            out = pkg.layers.softmax(x)
        elif op_type == "relu":
            out = pkg.layers.relu(x)
        else:
            out = getattr(pkg.layers, op_type)(x, **attrs)
        cot = pkg.layers.data(name="cot", shape=list(out.shape[1:]),
                              dtype="float32")
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(out, cot))
        pkg.append_backward(loss)
    return main, startup, out


def _normalized(prog):
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


@pytest.mark.parametrize("op_type", sorted(ACTIVATIONS))
def test_forward_and_x_grad_match_jax(op_type):
    attrs = ACTIVATIONS[op_type][0]
    jm, js, jout = _build(fluid, jun.guard, op_type, attrs)
    pm, ps, pout = _build(pt, pt.unique_name.guard, op_type, attrs)
    assert _normalized(pm) == _normalized(jm)
    x = _draw(op_type)
    feed = {"x": x, "cot": np.random.RandomState(1).standard_normal(
        (SHAPE[0],) + tuple(jout.shape[1:])).astype(np.float32)}
    fetch = [jout.name, "x@GRAD"]
    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    want = [np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=fetch,
                                            scope=jscope)]
    pscope = pt.Scope()
    for v in pm.list_vars():
        if v.persistable:
            pscope.set_var(v.name, torch.as_tensor(
                np.asarray(jscope.find_var(v.name))))
    got = pt.Executor(pt.CPUPlace()).run(pm, feed=feed, fetch_list=fetch,
                                         scope=pscope)
    for name, g, w in zip(fetch, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{op_type} {name}")
    assert np.abs(want[1]).max() > 0 or op_type in ("ceil", "floor", "round")


def test_out_based_grads_build_the_jax_program():
    """sigmoid, relu6 and sqrt in one net: their grad ops read Out and
    Out@GRAD only, in both packages' append_backward programs."""
    progs = []
    for pkg, guard in ((fluid, jun.guard), (pt, pt.unique_name.guard)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            img = pkg.layers.data(name="img", shape=[8], dtype="float32")
            h = pkg.layers.fc(input=img, size=6, act="sigmoid")
            h = pkg.layers.relu6(pkg.layers.fc(input=h, size=6),
                                 threshold=4.0)
            h = pkg.layers.sqrt(pkg.layers.scale(h, bias=1.0))
            loss = pkg.layers.mean(pkg.layers.fc(input=h, size=1))
            pkg.append_backward(loss)
        progs.append(main)
    jm, pm = progs
    assert _normalized(pm) == _normalized(jm)
    ops = {op.type: op for op in pm.global_block().ops}
    for t in ("sigmoid_grad", "relu6_grad", "sqrt_grad"):
        assert sorted(ops[t].inputs) == ["Out", "Out@GRAD"], t
    assert ops["relu6_grad"].attrs["threshold"] == 4.0


def _run_op(reg, op_type, inputs, attrs, dtype, out_names):
    info = reg.get_runtime_info(op_type)
    if reg is jreg:
        ins = {p: [jnp.asarray(a, dtype=dtype) for a in v]
               for p, v in inputs.items()}
        outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names)
        return {p: [np.asarray(o) for o in v] for p, v in outs.items()}
    tdtype = {jnp.bfloat16: torch.bfloat16, None: None}.get(dtype)
    ins = {p: [torch.as_tensor(np.array(a)) if tdtype is None
               else torch.as_tensor(np.array(a)).to(tdtype) for a in v]
           for p, v in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names,
                           device=torch.device("cpu"))
    return {p: [o.float().numpy() if o.dtype == torch.bfloat16
                else o.numpy() for o in v] for p, v in outs.items()}


@pytest.mark.parametrize("op_type", ["sigmoid", "softplus", "swish",
                                     "leaky_relu", "stanh", "hard_sigmoid",
                                     "elu", "log_softmax"])
def test_bf16_forward_matches_jax(op_type):
    """bfloat16 in, bfloat16 out: within 2e-2 of the largest output (both
    round the scalar attrs to bfloat16 first)."""
    attrs = ACTIVATIONS[op_type][0]
    x = _draw(op_type, seed=2)
    outs = {"Out": ["o"]}
    j = _run_op(jreg, op_type, {"X": [x]}, attrs, jnp.bfloat16, outs)
    p = _run_op(preg, op_type, {"X": [x]}, attrs, jnp.bfloat16, outs)
    a = j["Out"][0].astype(np.float32)
    np.testing.assert_allclose(p["Out"][0], a, rtol=2e-2,
                               atol=2e-2 * np.abs(a).max())


@pytest.mark.parametrize("mode", ["all", "channel", "element"])
def test_prelu_modes_match_jax(mode):
    rng = np.random.RandomState(3)
    x = _draw("prelu")
    alpha = rng.uniform(0.1, 0.9, {"all": (1,), "channel": (1, 4, 1, 1),
                                   "element": (1,) + SHAPE[1:]}[mode])
    inputs = {"X": [x], "Alpha": [alpha.astype(np.float32)]}
    j = _run_op(jreg, "prelu", inputs, {"mode": mode}, None, {"Out": ["o"]})
    p = _run_op(preg, "prelu", inputs, {"mode": mode}, None, {"Out": ["o"]})
    np.testing.assert_allclose(p["Out"][0], j["Out"][0], rtol=RTOL,
                               atol=ATOL)


def test_maxout_keeps_the_channel_order():
    """Channels 0-1 form group 0, 2-3 group 1 (n, c // g, g, h, w)."""
    x = np.arange(2 * 4 * 1 * 1, dtype=np.float32).reshape(2, 4, 1, 1)
    p = _run_op(preg, "maxout", {"X": [x]}, {"groups": 2}, None,
                {"Out": ["o"]})
    np.testing.assert_array_equal(p["Out"][0].reshape(2, 2),
                                  [[1, 3], [5, 7]])


# ------------------------------------------------- compare and logical ops


@pytest.mark.parametrize("op_type,y_shape,axis", [
    ("equal", (3, 4), -1), ("not_equal", (3, 4), -1), ("equal", (3,), 1),
    ("not_equal", (4,), -1), ("less_than", (3,), 1),
    ("greater_equal", (3, 4), -1)])
def test_compare_ops_match_jax_bit_for_bit(op_type, y_shape, axis):
    rng = np.random.RandomState(4)
    x = rng.randint(0, 3, (2, 3, 4)).astype(np.float32)
    y = rng.randint(0, 3, y_shape).astype(np.float32)
    inputs = {"X": [x], "Y": [y]}
    attrs = {"axis": axis}
    j = _run_op(jreg, op_type, inputs, attrs, None, {"Out": ["o"]})
    p = _run_op(preg, op_type, inputs, attrs, None, {"Out": ["o"]})
    assert p["Out"][0].dtype == np.bool_ == j["Out"][0].dtype
    np.testing.assert_array_equal(p["Out"][0], j["Out"][0])


@pytest.mark.parametrize("op_type", ["logical_and", "logical_or",
                                     "logical_xor", "logical_not"])
def test_logical_ops_match_jax_bit_for_bit(op_type):
    rng = np.random.RandomState(5)
    inputs = {"X": [rng.rand(3, 5) < 0.5]}
    if op_type != "logical_not":
        inputs["Y"] = [rng.rand(3, 5) < 0.5]
    j = _run_op(jreg, op_type, inputs, {}, None, {"Out": ["o"]})
    p = _run_op(preg, op_type, inputs, {}, None, {"Out": ["o"]})
    assert p["Out"][0].dtype == np.bool_ == j["Out"][0].dtype
    np.testing.assert_array_equal(p["Out"][0], j["Out"][0])
    assert preg.get_op_info(op_type).no_grad


def test_compare_and_logical_layers_build_the_jax_program():
    """layers.equal/not_equal/less_than (control_flow's helpers, no axis
    attr), the generated logical_* wrappers and layers.ops' compare
    wrapper (with an axis attr), then run through the port's Executor
    against the JAX package's."""
    progs = []
    for pkg, guard in ((fluid, jun.guard), (pt, pt.unique_name.guard)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            a = pkg.layers.data(name="a", shape=[5], dtype="float32")
            b = pkg.layers.data(name="b", shape=[5], dtype="float32")
            eq = pkg.layers.equal(a, b)
            ne = pkg.layers.not_equal(a, b)
            lt = pkg.layers.less_than(a, b)
            both = pkg.layers.logical_and(eq, lt)
            either = pkg.layers.logical_or(ne, lt)
            odd = pkg.layers.logical_xor(both, either)
            out = pkg.layers.logical_not(odd)
            ge = pkg.layers.ops.greater_equal(a, b)   # axis attr, as ops'
        progs.append((main, [eq, ne, lt, both, either, odd, out, ge]))
    (jm, jf), (pm, pf) = progs
    assert _normalized(pm) == _normalized(jm)
    rng = np.random.RandomState(6)
    feed = {"a": rng.randint(0, 2, (4, 5)).astype(np.float32),
            "b": rng.randint(0, 2, (4, 5)).astype(np.float32)}
    want = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=[v.name for v in jf], scope=JScope())
    got = pt.Executor(pt.CPUPlace()).run(pm, feed=feed, fetch_list=pf,
                                         scope=pt.Scope())
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
