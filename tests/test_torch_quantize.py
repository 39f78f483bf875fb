"""The int8 tier (paddle_tpu_torch/contrib/quantize.py,
paddle_tpu_torch/ops/int8_ops.py) against the JAX package's.

Bit for bit on the CPU: the four fake-quant ops and their
straight-through grads, the grids, sidecars and int8 storage that
freeze_int8 and convert_to_int8 write, and quantized_matmul /
quantized_conv2d given the same grids (int8 x int8 -> int32 is exact on
both sides; the port's plain version multiplies in float64).
training_transpile's programs are equal op for op, 3 QAT losses agree at
rtol 2e-4 and range_abs_max's state after them at rtol 1e-6.  The card's
path (`_int_mm` behind a zero-padding plan, im2col for the conv) is held
here to the plain version with `_int_mm` replaced by a CPU stand-in that
checks what cuBLASLt takes.  ROADMAP C18: the JAX freeze leaves an
activation-by-activation matmul reading grid values with no dequant; the
port keeps its float inputs.
"""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import QuantizeTranspiler as JQT
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import global_scope as jglobal_scope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu import inference as jinference
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, inference, testing
from paddle_tpu_torch.contrib import QuantizeTranspiler as PQT
from paddle_tpu_torch.ops import int8_ops
from paddle_tpu_torch.ops import registry as preg

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _run_both(op_type, inputs, attrs):
    j_in = {p: [jnp.asarray(a) for a in lst] for p, lst in inputs.items()}
    p_in = {p: [torch.as_tensor(np.array(a)) for a in lst]
            for p, lst in inputs.items()}
    j = jreg.run_forward(jreg.get_op_info(op_type), j_in, dict(attrs))
    p = preg.run_forward(preg.get_op_info(op_type), p_in, dict(attrs),
                         device=CPU)
    return ({k: [np.asarray(o) for o in v] for k, v in j.items()},
            {k: [o.numpy() for o in v] for k, v in p.items()})


def _assert_bitwise(j, p, what):
    assert sorted(j) == sorted(p), (what, sorted(j), sorted(p))
    for k in j:
        for a, b in zip(j[k], p[k]):
            assert a.shape == b.shape, (what, k, a.shape, b.shape)
            # integer outputs: JAX has x64 off (int32 where the port keeps
            # int64), so values compare, not dtypes
            np.testing.assert_array_equal(b, a.astype(b.dtype),
                                          err_msg=f"{what}.{k}")


# half-integer points of the grid (scale 127: x / scale * 127 = x) check
# that both round half to even
_TIES = np.array([127.0, -126.5, 63.5, 0.5, 1.5, 2.5, -0.5, -3.5, 0.0],
                 np.float32)


def _op_case(name):
    rng = np.random.RandomState(7)
    x = rng.standard_normal((6, 5)).astype(np.float32) * 3
    state = {"InScale": [np.array([0.7], np.float32)],
             "Iter": [np.array([12], np.int64)],
             "OutScalesIn": [np.abs(rng.standard_normal(8)).astype(
                 np.float32)]}
    return {
        "qdq_abs_max": ("fake_quantize_dequantize_abs_max", {"X": [x]},
                        {"bit_length": 8}),
        "qdq_abs_max_ties": ("fake_quantize_dequantize_abs_max",
                             {"X": [_TIES]}, {"bit_length": 8}),
        "qdq_abs_max_4bit": ("fake_quantize_dequantize_abs_max",
                             {"X": [x]}, {"bit_length": 4}),
        "abs_max": ("fake_quantize_abs_max", {"X": [x]}, {"bit_length": 8}),
        "abs_max_ties": ("fake_quantize_abs_max", {"X": [_TIES]}, {}),
        "range_train": ("fake_quantize_range_abs_max", dict({"X": [x]},
                        **state), {"bit_length": 8, "window_size": 8,
                                   "is_test": False}),
        "range_no_state": ("fake_quantize_range_abs_max",
                           {"X": [x], "InScale": state["InScale"]},
                           {"is_test": False}),
        "range_test": ("fake_quantize_range_abs_max", dict({"X": [x]},
                       **state), {"is_test": True}),
        "dequant": ("fake_dequantize_max_abs",
                    {"X": [np.round(x * 20)],
                     "Scale": [np.array([2.5], np.float32)]},
                    {"max_range": 127.0}),
    }[name]


@pytest.mark.parametrize("case", [
    "qdq_abs_max", "qdq_abs_max_ties", "qdq_abs_max_4bit", "abs_max",
    "abs_max_ties", "range_train", "range_no_state", "range_test",
    "dequant"])
def test_fake_quant_op_matches_jax_bitwise(case):
    op_type, inputs, attrs = _op_case(case)
    j, p = _run_both(op_type, inputs, attrs)
    _assert_bitwise(j, p, case)


@pytest.mark.parametrize("op_type", [
    "fake_quantize_dequantize_abs_max", "fake_quantize_abs_max",
    "fake_quantize_range_abs_max"])
def test_fake_quant_grads_are_straight_through(op_type):
    """X@GRAD = Out@GRAD in both packages' hand-written grads."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    gy = rng.standard_normal((4, 3)).astype(np.float32)
    inputs = {"X": [x], "Out@GRAD": [gy]}
    j = jreg.run_forward(jreg.get_runtime_info(op_type + "_grad"),
                         {k: [jnp.asarray(a) for a in v]
                          for k, v in inputs.items()}, {})
    p = preg.run_forward(preg.get_runtime_info(op_type + "_grad"),
                         {k: [torch.as_tensor(a) for a in v]
                          for k, v in inputs.items()}, {}, device=CPU)
    np.testing.assert_array_equal(p["X@GRAD"][0].numpy(), gy)
    np.testing.assert_array_equal(np.asarray(j["X@GRAD"][0]), gy)


# ---------------------------------------------------------------------------
# programs: the JAX test's fc net and conv net
# ---------------------------------------------------------------------------


def _guard(pkg):
    return jun.guard() if pkg is fluid else pt.unique_name.guard()


def _build(pkg, conv=False, seed=9):
    """(main, startup, loss, logits) of tests/test_quantize.py's nets."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    L = pkg.layers
    with pkg.program_guard(main, startup), _guard(pkg):
        y = L.data("y", shape=[1], dtype="int64")
        if conv:
            x = L.data("x", shape=[1, 8, 8], dtype="float32")
            c = L.conv2d(input=x, num_filters=4, filter_size=3, padding=1,
                         act="relu", param_attr="cw0")
            logits = L.fc(c, size=4, param_attr="w1")
        else:
            x = L.data("x", shape=[8], dtype="float32")
            h = L.fc(x, size=16, act="relu", param_attr="w0")
            logits = L.fc(h, size=4, param_attr="w1")
        loss = L.mean(L.softmax_with_cross_entropy(logits=logits, label=y))
    return main, startup, loss, logits


def _feed(conv=False, n=16, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 1, 8, 8) if conv else rng.randn(n, 8)).astype(
        np.float32)
    return {"x": x, "y": rng.randint(0, 4, (n, 1)).astype(np.int64)}


def _dicts_equal(a, b):
    """Program dicts equal, integer dtypes as one kind (x64 is off in
    the JAX package)."""
    def norm(d):
        for blk in d["blocks"]:
            for v in blk["vars"]:
                if str(v.get("dtype", "")).startswith("int") and \
                        v["dtype"] != "int8":
                    v["dtype"] = "int"
        return d
    assert norm(a.to_dict()) == norm(b.to_dict())


def _jax_persistables(program, jscope):
    return {v.name: np.asarray(jscope.find_var(v.name))
            for v in program.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}


def _qat_world(act_type, conv=False, steps=3, lr=0.05):
    """Both packages' QAT programs trained `steps` SGD steps from the JAX
    startup's weights: (jax side, port side, losses) with each side a
    (main, loss, logits, scope, exe)."""
    qkw = dict(activation_quantize_type=act_type, window_size=8)
    jmain, jstart, jloss, jlogits = _build(fluid, conv)
    JQT(**qkw).training_transpile(jmain, jstart)
    pmain, pstart, ploss, plogits = _build(pt, conv)
    PQT(**qkw).training_transpile(pmain, pstart)
    _dicts_equal(pmain, jmain)
    _dicts_equal(pstart, jstart)
    jtest, ptest = jmain.clone(for_test=True), pmain.clone(for_test=True)
    with fluid.program_guard(jmain, jstart), _guard(fluid):
        fluid.optimizer.SGD(learning_rate=lr).minimize(jloss)
    with pt.program_guard(pmain, pstart), _guard(pt):
        pt.optimizer.SGD(learning_rate=lr).minimize(ploss)
    _dicts_equal(pmain, jmain)
    jscope, pscope = JScope(), pt.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    pexe = pt.Executor(pt.CPUPlace())
    with jscope_guard(jscope):
        jexe.run(jstart)
    convert.load_params(pscope, _jax_persistables(jmain, jscope),
                        pt.CPUPlace(), [pmain])
    feed = _feed(conv)
    losses = []
    for _ in range(steps):
        with jscope_guard(jscope):
            (jl,) = jexe.run(jmain, feed=feed, fetch_list=[jloss.name])
        (pl,) = pexe.run(pmain, feed=feed, fetch_list=[ploss.name],
                         scope=pscope)
        losses.append((float(np.asarray(jl).reshape(-1)[0]),
                       float(np.asarray(pl).reshape(-1)[0])))
    return ((jtest, jloss, jlogits, jscope, jexe),
            (ptest, ploss, plogits, pscope, pexe), losses)


@pytest.mark.parametrize("act_type", ["abs_max", "range_abs_max"])
def test_qat_programs_losses_and_state_match_jax(act_type):
    """training_transpile (and SGD after it) gives the JAX program op for
    op, 3 QAT steps the JAX losses at rtol 2e-4, and range_abs_max's
    state (scale, window ring, step counter) the JAX state."""
    jside, pside, losses = _qat_world(act_type)
    jl, pl = np.array(losses).T
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
    assert pl[-1] < pl[0]
    if act_type == "range_abs_max":
        jscope, pscope = jside[3], pside[3]
        for suffix in ("scale@state", "scales@state", "iter@state"):
            got = pscope.find_var(f"x.{suffix}").numpy()
            want = np.asarray(jscope.find_var(f"x.{suffix}"))
            np.testing.assert_allclose(got, want.astype(got.dtype),
                                       rtol=1e-6, err_msg=suffix)
        assert int(pscope.find_var("x.iter@state")[0]) == 3
        assert float(pscope.find_var("x.scale@state")[0]) > 1e-3


def _freeze_in_both(conv, act_type, as_int8):
    jside, pside, _ = _qat_world(act_type, conv)
    jtest, _, jlogits, jscope, jexe = jside
    ptest, _, plogits, pscope, pexe = pside
    # the port freezes the JAX package's trained weights
    convert.load_params(pscope, _jax_persistables(jtest, jscope),
                        pt.CPUPlace(), [ptest])
    jq, pq = JQT(window_size=8), PQT(window_size=8)
    jq.freeze_int8(jtest, jscope, as_int8=as_int8)
    pq.freeze_int8(ptest, pscope, as_int8=as_int8)
    return (jtest, jlogits, jscope, jexe, jq), (ptest, plogits, pscope, pexe,
                                                 pq)


@pytest.mark.parametrize("conv", [False, True], ids=["fc", "conv"])
@pytest.mark.parametrize("act_type", ["abs_max", "range_abs_max"])
def test_freeze_int8_grids_sidecars_and_storage_bitwise(conv, act_type):
    """freeze_int8(as_int8=True) then convert_to_int8 in both packages on
    the same trained weights: equal programs, the weight grids, the
    @int8_scale sidecars and the int8 storage bit for bit, and the frozen
    logits bit for bit against the JAX interpreter (the int32 products are
    exact, the dequant the same float32 operations; XLA's jit of the whole
    program rounds the fused dequant an ulp away: rtol 1e-6 there)."""
    (jprog, jlogits, jscope, jexe, jq), (pprog, plogits, pscope, pexe,
                                          pq) = _freeze_in_both(
        conv, act_type, True)
    _dicts_equal(pprog, jprog)
    wnames = ("cw0", "w1") if conv else ("w0", "w1")
    types = [op.type for op in pprog.global_block().ops]
    assert types.count("quantized_conv2d" if conv else "quantized_matmul") \
        >= 1 and "quantized_matmul" in types
    for n in wnames + tuple(f"{w}@int8_scale" for w in wnames):
        np.testing.assert_array_equal(pscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)), n)
    feed = _feed(conv, n=4, seed=5)

    jinterp = fluid.Executor(fluid.CPUPlace(), mode="interpret")

    def run_both():
        with jscope_guard(jscope):
            (j,) = jinterp.run(jprog, feed=feed, fetch_list=[jlogits.name])
            (jj,) = jexe.run(jprog, feed=feed, fetch_list=[jlogits.name])
        (p,) = pexe.run(pprog, feed=feed, fetch_list=[plogits.name],
                        scope=pscope)
        np.testing.assert_array_equal(p, np.asarray(j))
        np.testing.assert_allclose(p, np.asarray(jj), rtol=1e-6, atol=1e-7)
        return p

    before = run_both()
    assert sorted(jq.convert_to_int8(jprog, jscope)) == \
        sorted(pq.convert_to_int8(pprog, pscope)) == sorted(wnames)
    for n in wnames:
        assert pscope.find_var(n).dtype == torch.int8
        assert pprog.global_block().var(n).dtype == "int8"
        np.testing.assert_array_equal(pscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    np.testing.assert_array_equal(run_both(), before)
    assert pq.convert_to_int8(pprog, pscope) == []   # idempotent


def test_load_params_carries_int8_weights_and_sidecars():
    """convert.load_params stages the JAX package's frozen int8 scope (int8
    weights, float32 sidecars) into the port as the frozen program
    declares them, and the port's run of it gives the JAX interpreter's
    logits bit for bit."""
    (jprog, jlogits, jscope, _, jq), (pprog, plogits, pscope, pexe, pq) = \
        _freeze_in_both(False, "abs_max", True)
    jq.convert_to_int8(jprog, jscope)
    pq.convert_to_int8(pprog, pscope)        # declares the int8 vars
    scope = pt.Scope()
    convert.load_params(scope, _jax_persistables(jprog, jscope),
                        pt.CPUPlace(), [pprog])
    assert scope.find_var("w0").dtype == torch.int8
    assert scope.find_var("w0@int8_scale").dtype == torch.float32
    feed = _feed(n=4, seed=7)
    with jscope_guard(jscope):
        (want,) = fluid.Executor(fluid.CPUPlace(), mode="interpret").run(
            jprog, feed=feed, fetch_list=[jlogits.name])
    (got,) = pexe.run(pprog, feed=feed, fetch_list=[plogits.name],
                      scope=scope)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_freeze_float_grid_form_matches_jax():
    """freeze_int8 without as_int8 (grid weights, fake_dequantize after
    each op) and freeze_program: equal programs and weights, logits at
    rtol 1e-6."""
    (jprog, jlogits, jscope, jexe, jq), (pprog, plogits, pscope, pexe,
                                          pq) = _freeze_in_both(
        False, "abs_max", False)
    _dicts_equal(pprog, jprog)
    assert "fake_dequantize_max_abs" in [op.type for op in
                                         pprog.global_block().ops]
    for n in ("w0", "w1"):
        np.testing.assert_array_equal(pscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    feed = _feed(n=4, seed=6)
    with jscope_guard(jscope):
        (j,) = jexe.run(jprog, feed=feed, fetch_list=[jlogits.name])
    (p,) = pexe.run(pprog, feed=feed, fetch_list=[plogits.name], scope=pscope)
    np.testing.assert_allclose(p, np.asarray(j), rtol=1e-6, atol=1e-7)
    # freeze_program re-rounds weights through the grid, bit for bit
    rng = np.random.RandomState(2)
    jmain, jstart, _, _ = _build(fluid)
    JQT().training_transpile(jmain, jstart)
    pmain, pstart, _, _ = _build(pt)
    PQT().training_transpile(pmain, pstart)
    js, ps = JScope(), pt.Scope()
    for n, shape in (("w0", (8, 16)), ("w1", (16, 4))):
        w = rng.randn(*shape).astype(np.float32)
        js.set_var(n, jnp.asarray(w))
        ps.set_var(n, torch.as_tensor(w))
    JQT().freeze_program(jmain, js)
    PQT().freeze_program(pmain, ps)
    for n in ("w0", "w1"):
        np.testing.assert_array_equal(ps.find_var(n).numpy(),
                                      np.asarray(js.find_var(n)))


# ---------------------------------------------------------------------------
# the int8 ops given the same grids
# ---------------------------------------------------------------------------


def _grid(rng, *shape, int8=False):
    g = rng.randint(-127, 128, shape)
    return g.astype(np.int8 if int8 else np.float32)


def _scales(rng):
    return {"Scale": [np.array([rng.uniform(0.5, 3)], np.float32)],
            "WScale": [np.array([rng.uniform(0.01, 0.2)], np.float32)]}


@pytest.mark.parametrize("case", [
    "mul", "mul_num_col_dims", "mul_int8_weight", "matmul", "matmul_tx",
    "matmul_ty_alpha", "matmul_batched", "matmul_batched_bcast"])
def test_quantized_matmul_bitwise(case):
    rng = np.random.RandomState(11)
    x, y, attrs = {
        "mul": (_grid(rng, 5, 24), _grid(rng, 24, 7), {}),
        "mul_num_col_dims": (_grid(rng, 2, 3, 4, 6), _grid(rng, 4, 6, 5),
                             {"x_num_col_dims": 2, "y_num_col_dims": 2}),
        "mul_int8_weight": (_grid(rng, 9, 16), _grid(rng, 16, 3, int8=True),
                            {}),
        "matmul": (_grid(rng, 4, 10), _grid(rng, 10, 6),
                   {"orig_type": "matmul"}),
        "matmul_tx": (_grid(rng, 10, 4), _grid(rng, 10, 6),
                      {"orig_type": "matmul", "transpose_X": True}),
        "matmul_ty_alpha": (_grid(rng, 4, 10), _grid(rng, 6, 10),
                            {"orig_type": "matmul", "transpose_Y": True,
                             "alpha": 0.3}),
        "matmul_batched": (_grid(rng, 2, 3, 4, 5), _grid(rng, 2, 3, 5, 6),
                           {"orig_type": "matmul"}),
        "matmul_batched_bcast": (_grid(rng, 2, 4, 5), _grid(rng, 5, 6),
                                 {"orig_type": "matmul"}),
    }[case]
    attrs.setdefault("orig_type", "mul")
    attrs.update(wq_range=127.0, aq_range=127.0)
    j, p = _run_both("quantized_matmul", dict({"X": [x], "Y": [y]},
                                              **_scales(rng)), attrs)
    _assert_bitwise(j, p, case)


_CONV_CASES = {
    "plain": ((2, 3, 9, 9), (4, 3, 3, 3), {}),
    "stride_pad": ((2, 3, 9, 8), (5, 3, 3, 3),
                   {"strides": [2, 2], "paddings": [1, 1]}),
    "dilation": ((1, 2, 11, 11), (3, 2, 3, 3),
                 {"dilations": [2, 2], "paddings": [2, 2]}),
    "groups": ((2, 4, 7, 7), (6, 2, 3, 3), {"groups": 2, "paddings": [1, 1]}),
    "depthwise": ((2, 4, 7, 7), (4, 1, 3, 3),
                  {"orig_type": "depthwise_conv2d", "groups": 0,
                   "paddings": [1, 1]}),
    "fuse_relu_1x1": ((2, 8, 5, 5), (4, 8, 1, 1), {"fuse_relu": True}),
}


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_quantized_conv2d_bitwise(case):
    xs, ws, attrs = _CONV_CASES[case]
    rng = np.random.RandomState(13)
    attrs = dict(attrs)
    attrs.setdefault("orig_type", "conv2d")
    attrs.update(wq_range=127.0, aq_range=127.0)
    j, p = _run_both("quantized_conv2d",
                     dict({"Input": [_grid(rng, *xs)],
                           "Filter": [_grid(rng, *ws, int8=True)]},
                          **_scales(rng)), attrs)
    _assert_bitwise(j, p, case)


def _int_mm_stand_in(calls):
    """torch._int_mm on the CPU, refusing what cuBLASLt's int8 path
    refuses: M <= 16, K or N not a multiple of 8, A not row-major, B not
    column-major."""
    def int_mm(a, b):
        m, k = a.shape
        n = b.shape[1]
        assert a.dtype == b.dtype == torch.int8
        assert m > 16 and k % 8 == 0 and n % 8 == 0, (m, k, n)
        assert a.is_contiguous() and b.t().is_contiguous()
        calls.append((m, k, n))
        return int8_ops.int8_matmul_reference(a, b)
    return int_mm


@pytest.mark.parametrize("case", sorted(_CONV_CASES) + ["decode_rows",
                                                        "batched"])
def test_card_path_equals_the_plain_version(case, monkeypatch):
    """The card's route (im2col, zero padding to M >= 32 and K, N
    multiples of 8, one product a group and a batch element) through a
    stand-in `_int_mm` gives the plain version's int32 exactly."""
    calls = []
    monkeypatch.setattr(torch, "_int_mm", _int_mm_stand_in(calls))
    rng = np.random.RandomState(17)
    if case == "decode_rows":     # 8 rows x 512 -> 30 (N not a multiple)
        a = torch.as_tensor(_grid(rng, 8, 12, int8=True))
        b = torch.as_tensor(_grid(rng, 12, 30, int8=True))
        np.testing.assert_array_equal(int8_ops._int_mm_nd(a, b),
                                      int8_ops.int8_matmul_reference(a, b))
        assert calls == [(32, 16, 32)]
        return
    if case == "batched":
        a = torch.as_tensor(_grid(rng, 2, 3, 5, 9, int8=True))
        b = torch.as_tensor(_grid(rng, 3, 9, 4, int8=True))
        np.testing.assert_array_equal(int8_ops._int_mm_nd(a, b),
                                      int8_ops.int8_matmul_reference(a, b))
        assert len(calls) == 6
        return
    xs, ws, attrs = _CONV_CASES[case]
    x = torch.as_tensor(_grid(rng, *xs, int8=True))
    w = torch.as_tensor(_grid(rng, *ws, int8=True))
    pad = attrs.get("paddings", [0, 0])
    stride = attrs.get("strides", [1, 1])
    dil = attrs.get("dilations", [1, 1])
    groups = attrs.get("groups", 1) or xs[1]
    got = int8_ops.conv_by_gemm(x, w, stride, pad, dil, groups,
                                int8_ops._int_mm_2d)
    want = int8_ops.int8_conv2d_reference(x, w, stride, pad, dil, groups)
    assert got.dtype == want.dtype == torch.int32
    np.testing.assert_array_equal(got, want)
    assert len(calls) == groups


def test_int8_ops_are_inference_only():
    """append_backward through a quantized op raises the JAX text."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        x.stop_gradient = False
        blk = main.global_block()
        for n, shape in (("w", (4, 3)), ("s", (1,)), ("ws", (1,))):
            blk.create_var(name=n, shape=shape, dtype="float32",
                           persistable=True)
        out = blk.create_var(name="out", shape=(-1, 3), dtype="float32")
        blk.append_op(type="quantized_matmul",
                      inputs={"X": [x], "Y": ["w"], "Scale": ["s"],
                              "WScale": ["ws"]},
                      outputs={"Out": [out]}, attrs={"orig_type": "mul"})
        loss = pt.layers.mean(out)
    with pytest.raises(RuntimeError, match="inference-only"):
        pt.backward.append_backward(loss, parameter_list=[x.name])


# ---------------------------------------------------------------------------
# ROADMAP C18
# ---------------------------------------------------------------------------


def _act_matmul(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _guard(pkg):
        x = pkg.layers.data("x", shape=[3, 4], dtype="float32",
                            append_batch_size=False)
        y = pkg.layers.data("y", shape=[4, 5], dtype="float32",
                            append_batch_size=False)
        out = pkg.layers.matmul(x, y)
    return main, startup, out


def test_c18_activation_matmul_keeps_float_inputs():
    """A matmul of two activations: the JAX freeze_int8 output is the
    float program's times 127^2 / (scale_x * scale_y) (grid values, no
    dequant); the port's frozen program reads the float inputs and equals
    the float program, and drops the quantize ops nothing reads."""
    rng = np.random.RandomState(18)
    feed = {"x": rng.randn(3, 4).astype(np.float32),
            "y": rng.randn(4, 5).astype(np.float32)}
    sx = np.abs(feed["x"]).max()
    sy = np.abs(feed["y"]).max()
    outs = {}
    for pkg, QT in ((fluid, JQT), (pt, PQT)):
        main, startup, out = _act_matmul(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = JScope() if pkg is fluid else pt.Scope()
        guard = jscope_guard(scope) if pkg is fluid else pt.scope_guard(
            scope)
        with guard:
            (ref,) = exe.run(main, feed=feed, fetch_list=[out.name])
            qt = QT()
            qt.training_transpile(main, startup)
            frozen = qt.freeze_int8(main.clone(for_test=True), scope,
                                    as_int8=True)
            (got,) = exe.run(frozen, feed=feed, fetch_list=[out.name])
        outs[pkg] = (np.asarray(ref), np.asarray(got),
                     [op.type for op in frozen.global_block().ops])
    jref, jgot, jtypes = outs[fluid]
    pref, pgot, ptypes = outs[pt]
    assert jtypes == ["fake_quantize_abs_max", "fake_quantize_abs_max",
                      "matmul"]
    # the JAX output is the product of the two grids, no dequant: the
    # float product times 127^2 / (scale_x * scale_y), up to the grids'
    # rounding
    qx = np.round(feed["x"] / sx * 127)
    qy = np.round(feed["y"] / sy * 127)
    np.testing.assert_array_equal(jgot, qx @ qy)
    np.testing.assert_allclose(jgot * (sx * sy / 127.0 ** 2), jref,
                               atol=2e-2 * np.abs(jref).max())
    assert np.abs(jgot).max() > 100 * np.abs(jref).max()
    assert ptypes == ["matmul"]
    np.testing.assert_array_equal(pgot, pref)
    np.testing.assert_allclose(pref, jref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# saved int8 models across the packages
# ---------------------------------------------------------------------------


def _save_int8(pkg, d):
    """The JAX inference test's int8 model: fc(6 -> 8, relu) -> fc(3,
    softmax), QAT-transpiled, frozen with as_int8, converted, saved."""
    QT = JQT if pkg is fluid else PQT
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), _guard(pkg):
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        h = pkg.layers.fc(input=x, size=8, act="relu", param_attr="qw0")
        out = pkg.layers.fc(input=h, size=3, act="softmax",
                            param_attr="qw1")
    qt = QT()
    qt.training_transpile(main, startup)
    infer = main.clone(for_test=True)
    if pkg is fluid:
        with jscope_guard(JScope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            frozen = qt.freeze_int8(infer, jglobal_scope(), as_int8=True)
            qt.convert_to_int8(frozen, jglobal_scope())
            fluid.io.save_inference_model(
                d, ["x"], [frozen.global_block().var(out.name)], exe,
                main_program=frozen)
        return
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    frozen = qt.freeze_int8(infer, scope, as_int8=True)
    qt.convert_to_int8(frozen, scope)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, ["x"],
                                   [frozen.global_block().var(out.name)],
                                   exe, main_program=frozen)


def test_jax_predictor_serves_the_ports_int8_directory(tmp_path):
    """The port writes an int8 directory (int8 weights and float32
    sidecars on disk) that the JAX Predictor loads as quantized; both
    packages' Predictors on it agree (rtol 1e-5)."""
    from paddle_tpu.ops.io_ops import load_array

    d = str(tmp_path / "port_int8")
    _save_int8(pt, d)
    assert load_array(os.path.join(d, "qw0")).dtype == np.int8
    assert load_array(os.path.join(d, "qw0@int8_scale")).dtype == np.float32
    feed = {"x": np.random.RandomState(4).randn(5, 6).astype(np.float32)}
    jp = jinference.create_predictor(jinference.Config(d))
    pp = inference.create_predictor(inference.Config(d, place=pt.CPUPlace()))
    assert jp.quantized and pp.quantized
    np.testing.assert_allclose(pp.run(feed)[0], np.asarray(jp.run(feed)[0]),
                               rtol=1e-5, atol=1e-7)


def test_int8_predictor_clones_in_threads(tmp_path):
    """4 clones of the port's Predictor on an int8 directory, run from 4
    threads, 3 runs each, give the sequential outputs (the JAX test's
    rtol 1e-6, atol 1e-7)."""
    d = str(tmp_path / "int8")
    _save_int8(pt, d)
    base = inference.create_predictor(inference.Config(d,
                                                       place=pt.CPUPlace()))
    rng = np.random.RandomState(8)
    runs = 3
    feeds = [{"x": rng.randn(4, 6).astype(np.float32)}
             for _ in range(4 * runs)]
    sequential = [base.run(f)[0] for f in feeds]
    predictors = [base.clone() for _ in range(4)]
    assert all(p.quantized for p in predictors)
    results = [None] * len(feeds)
    errors = []

    def worker(t, pred):
        try:
            for r in range(runs):
                i = t * runs + r
                results[i] = pred.run(feeds[i])[0]
        except Exception as e:  # surfaced after join
            errors.append((t, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t, p))
                   for t, p in enumerate(predictors)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for got, ref in zip(results, sequential):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_memory_usage_matches_jax():
    """contrib.memory_usage over the same program, float and frozen int8:
    the JAX package's bytes; int8 weights count one byte each."""
    jmain, jstart, _, _ = _build(fluid)
    pmain, pstart, _, _ = _build(pt)
    for b in (1, 16):
        assert pt.contrib.memory_usage(pmain, b) == \
            fluid.contrib.memory_usage(jmain, b)
    with pytest.raises(ValueError, match="batch_size"):
        pt.contrib.memory_usage(pmain, 0)
    (jprog, _, jscope, _, jq), (pprog, _, pscope, _, pq) = _freeze_in_both(
        False, "abs_max", True)
    jq.convert_to_int8(jprog, jscope)
    pq.convert_to_int8(pprog, pscope)
    assert pt.contrib.memory_usage(pprog, 16) == \
        fluid.contrib.memory_usage(jprog, 16)
    assert pt.contrib.memory_usage(pprog, 16)[1]["persistable_bytes"] < \
        pt.contrib.memory_usage(pmain, 16)[1]["persistable_bytes"]
