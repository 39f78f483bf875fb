"""The tensor, math and random op tails (ops/tensor_ops.py, ops/math_ops.py,
ops/random_ops.py) against the JAX package's lowerings.

- Every new tensor and math op type through both registries on the same
  seeded inputs (the JAX package's own OpTest cases where it has them:
  tests/test_ops_shape_tail.py, test_ops_misc_tail.py): float32 outputs
  at atol 1e-5, integer and bool outputs exact.  The `*2` ops' XShape
  has the JAX shape.  arg_max, arg_min and argsort on ties (first index,
  a stable sort).  `scatter` on unique ids only: which update wins for a
  repeated id is undefined in both packages.
- The differentiable ones through both packages' `append_backward` and
  Executors: the same program, the output and the input grads at rtol
  1e-4 / atol 1e-5; no gradient flows through XShape.
- The `no_jit` trio (range, linspace, where): equal outputs, the jit
  plan puts them between segments, and `program_as_function` refuses
  them on a fetch path, as the JAX package does.
- The random ops cannot match jax.random's draws (ROADMAP C2): shape,
  dtype, range and moments; truncated_gaussian_random inside mean +- 2
  std; sampling_id's frequencies; a replay of the same run draws the
  same.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
import test_ops_misc_tail as jmisc
import test_ops_shape_tail as jshape
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu_torch import testing
from paddle_tpu_torch.framework import executor as pexec
from torch_op_parity import (
    assert_forward,
    assert_grads,
    assert_same_program,
    optest_case,
)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


_R = np.random.RandomState(0)
X345 = _f32(_R, 3, 4, 5)
X1 = _f32(_R, 2, 1, 3, 1)
TIES = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, -1.0, -1.0, 2.0],
                 [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
NEG_INTS = np.array([[-7, -6, -5, 5, 6, 7]], np.int32)

# id -> (op type, inputs, attrs, outputs not compared by value)
FORWARD = {
    "reshape2": ("reshape2", {"X": [X345]}, {"shape": [0, -1]},
                 ("XShape",)),
    "transpose": ("transpose", {"X": [X345]}, {"axis": [2, 0, 1]}, ()),
    "transpose2": ("transpose2", {"X": [X345]}, {"axis": [1, 2, 0]},
                   ("XShape",)),
    "split_num": ("split", {"X": [X345]}, {"axis": 1, "num": 2,
                                           "sections": []}, ()),
    "split_sections": ("split", {"X": [X345]},
                       {"axis": 2, "num": 0, "sections": [1, 3, 1]}, ()),
    "squeeze_axes": ("squeeze", {"X": [X1]}, {"axes": [1, 2]}, ()),
    "squeeze_all": ("squeeze", {"X": [X1]}, {"axes": []}, ()),
    "squeeze2": ("squeeze2", {"X": [X1]}, {"axes": [-1]}, ("XShape",)),
    "unsqueeze": ("unsqueeze", {"X": [X345]}, {"axes": [3, 0]}, ()),
    "unsqueeze2": ("unsqueeze2", {"X": [X345]}, {"axes": [1]},
                   ("XShape",)),
    "unstack": ("unstack", {"X": [X345]}, {"axis": 1}, ()),
    "expand_short": ("expand", {"X": [X345]}, {"expand_times": [2, 1]}, ()),
    "pad2d_constant": ("pad2d", {"X": [_f32(_R, 2, 3, 4, 5)]},
                       {"paddings": [1, 0, 2, 3], "mode": "constant",
                        "pad_value": 0.5}, ()),
    "pad2d_edge": ("pad2d", {"X": [_f32(_R, 2, 3, 4, 5)]},
                   {"paddings": [2, 1, 0, 3], "mode": "edge"}, ()),
    "arg_max_ties": ("arg_max", {"X": [TIES]}, {"axis": 1}, ()),
    "arg_min_ties": ("arg_min", {"X": [TIES]}, {"axis": -1}, ()),
    "argsort_ties": ("argsort", {"X": [TIES]}, {"axis": 1}, ()),
    "argsort_axis0_ties": ("argsort", {"X": [TIES]}, {"axis": 0}, ()),
    "shape": ("shape", {"Input": [X345]}, {}, ()),
    "fill": ("fill", {}, {"shape": [2, 3], "dtype": "float32",
                          "value": [0.1, -2.0, 3.5, 4.0, 1e-3, 7.0]}, ()),
    "fill_int": ("fill", {}, {"shape": [3], "dtype": "int64",
                              "value": [1.0, -2.0, 3.0]}, ()),
    "fill_zeros_like": ("fill_zeros_like", {"X": [X345]}, {}, ()),
    "select_rows": ("select", {"Condition": [np.array([[1], [0], [1]],
                                                      np.int32)],
                               "X": [X345], "Y": [-X345]}, {}, ()),
    "select_aligned": ("select",
                       {"Condition": [(X345 > 0)[0]],
                        "X": [X345], "Y": [X345 * 3.0]}, {}, ()),
    "diag": ("diag", {"Diagonal": [_f32(_R, 5)]}, {}, ()),
    "reverse": ("reverse", {"X": [X345]}, {"axis": [0, 2]}, ()),
    "reverse_int_axis": ("reverse", {"X": [X345]}, {"axis": 1}, ()),
    "floordiv_neg_int": ("elementwise_floordiv",
                         {"X": [NEG_INTS], "Y": [np.array([2], np.int32)]},
                         {"axis": -1}, ()),
    "floordiv_float": ("elementwise_floordiv",
                       {"X": [X345 * 5.0], "Y": [np.abs(X345) + 0.5]},
                       {"axis": -1}, ()),
    "cumsum_axis0": ("cumsum", {"X": [X345]}, {"axis": 0}, ()),
    "cumsum_exclusive": ("cumsum", {"X": [X345]},
                         {"axis": 2, "exclusive": True}, ()),
    "cumsum_reverse": ("cumsum", {"X": [X345]}, {"axis": 1, "reverse": True},
                       ()),
    "cumsum_int": ("cumsum", {"X": [NEG_INTS]}, {"axis": 1}, ()),
    "isfinite": ("isfinite", {"X": [X345]}, {}, ()),
    "isfinite_inf": ("isfinite", {"X": [np.array([1.0, np.inf], np.float32)]},
                     {}, ()),
    "isinf": ("isinf", {"X": [np.array([1.0, -np.inf], np.float32)]}, {},
              ()),
    "isinf_none": ("isinf", {"X": [X345]}, {}, ()),
    "isnan": ("isnan", {"X": [np.array([np.nan, 1.0], np.float32)]}, {},
              ()),
    "isnan_none": ("isnan", {"X": [X345]}, {}, ()),
    "pow_int": ("pow", {"X": [NEG_INTS]}, {"factor": 2.0}, ()),
}

# id -> a JAX package OpTest class whose inputs and attrs are used
OPTESTS = {
    "scatter": jshape.TestScatter, "arg_max": jshape.TestArgMax,
    "arg_min": jshape.TestArgMin, "argsort": jshape.TestArgsort,
    "stack": jshape.TestStack, "expand": jshape.TestExpand,
    "pad": jshape.TestPad, "pad2d_reflect": jshape.TestPad2dReflect,
    "cumsum": jmisc.TestCumsum,
    "cumsum_exclusive_reverse": jmisc.TestCumsumExclusiveReverse,
    "pow": jmisc.TestPow,
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_matches_jax(case):
    op_type, inputs, attrs, skip = FORWARD[case]
    j, p = assert_forward(op_type, inputs, attrs, skip=skip)
    for param in skip:     # XShape: [0, *X.shape], no elements
        assert p[param][0].shape == (0,) + inputs["X"][0].shape


@pytest.mark.parametrize("case", sorted(OPTESTS))
def test_optest_cases_match_jax(case):
    cls = OPTESTS[case]
    inputs, attrs = optest_case(cls)
    assert_forward(cls.op_type, inputs, attrs)


def test_argsort_and_arg_max_take_the_first_of_equal_entries():
    j, p = assert_forward("argsort", {"X": [TIES]}, {"axis": 1})
    np.testing.assert_array_equal(p["Indices"][0][1], [2, 3, 0, 1, 4])
    np.testing.assert_array_equal(p["Indices"][0][2], [0, 1, 2, 3, 4])
    _, p = assert_forward("arg_max", {"X": [TIES]}, {"axis": 1})
    np.testing.assert_array_equal(p["Out"][0], [1, 0, 0])


# id -> (op type, inputs, attrs, differentiable inputs, {output: count})
GRADS = {
    "reshape2": ("reshape2", {"X": [X345]}, {"shape": [4, -1]}, ["X"],
                 {"Out": 1}),
    "transpose": ("transpose", {"X": [X345]}, {"axis": [2, 0, 1]}, ["X"],
                  {"Out": 1}),
    "transpose2": ("transpose2", {"X": [X345]}, {"axis": [1, 2, 0]}, ["X"],
                   {"Out": 1}),
    "split": ("split", {"X": [X345]}, {"axis": 2, "num": 0,
                                       "sections": [2, 3]}, ["X"],
              {"Out": 2}),
    "squeeze": ("squeeze", {"X": [X1]}, {"axes": [1]}, ["X"], {"Out": 1}),
    "squeeze2": ("squeeze2", {"X": [X1]}, {"axes": []}, ["X"], {"Out": 1}),
    "unsqueeze": ("unsqueeze", {"X": [X345]}, {"axes": [0, 2]}, ["X"],
                  {"Out": 1}),
    "unsqueeze2": ("unsqueeze2", {"X": [X345]}, {"axes": [3]}, ["X"],
                   {"Out": 1}),
    "stack": ("stack", {"X": [X345, 2.0 * X345]}, {"axis": 1}, ["X"],
              {"Y": 1}),
    "unstack": ("unstack", {"X": [X345]}, {"axis": 0}, ["X"], {"Y": 3}),
    "expand": ("expand", {"X": [X345]}, {"expand_times": [1, 2, 3]}, ["X"],
               {"Out": 1}),
    "pad": ("pad", {"X": [X345]}, {"paddings": [1, 0, 0, 2, 1, 1],
                                   "pad_value": 0.25}, ["X"], {"Out": 1}),
    "pad2d_reflect": ("pad2d", {"X": [_f32(_R, 1, 2, 4, 5)]},
                      {"paddings": [1, 2, 3, 1], "mode": "reflect"}, ["X"],
                      {"Out": 1}),
    "pad2d_edge": ("pad2d", {"X": [_f32(_R, 1, 2, 4, 5)]},
                   {"paddings": [2, 0, 1, 3], "mode": "edge"}, ["X"],
                   {"Out": 1}),
    "scatter": ("scatter", {"X": [_f32(_R, 6, 3)],
                            "Ids": [np.array([4, 0, 2], np.int64)],
                            "Updates": [_f32(_R, 3, 3)]}, {},
                ["X", "Updates"], {"Out": 1}),
    "select": ("select", {"Condition": [np.array([1, 0, 1], np.int32)],
                          "X": [X345], "Y": [X345 * 0.5]}, {}, ["X", "Y"],
               {"Out": 1}),
    "reverse": ("reverse", {"X": [X345]}, {"axis": [1]}, ["X"], {"Out": 1}),
    "cumsum": ("cumsum", {"X": [X345]}, {"axis": 1, "exclusive": True,
                                         "reverse": True}, ["X"],
               {"Out": 1}),
    "pow": ("pow", {"X": [np.abs(X345) + 0.5]}, {"factor": 2.5}, ["X"],
            {"Out": 1}),
    "fill_zeros_like": ("fill_zeros_like", {"X": [X345]}, {}, ["X"],
                        {"Out": 1}),
    "floordiv": ("elementwise_floordiv",
                 {"X": [X345 * 5.0], "Y": [np.abs(X345) + 0.5]}, {"axis": -1},
                 ["X", "Y"], {"Out": 1}),
}


@pytest.mark.parametrize("case", sorted(GRADS))
def test_grads_match_jax(case):
    op_type, inputs, attrs, diff, outs = GRADS[case]
    assert_grads(op_type, inputs, attrs, diff, outs, seed=len(case))


# --------------------------------------------------------- the no_jit trio


def _scalar(v, dtype):
    return np.array([v], dtype)


@pytest.mark.parametrize("dtype,start,end,step", [
    ("float32", 0.5, 3.7, 0.4), ("int32", -3, 11, 3), ("int64", 10, 0, -2)])
def test_range_matches_jax(dtype, start, end, step):
    assert_forward("range", {"Start": [_scalar(start, dtype)],
                             "End": [_scalar(end, dtype)],
                             "Step": [_scalar(step, dtype)]}, {})


def test_linspace_and_where_match_jax():
    assert_forward("linspace", {"Start": [_scalar(-1.5, "float32")],
                                "Stop": [_scalar(2.0, "float32")],
                                "Num": [_scalar(7, "int32")]}, {})
    cond = np.array([[True, False, True], [False, False, True]])
    _, p = assert_forward("where", {"Condition": [cond]}, {})
    np.testing.assert_array_equal(p["Out"][0], np.argwhere(cond))


def _range_program(pkg):
    """x * 2 -> range(0, 4, 1) -> the range's values plus x's first four
    entries: a no_jit op between two jit segments."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32",
                            append_batch_size=False)
        y = pkg.layers.scale(x, scale=2.0)
        r = pkg.layers.tensor.range(0.0, 4.0, 1.0, "float32")
        out = pkg.layers.elementwise_add(y, r)
    return main, out


def test_range_runs_between_segments_and_not_on_a_fetch_path():
    jm, jout = _range_program(fluid)
    pm, pout = _range_program(pt)
    assert_same_program(jm, pm)
    plan = pexec.build_plan(pm, [pout.name])
    hosts = [i for i in plan if not isinstance(i, pexec._Segment)]
    assert [pm.global_block().ops[i].type for i in hosts] == ["range"]
    assert isinstance(plan[0], pexec._Segment)
    assert isinstance(plan[-1], pexec._Segment)
    feed = {"x": np.array([1.0, -2.0, 0.5, 3.0], np.float32)}
    want = np.asarray(fluid.Executor(fluid.CPUPlace(), mode="interpret").run(
        jm, feed=feed, fetch_list=[jout.name], scope=JScope())[0])
    for mode in ("jit", "interpret"):
        got = pt.Executor(pt.CPUPlace(), mode=mode).run(
            pm, feed=feed, fetch_list=[pout.name], scope=pt.Scope())[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="no_jit"):
        pexec.program_as_function(pm, pt.Scope(), [pout.name],
                                  place=pt.CPUPlace())


# ------------------------------------------------------------- random ops


def _draw(op_type, attrs, inputs=None, seed=5, runs=1):
    """Run one random op in the port's Executor (jit path on the CPU);
    -> [output per run]."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    with pt.program_guard(main, startup):
        block = main.global_block()
        ivars = {}
        for param, arr in (inputs or {}).items():
            ivars[param] = [block.create_var(name=param, shape=list(arr.shape),
                                             dtype=str(arr.dtype))]
        out = block.create_var(name="out", dtype=attrs.get("dtype",
                                                           "float32"))
        block.append_op(type=op_type, inputs=ivars, outputs={"Out": [out]},
                        attrs=attrs)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    return [exe.run(main, feed=dict(inputs or {}), fetch_list=["out"],
                    scope=scope)[0] for _ in range(runs)], main


def test_uniform_random_batch_size_like_draws_the_batch_dim():
    x = np.zeros((7, 3), np.float32)
    (a, b), main = _draw("uniform_random_batch_size_like",
                         {"shape": [-1, 3000], "min": -2.0, "max": 3.0,
                          "dtype": "float32"}, {"Input": x}, runs=2)
    assert main.global_block().var("out").shape == (7, 3000)
    assert a.shape == (7, 3000) and a.dtype == np.float32
    assert a.min() >= -2.0 and a.max() < 3.0
    assert abs(a.mean() - 0.5) < 0.03
    assert abs(a.var() - 25.0 / 12.0) < 0.05
    assert not np.array_equal(a, b)     # the next run draws anew


def test_gaussian_random_batch_size_like_moments():
    x = np.zeros((3, 5, 2), np.float32)
    (a,), _ = _draw("gaussian_random_batch_size_like",
                    {"shape": [4, -1, 4000], "input_dim_idx": 1,
                     "output_dim_idx": 1, "mean": 1.5, "std": 0.5,
                     "dtype": "float32"}, {"Input": x})
    assert a.shape == (4, 5, 4000)
    assert abs(a.mean() - 1.5) < 0.01 and abs(a.std() - 0.5) < 0.01


def test_truncated_gaussian_random_stays_within_two_std():
    (a,), _ = _draw("truncated_gaussian_random",
                    {"shape": [200, 500], "mean": -1.0, "std": 2.0,
                     "dtype": "float32"})
    assert a.shape == (200, 500) and a.dtype == np.float32
    assert a.min() >= -1.0 - 4.0 and a.max() <= -1.0 + 4.0
    assert abs(a.mean() + 1.0) < 0.02
    # the variance of a standard normal truncated to [-2, 2]: 0.7737
    assert abs(a.std() / 2.0 - np.sqrt(0.77372)) < 0.01
    assert (np.abs(a + 1.0) > 3.6).mean() > 0.005    # reaches the tails


def test_sampling_id_follows_the_row_probabilities():
    probs = np.array([[0.1, 0.0, 0.6, 0.3]] * 4000 + [[0.0, 1.0, 0.0, 0.0]],
                     np.float32)
    (ids,), _ = _draw("sampling_id", {"dtype": "int64"}, {"X": probs})
    assert ids.shape == (4001,) and ids.dtype == np.int64
    assert ids[-1] == 1
    freq = np.bincount(ids[:-1], minlength=4) / 4000.0
    np.testing.assert_allclose(freq, [0.1, 0.0, 0.6, 0.3], atol=0.03)


def test_a_rerun_in_a_fresh_scope_draws_the_same():
    attrs = {"shape": [64], "mean": 0.0, "std": 1.0, "dtype": "float32"}
    (a,), _ = _draw("truncated_gaussian_random", attrs, seed=9)
    (b,), _ = _draw("truncated_gaussian_random", attrs, seed=9)
    (c,), _ = _draw("truncated_gaussian_random", attrs, seed=10)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_random_builders_and_initializers_infer_shapes():
    """layers.uniform_random / gaussian_random build the JAX package's
    programs (shape inference draws nothing)."""
    progs = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            pkg.layers.uniform_random([3, 4], min=-0.5, max=0.5)
            pkg.layers.gaussian_random([2, 5], mean=1.0, std=0.1)
        progs.append(main)
    assert_same_program(*progs)
    assert progs[1].global_block().ops[0].type == "uniform_random"
    assert tuple(progs[1].global_block().vars[
        progs[1].global_block().ops[1].output("Out")[0]].shape) == (2, 5)
