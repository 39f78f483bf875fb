"""The recurrent ops and the reduce family against the JAX package's.

`fused_lstm` and `fused_gru` (ops/rnn_ops.py) on numpy-seeded inputs,
forward and the registry's generic grad (the forward replayed under
autograd, where the JAX package takes `jax.vjp` of its scan) for X,
WeightX, WeightH, Bias, H0 and C0, with and without `is_reverse`, with
cotangents on every output: float32 within 1e-5 relative (and 1e-6 of
the output's largest magnitude, for elements near 0), bfloat16 within
2e-2 of each output's largest magnitude (both packages round every gate
to bfloat16, in other orders; the JAX package's input projection runs
with float32 operands, tests/jax_reference.py).  The reduce family (sum, mean, max, min,
prod) over `dim`, `keep_dim` and `reduce_all`, and `reduce_max`'s and
`reduce_min`'s grads on tied inputs: the cotangent split equally among
the tied extrema, as `jax.vjp` of `jnp.max` splits it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_reference import f32_rnn_projection
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import registry as preg

B, S, D, H = 3, 5, 8, 6
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
OUTS = {"fused_lstm": ("Out", "LastH", "LastC"), "fused_gru": ("Out", "LastH")}
GATES = {"fused_lstm": 4, "fused_gru": 3}


@pytest.fixture(autouse=True)
def _fresh_port(monkeypatch):
    f32_rnn_projection(monkeypatch)   # bfloat16 on the CPU: see the helper
    with testing.fresh_programs():
        yield


def _run(op_type, inputs, attrs, out_names, dtype):
    """The op through both registries' runtime lowerings; -> (jax, port)
    as {param: [float64 ndarray]}."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jins = {k: [jnp.asarray(a, dtype=jdt) for a in v]
            for k, v in inputs.items()}
    j = jax.jit(lambda ins: jreg.run_forward(
        jreg.get_runtime_info(op_type), ins, dict(attrs),
        out_names=out_names))(jins)
    p = preg.run_forward(
        preg.get_runtime_info(op_type),
        {k: [torch.as_tensor(a).to(getattr(torch, dtype)) for a in v]
         for k, v in inputs.items()},
        dict(attrs), out_names=out_names, device=torch.device("cpu"))
    as64 = {
        "jax": lambda a: np.asarray(a.astype(jnp.float32), np.float64),
        "port": lambda a: a.float().numpy().astype(np.float64)}
    return ({k: [as64["jax"](a) for a in v] for k, v in j.items()},
            {k: [as64["port"](a) for a in v] for k, v in p.items()})


def _close(j, p, dtype, what):
    assert sorted(j) == sorted(p), (what, sorted(j), sorted(p))
    for param in j:
        for a, b in zip(j[param], p[param]):
            assert a.shape == b.shape, (what, param, a.shape, b.shape)
            scale = np.abs(a).max()
            if dtype == "float32":
                np.testing.assert_allclose(b, a, rtol=RTOL[dtype],
                                           atol=RTOL[dtype] * scale * 1e-1,
                                           err_msg=f"{what}.{param}")
            else:
                assert np.abs(b - a).max() <= RTOL[dtype] * scale, \
                    (what, param, np.abs(b - a).max(), scale)


def _rnn_inputs(op_type, seed, with_state):
    rng = np.random.RandomState(seed)
    g = GATES[op_type]
    ins = {"X": [rng.standard_normal((B, S, D))],
           "WeightX": [rng.standard_normal((D, g * H)) * 0.4],
           "WeightH": [rng.standard_normal((H, g * H)) * 0.4],
           "Bias": [rng.standard_normal(g * H) * 0.2]}
    if with_state:
        ins["H0"] = [rng.standard_normal((B, H)) * 0.5]
        if op_type == "fused_lstm":
            ins["C0"] = [rng.standard_normal((B, H)) * 0.5]
    return {k: [np.asarray(a, np.float32) for a in v]
            for k, v in ins.items()}


CASES = [(op, rev, st) for op in ("fused_lstm", "fused_gru")
         for rev in (False, True) for st in (False, True)]
IDS = [f"{op[6:]}-{'rev' if rev else 'fwd'}-{'h0' if st else 'zeros'}"
       for op, rev, st in CASES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op_type,reverse,with_state", CASES, ids=IDS)
def test_forward_and_grads_match_jax(op_type, reverse, with_state, dtype):
    ins = _rnn_inputs(op_type, 3 + len(IDS), with_state)
    attrs = {"is_reverse": reverse}
    outs = {p: [p.lower()] for p in OUTS[op_type]}
    j, p = _run(op_type, ins, attrs, outs, dtype)
    _close(j, p, dtype, op_type)
    assert j["Out"][0].shape == (B, S, H)

    # the grad op: forward inputs and outputs, a cotangent on every output
    rng = np.random.RandomState(11)
    grad_in = dict(ins)
    for param in OUTS[op_type]:
        grad_in[param] = [j[param][0].astype(np.float32)]
        grad_in[param + "@GRAD"] = [rng.standard_normal(
            j[param][0].shape).astype(np.float32)]
    grad_out = {f"{k}@GRAD": [f"{k.lower()}@GRAD"] for k in ins}
    jg, pg = _run(op_type + "_grad", grad_in, attrs, grad_out, dtype)
    _close(jg, pg, dtype, op_type + "_grad")
    assert sorted(pg) == sorted(grad_out)


def test_reverse_is_the_flipped_forward():
    """is_reverse runs the sequence from its end and flips Out back: its
    Out equals the forward op's on the flipped input, flipped."""
    ins = _rnn_inputs("fused_gru", 5, False)
    outs = {"Out": ["out"], "LastH": ["h"]}
    _, rev = _run("fused_gru", ins, {"is_reverse": True}, outs, "float32")
    flipped = dict(ins, X=[ins["X"][0][:, ::-1].copy()])
    _, fwd = _run("fused_gru", flipped, {"is_reverse": False}, outs,
                  "float32")
    np.testing.assert_array_equal(rev["Out"][0], fwd["Out"][0][:, ::-1])
    np.testing.assert_array_equal(rev["LastH"][0], fwd["LastH"][0])


REDUCE_CASES = [
    ({"dim": [1], "keep_dim": False, "reduce_all": False}, (2, 3, 4)),
    ({"dim": [0, 2], "keep_dim": True, "reduce_all": False}, (2, 3, 4)),
    ({"dim": [-1], "keep_dim": False, "reduce_all": False}, (2, 3, 4)),
    ({"dim": [0], "keep_dim": False, "reduce_all": True}, (2, 3, 4)),
    ({"dim": [0], "keep_dim": True, "reduce_all": True}, (2, 3)),
    ({"dim": [0], "keep_dim": False, "reduce_all": False}, (5,)),
]


@pytest.mark.parametrize("op_type", ["reduce_sum", "reduce_mean",
                                     "reduce_max", "reduce_min",
                                     "reduce_prod"])
@pytest.mark.parametrize("attrs,shape", REDUCE_CASES,
                         ids=["dim1", "dims02_keep", "dim_last", "all",
                              "all_keep", "to_scalar"])
def test_reduce_family_matches_jax(op_type, attrs, shape):
    """Forward (a 0-d result kept as [1]) and grad within 1e-6."""
    rng = np.random.RandomState(7)
    x = (rng.uniform(0.5, 1.5, shape) * rng.choice([-1, 1], shape)).astype(
        np.float32)
    j, p = _run(op_type, {"X": [x]}, attrs, {"Out": ["out"]}, "float32")
    assert j["Out"][0].shape == p["Out"][0].shape
    np.testing.assert_allclose(p["Out"][0], j["Out"][0], rtol=1e-6)
    g = rng.standard_normal(j["Out"][0].shape).astype(np.float32)
    jg, pg = _run(op_type + "_grad",
                  {"X": [x], "Out": [j["Out"][0].astype(np.float32)],
                   "Out@GRAD": [g]}, attrs, {"X@GRAD": ["x@GRAD"]},
                  "float32")
    np.testing.assert_allclose(pg["X@GRAD"][0], jg["X@GRAD"][0], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("op_type", ["reduce_max", "reduce_min"])
def test_tied_extrema_split_the_cotangent_equally(op_type):
    """Two or three tied extrema in a row: each gets an equal share of the
    row's cotangent, in both packages (a tanh output rounded to bfloat16
    ties this way in stacked_lstm's max over time)."""
    sign = 1.0 if op_type == "reduce_max" else -1.0
    x = sign * np.array([[1.0, 3.0, 3.0, 2.0],
                         [2.0, 2.0, 2.0, -1.0]], np.float32)
    attrs = {"dim": [1], "keep_dim": False, "reduce_all": False}
    g = np.array([1.0, 0.6], np.float32)
    jg, pg = _run(op_type + "_grad",
                  {"X": [x], "Out": [sign * np.array([3.0, 2.0], np.float32)],
                   "Out@GRAD": [g]}, attrs, {"X@GRAD": ["x@GRAD"]},
                  "float32")
    want = np.array([[0.0, 0.5, 0.5, 0.0], [0.2, 0.2, 0.2, 0.0]])
    np.testing.assert_allclose(pg["X@GRAD"][0], want, rtol=1e-6)
    np.testing.assert_allclose(jg["X@GRAD"][0], want, rtol=1e-6)
