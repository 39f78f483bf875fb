"""The port's RNN fusion passes (paddle_tpu_torch/transpiler/
rnn_fuse_passes.py) and its InferenceTranspiler line-up against the JAX
package's.

Each case builds the same unfused inference program in both packages
(the chains of tests/test_rnn_fuse_passes.py and
tests/test_attention_lstm_fuse.py), carries the JAX startup's weights
into the port (`convert.load_params`) and transpiles both: the
transpiled programs are the same dict (op types, attrs, the vars left),
the folded scope values (@rnn_folded_bias, the attention_lstm's
@att_w/@lstm_w/@lstm_b) are within 1e-6 of the JAX fold's, the port's
output is unchanged by the transpile and equal to the JAX package's
transpiled output within 1e-5.  The non-fusing cases (a non-default
activation, a projection read twice, a read BatchGate, a sequence_conv
without relu or with SeqLen, a nonzero forget_bias) stay unfused in
both.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.transpiler import InferenceTranspiler as JTranspiler
from paddle_tpu.transpiler.inference_transpiler import _inference_passes
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.transpiler import INFERENCE_PASSES, InferenceTranspiler

from torch_op_parity import BOTH, build_program, normalized_ints

B, S, D, H, M = 3, 6, 5, 4, 5


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _helper(pkg, name):
    return importlib.import_module(
        pkg.__name__ + ".layer_helper").LayerHelper(name)


def _raw_recurrence(pkg, proj, kind, *, with_bias=True, peepholes=False,
                    attrs=None):
    """A raw (unfused) lstm/gru op on a projected input."""
    helper = _helper(pkg, f"raw_{kind}")
    dtype = proj.dtype
    mult = 4 if kind == "lstm" else 3
    w = helper.create_parameter(attr=None, shape=[H, mult * H], dtype=dtype)
    inputs = {"Input": [proj], "Weight": [w]}
    if with_bias:
        width = 7 * H if peepholes else mult * H
        inputs["Bias"] = [helper.create_parameter(
            attr=None, shape=[width], dtype=dtype, is_bias=True)]
    outs = {"Hidden": [helper.create_variable_for_type_inference(dtype)]}
    if kind == "lstm":
        outs["Cell"] = [helper.create_variable_for_type_inference(dtype)]
    else:
        for k in ("BatchGate", "BatchResetHiddenPrev"):
            outs[k] = [helper.create_variable_for_type_inference(dtype)]
    a = {"use_peepholes": peepholes} if kind == "lstm" else {}
    a.update(attrs or {})
    helper.append_op(type=kind, inputs=inputs, outputs=outs, attrs=a)
    return outs


def _fc(pkg, x, mult, bias=True):
    return pkg.layers.fc(x, size=mult * H, num_flatten_dims=2,
                         bias_attr=None if bias else False)


def _x(pkg):
    return pkg.layers.data("x", shape=[S, D], dtype="float32")


def _lstm(**kw):
    bias = kw.pop("fc_bias", True)
    return lambda pkg: _raw_recurrence(pkg, _fc(pkg, _x(pkg), 4, bias),
                                       "lstm", **kw)["Hidden"][0]


def _gru_read_gate(pkg):
    outs = _raw_recurrence(pkg, _fc(pkg, _x(pkg), 3, False), "gru")
    return pkg.layers.scale(outs["BatchGate"][0], scale=1.0)


def _proj_read_twice(pkg):
    proj = _fc(pkg, _x(pkg), 4, False)
    pkg.layers.scale(proj, scale=2.0)
    return _raw_recurrence(pkg, proj, "lstm")["Hidden"][0]


def _seqconv(act="relu", ragged=False):
    def build(pkg):
        kw = {}
        if ragged:
            kw["seq_len"] = pkg.layers.data("lens", shape=[], dtype="int64")
        return pkg.layers.sequence_conv(_x(pkg), num_filters=7,
                                        filter_size=3, act=act, **kw)
    return build


def _lstm_unit(pkg, gates, c_prev, forget_bias):
    helper = _helper(pkg, "lstm_unit")
    h = helper.create_variable_for_type_inference(gates.dtype)
    c = helper.create_variable_for_type_inference(gates.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [gates], "C_prev": [c_prev]},
                     outputs={"H": [h], "C": [c]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def _attention_lstm(forget_bias=0.0):
    """tests/test_attention_lstm_fuse.py's unfused additive-attention LSTM
    decoder over x [B, S, M]."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", shape=[S, M], dtype="float32")
        helper = _helper(pkg, "att_lstm_unfused")
        aw_x = helper.create_parameter(attr=None, shape=[M, 1],
                                       dtype="float32")
        aw_c = helper.create_parameter(attr=None, shape=[H, 1],
                                       dtype="float32")
        w_lstm = helper.create_parameter(attr=None, shape=[H + M, 4 * H],
                                         dtype="float32")
        b_lstm = helper.create_parameter(attr=None, shape=[4 * H],
                                         dtype="float32", is_bias=True)
        atted_x = L.reshape(L.mul(x, aw_x, x_num_col_dims=2), shape=[-1, S])
        rnn = L.StaticRNN()
        with rnn.step():
            rnn.step_input(x)
            h = rnn.memory(shape=[H], batch_ref=x, init_value=0.0)
            c = rnn.memory(shape=[H], batch_ref=x, init_value=0.0)
            score = L.relu(L.elementwise_add(x=atted_x, y=L.mul(c, aw_c),
                                             axis=0))
            pooled = L.reshape(
                L.matmul(L.reshape(L.softmax(score), shape=[-1, 1, S]), x),
                shape=[-1, M])
            gates = L.elementwise_add(
                x=L.mul(L.concat([h, pooled], axis=1), w_lstm), y=b_lstm,
                axis=1)
            h_new, c_new = _lstm_unit(pkg, gates, c, forget_bias)
            rnn.update_memory(h, h_new)
            rnn.update_memory(c, c_new)
            rnn.step_output(h_new)
        return rnn()
    return build


# id -> (builder, the fused op type or None where nothing may fuse)
CASES = {
    "fc_lstm/both_biases": (_lstm(), "fusion_lstm"),
    "fc_lstm/bare_mul_no_bias": (_lstm(fc_bias=False, with_bias=False),
                                 "fusion_lstm"),
    "fc_lstm/peephole_tail": (_lstm(peepholes=True), "fusion_lstm"),
    "fc_lstm/claimed_peepholes_short_bias": (
        _lstm(attrs={"use_peepholes": True}), "fusion_lstm"),
    "fc_lstm/relu_gate_unfused": (_lstm(attrs={"gate_activation": "relu"}),
                                  None),
    "fc_lstm/projection_read_twice_unfused": (_proj_read_twice, None),
    "fc_gru/folds": (lambda pkg: _raw_recurrence(
        pkg, _fc(pkg, _x(pkg), 3), "gru")["Hidden"][0], "fusion_gru"),
    "fc_gru/batchgate_read_unfused": (_gru_read_gate, None),
    "seqconv/relu": (_seqconv(), "fusion_seqconv_eltadd_relu"),
    "seqconv/no_relu_unfused": (_seqconv(act=None), None),
    "seqconv/ragged_unfused": (_seqconv(ragged=True), None),
    "attention_lstm/fuses": (_attention_lstm(), "attention_lstm"),
    "attention_lstm/forget_bias_unfused": (_attention_lstm(1.0), None),
}

FOLDED = ("@rnn_folded_bias", "@att_w", "@lstm_w", "@lstm_b")


def _feed(build):
    rng = np.random.RandomState(0)
    width = M if build.__qualname__.startswith("_attention_lstm") else D
    return {"x": rng.randn(B, S, width).astype(np.float32),
            "lens": np.array([6, 3, 1], np.int64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transpiled_program_and_outputs_are_the_jax_packages(case):
    build, fused = CASES[case]
    (jm, js, jout), (pm, ps, pout) = (build_program(pkg, g, build, seed=3)
                                      for pkg, g in BOTH)
    assert normalized_ints(pm) == normalized_ints(jm)
    feed = _feed(build)
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    convert.load_params(pscope, {v.name: np.asarray(jscope.find_var(v.name))
                                 for v in js.list_vars() if v.persistable},
                        pt.CPUPlace(), [pm])
    jinfer, pinfer = jm.clone(for_test=True), pm.clone(for_test=True)
    feed = {k: v for k, v in feed.items()
            if pinfer.global_block().has_var(k)}
    before, = pexe.run(pinfer, feed=feed, fetch_list=[pout.name],
                       scope=pscope)
    JTranspiler().transpile(jinfer, scope=jscope)
    InferenceTranspiler().transpile(pinfer, scope=pscope)
    types = [op.type for op in pinfer.global_block().ops]
    assert types == [op.type for op in jinfer.global_block().ops]
    assert normalized_ints(pinfer) == normalized_ints(jinfer)
    if fused is None:
        assert not any(t.startswith(("fusion_", "attention_lstm"))
                       for t in types), types
    else:
        assert fused in types, types
    folded = sorted(n for n in jinfer.global_block().vars
                    if n.endswith(FOLDED))
    assert bool(folded) == (case in ("fc_lstm/both_biases",
                                     "fc_lstm/peephole_tail",
                                     "fc_lstm/claimed_peepholes_short_bias",
                                     "fc_gru/folds",
                                     "attention_lstm/fuses"))
    for name in folded:
        np.testing.assert_allclose(
            pscope.find_var(name).numpy(), np.asarray(jscope.find_var(name)),
            rtol=1e-6, atol=0, err_msg=name)
    want, = jexe.run(jinfer, feed=feed, fetch_list=[jout.name], scope=jscope)
    after, = pexe.run(pinfer, feed=feed, fetch_list=[pout.name],
                      scope=pscope)
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(after, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_the_line_up_is_the_jax_packages():
    assert INFERENCE_PASSES == _inference_passes()


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rnn_fuse_types_are_the_jax_packages():
    """chip_smoke.py's RNN/fuse programs, built by the port at test width
    and read into the JAX package from their dicts: the JAX package's
    InferenceTranspiler leaves the op types chip_smoke.RF_JAX_TYPES
    holds, and so does the port's."""
    cs = _chip_smoke()
    progs = cs.rnn_fuse_programs(t=S, width=8, hidden=H)
    assert sorted(progs) == sorted(cs.RF_JAX_TYPES)
    for name, (main, startup, _) in progs.items():
        pscope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=pscope)
        infer = main.clone(for_test=True)
        jinfer = fluid.Program.from_dict(infer.to_dict())
        jscope = JScope()
        for v in main.list_vars():
            if v.persistable and pscope.find_var(v.name) is not None:
                jscope.set_var(v.name, pscope.find_var(v.name).numpy())
        JTranspiler().transpile(jinfer, scope=jscope)
        InferenceTranspiler().transpile(infer, scope=pscope)
        jtypes = [op.type for op in jinfer.global_block().ops]
        assert jtypes == cs.RF_JAX_TYPES[name], (name, jtypes)
        assert [op.type for op in infer.global_block().ops] == jtypes
