"""The sequence losses of the port (paddle_tpu_torch/ops/
sequence_loss_ops.py: linear_chain_crf, crf_decoding, warpctc,
edit_distance, nce, hierarchical_sigmoid) and their builders against
the JAX package's, on the CPU at tiny sizes.

  * forward within 1e-5 of the JAX lowering (integer outputs equal);
  * grads through `append_backward` and both Executors within rtol 1e-4
    / atol 1e-5 of the JAX program's, and within the same of float64
    central differences of the numpy references of
    tests/test_sequence_losses.py (brute-force CRF and CTC likelihoods,
    the hsigmoid path walk; the JAX package's own `check_grad` cannot run
    here, ROADMAP C1);
  * an emission above exp's float32 range (88.7) leaves the CRF grads
    finite; a warpctc row whose label cannot fit its logits gives the JAX
    package's finite value; norm_by_times scales only the grad;
    crf_decoding with Label; ties go to the first tag;
    edit_distance normalised and not; hsigmoid at 2^15 + 1 classes, with
    a code of 2^16;
  * nce given the JAX run's samples (`testing.nce_given_samples`) prices
    them as the JAX package does, and its own draws have the sampler's
    class frequencies within 5 standard errors;
  * the six builders emit the JAX package's programs, and from the JAX
    startup's weights give its values.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework.scope import Scope as JScope
import paddle_tpu_torch as pt
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import registry as preg

import test_sequence_losses as ref
from torch_op_parity import (
    assert_forward,
    assert_op_and_grads,
    assert_steps_close,
    build_program,
    normalized_ints,
    run_both,
    run_programs_both,
    BOTH,
)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _central(f, x, eps=1e-6):
    """float64 central differences of scalar f at x."""
    x = x.astype(np.float64)
    g = np.zeros_like(x)
    for i in np.ndindex(x.shape):
        hi, lo = x.copy(), x.copy()
        hi[i] += eps
        lo[i] -= eps
        g[i] = (f(hi) - f(lo)) / (2 * eps)
    return g


def _port_grads(op_type, inputs, attrs, diff, out):
    """The port's grads of sum(out) through append_backward (cotangent 1)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        block = main.global_block()
        ivars = {p: [block.create_var(name=f"{p}_{i}", shape=list(a.shape),
                                      dtype=str(a.dtype),
                                      stop_gradient=p not in diff)
                     for i, a in enumerate(arrs)]
                 for p, arrs in inputs.items()}
        o = block.create_var(name="out", dtype="float32")
        block.append_op(type=op_type, inputs=ivars, outputs={out: [o]},
                        attrs=dict(attrs))
        pt.append_backward(pt.layers.reduce_sum(o))
    feed = {f"{p}_0": arrs[0] for p, arrs in inputs.items()}
    got = pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=[f"{p}_0@GRAD" for p in diff],
        scope=pt.Scope())
    return dict(zip(diff, got))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                               err_msg=what)


# --------------------------------------------------------- linear_chain_crf

def _crf_inputs(rng, b=3, t=4, d=3, lens=(4, 2, 0), scale=0.5):
    return {
        "Emission": [rng.uniform(-scale, scale, (b, t, d)).astype(np.float32)],
        "Transition": [rng.uniform(-0.3, 0.3, (d + 2, d)).astype(np.float32)],
        "Label": [rng.randint(0, d, (b, t)).astype(np.int64)],
        "SeqLen": [np.array(lens, np.int64)],
    }


CRF_OUTS = {"Alpha": 1, "EmissionExps": 1, "TransitionExps": 1}


def test_linear_chain_crf_forward_and_grads_match_jax():
    got = assert_op_and_grads(
        "linear_chain_crf", _crf_inputs(np.random.RandomState(0)), {},
        ["Emission", "Transition"], {"LogLikelihood": 1}, CRF_OUTS)
    assert got["out_LogLikelihood_0"][2, 0] == 0.0     # a row of length 0


def test_linear_chain_crf_grads_match_central_differences():
    inputs = _crf_inputs(np.random.RandomState(1), lens=(4, 2, 3))
    em, tr = inputs["Emission"][0], inputs["Transition"][0]
    lab, lens = inputs["Label"][0], inputs["SeqLen"][0]

    def nll(e, w):
        return sum(ref.crf_nll_bruteforce(e[i], w, lab[i], int(lens[i]))
                   for i in range(len(lens)))

    got = _port_grads("linear_chain_crf", inputs, {},
                      ["Emission", "Transition"], "LogLikelihood")
    _close(got["Emission"], _central(lambda e: nll(e, tr), em), "Emission")
    _close(got["Transition"], _central(lambda w: nll(em, w), tr),
           "Transition")


def test_linear_chain_crf_large_emission_keeps_grads_finite():
    """exp(100) overflows float32: the detached EmissionExps keep the
    generic grad free of 0 * inf."""
    inputs = _crf_inputs(np.random.RandomState(2))
    inputs["Emission"][0][0, 1, 2] = 100.0
    got = assert_op_and_grads("linear_chain_crf", inputs, {},
                              ["Emission", "Transition"],
                              {"LogLikelihood": 1}, CRF_OUTS)
    assert np.isinf(got["out_EmissionExps_0"]).any()
    for name in ("Emission_0@GRAD", "Transition_0@GRAD"):
        assert np.isfinite(got[name]).all(), name


# ------------------------------------------------------------- crf_decoding

def _decode_inputs(rng, with_label):
    b, t, d = 4, 5, 3
    inputs = {
        "Emission": [rng.uniform(-1, 1, (b, t, d)).astype(np.float32)],
        "Transition": [rng.uniform(-0.5, 0.5, (d + 2, d)).astype(np.float32)],
        "SeqLen": [np.array([5, 2, 0, 3], np.int64)],
    }
    if with_label:
        inputs["Label"] = [rng.randint(0, d, (b, t)).astype(np.int64)]
    return inputs


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_matches_jax(with_label):
    j, p = assert_forward("crf_decoding",
                          _decode_inputs(np.random.RandomState(3), with_label),
                          {})
    path = p["ViterbiPath"][0]
    assert path.dtype == np.int64 and (path[2] == 0).all()


def test_crf_decoding_ties_go_to_the_first_tag():
    inputs = {"Emission": [np.zeros((2, 4, 3), np.float32)],
              "Transition": [np.zeros((5, 3), np.float32)],
              "SeqLen": [np.array([4, 3], np.int64)]}
    _, p = assert_forward("crf_decoding", inputs, {})
    assert (p["ViterbiPath"][0] == 0).all()


# ------------------------------------------------------------------ warpctc

def _ctc_inputs(rng, logit_lens, label_lens, b=3, t=5, c1=4, s=3):
    return {
        "Logits": [rng.uniform(-1, 1, (b, t, c1)).astype(np.float32)],
        "Label": [rng.randint(1, c1, (b, s)).astype(np.int64)],
        "LogitsLength": [np.array(logit_lens, np.int64)],
        "LabelLength": [np.array(label_lens, np.int64)],
    }


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_warpctc_forward_and_grads_match_jax(norm_by_times):
    inputs = _ctc_inputs(np.random.RandomState(4), [5, 4, 3], [3, 1, 2])
    assert_op_and_grads("warpctc", inputs,
                        {"blank": 0, "norm_by_times": norm_by_times},
                        ["Logits"], {"Loss": 1})


def test_warpctc_infeasible_row_gives_the_jax_value():
    """Row 2's three labels cannot fit its two logits: optax's log(0)
    floor of -1e5 gives a finite loss near 1e5, the port's too.  Only the
    value is compared: at 1e5 a float32 carries ~0.008, and that row's
    grads are rounding noise in both packages (they part by ~1e-3)."""
    inputs = _ctc_inputs(np.random.RandomState(4), [5, 4, 2], [3, 1, 3])
    j, p = run_both("warpctc", inputs, {"blank": 0})
    loss = p["Loss"][0][:, 0]
    np.testing.assert_allclose(loss, j["Loss"][0][:, 0], rtol=1e-6)
    assert np.isfinite(loss).all() and loss[2] > 1e4


def test_warpctc_norm_by_times_scales_only_the_grad():
    """The port alone (its norm_by_times forward and grad are held to the
    JAX package's above): the loss unchanged, the grad divided by each
    row's length."""
    import torch

    inputs = _ctc_inputs(np.random.RandomState(5), [5, 4, 3], [2, 1, 2])
    attrs = {"blank": 0}
    loss = {}
    for norm in (False, True):
        out = preg.run_forward(
            preg.get_op_info("warpctc"),
            {p: [torch.as_tensor(a[0])] for p, a in inputs.items()},
            dict(attrs, norm_by_times=norm))
        loss[norm] = out["Loss"][0].numpy()
    np.testing.assert_allclose(loss[True], loss[False], rtol=1e-6)
    g = _port_grads("warpctc", inputs, dict(attrs, norm_by_times=False),
                    ["Logits"], "Loss")["Logits"]
    gn = _port_grads("warpctc", inputs, dict(attrs, norm_by_times=True),
                     ["Logits"], "Loss")["Logits"]
    lens = inputs["LogitsLength"][0].astype(np.float32)
    np.testing.assert_allclose(gn, g / lens[:, None, None], rtol=1e-6,
                               atol=1e-8)


def test_warpctc_grads_match_central_differences():
    rng = np.random.RandomState(6)
    inputs = _ctc_inputs(rng, [4, 3], [2, 1], b=2, t=4, c1=3, s=2)
    logits, label = inputs["Logits"][0], inputs["Label"][0]
    tl, ll = inputs["LogitsLength"][0], inputs["LabelLength"][0]

    def nll(x):
        return sum(ref.ctc_nll_bruteforce(x[i, :tl[i]], label[i, :ll[i]])
                   for i in range(2))

    got = _port_grads("warpctc", inputs, {"blank": 0}, ["Logits"], "Loss")
    _close(got["Logits"], _central(nll, logits), "Logits")


# ------------------------------------------------------------ edit_distance

@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_matches_jax_and_levenshtein(normalized):
    rng = np.random.RandomState(7)
    hyp = rng.randint(0, 4, (4, 6)).astype(np.int64)
    refs = rng.randint(0, 4, (4, 5)).astype(np.int64)
    hl = np.array([6, 3, 0, 5], np.int64)
    rl = np.array([5, 4, 2, 0], np.int64)
    _, p = assert_forward("edit_distance",
                          {"Hyps": [hyp], "Refs": [refs], "HypsLength": [hl],
                           "RefsLength": [rl]}, {"normalized": normalized})
    for i in range(4):
        want = ref.levenshtein(hyp[i, :hl[i]], refs[i, :rl[i]])
        if normalized:
            want /= max(rl[i], 1)
        assert abs(p["Out"][0][i, 0] - want) < 1e-6, (i, want)
    assert p["SequenceNum"][0].dtype == np.int64
    assert p["SequenceNum"][0].tolist() == [4]


# ---------------------------------------------------------------------- nce

def _nce_inputs(rng, b=4, dim=3, c=10):
    return {
        "Input": [rng.randn(b, dim).astype(np.float32)],
        "Label": [rng.randint(0, c, (b, 1)).astype(np.int64)],
        "Weight": [(rng.randn(c, dim) * 0.3).astype(np.float32)],
        "Bias": [(rng.randn(c) * 0.1).astype(np.float32)],
        "SampleWeight": [rng.uniform(0.5, 1.5, (b,)).astype(np.float32)],
    }


def _nce_program(pkg, inputs, attrs):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 31
    with pkg.program_guard(main, startup):
        block = main.global_block()
        ivars = {p: [block.create_var(name=p, shape=list(a[0].shape),
                                      dtype=str(a[0].dtype),
                                      stop_gradient=p not in (
                                          "Input", "Weight", "Bias"))]
                 for p, a in inputs.items()}
        outs = {k: [block.create_var(name=k, dtype=dt)]
                for k, dt in (("Cost", "float32"), ("SampleLogits",
                                                    "float32"),
                              ("SampleLabels", "int64"))}
        block.append_op(type="nce", inputs=ivars, outputs=outs,
                        attrs=dict(attrs))
        pkg.append_backward(pkg.layers.reduce_sum(outs["Cost"][0]))
    return main


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_prices_the_jax_samples_as_jax(sampler, monkeypatch):
    inputs = _nce_inputs(np.random.RandomState(8))
    attrs = {"num_total_classes": 10, "num_neg_samples": 5,
             "sampler": sampler}
    feed = {p: a[0] for p, a in inputs.items()}
    fetch = ["Cost", "SampleLogits", "SampleLabels", "Input@GRAD",
             "Weight@GRAD", "Bias@GRAD"]
    want = [np.asarray(a) for a in fluid.Executor(fluid.CPUPlace()).run(
        _nce_program(fluid, inputs, attrs), feed=feed, fetch_list=fetch,
        scope=JScope())]
    monkeypatch.setattr(preg.OPS["nce"], "forward",
                        testing.nce_given_samples(want[2]))
    got = pt.Executor(pt.CPUPlace()).run(
        _nce_program(pt, inputs, attrs), feed=feed, fetch_list=fetch,
        scope=pt.Scope())
    np.testing.assert_array_equal(got[2], want[2])
    for name, g, w in zip(fetch, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_draws_have_the_sampler_frequencies(sampler):
    """20,000 negatives: each class's frequency within 5 standard errors
    of q(c), and the label column is the label."""
    rng = np.random.RandomState(9)
    b, s, c = 2000, 10, 10
    inputs = _nce_inputs(rng, b=b, c=c)
    attrs = {"num_total_classes": c, "num_neg_samples": s,
             "sampler": sampler}
    main = _nce_program(pt, inputs, attrs)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    feed = {p: a[0] for p, a in inputs.items()}
    first, = exe.run(main, feed=feed, fetch_list=["SampleLabels"],
                     scope=scope)
    again, = exe.run(main, feed=feed, fetch_list=["SampleLabels"],
                     scope=scope)
    assert (first[:, 0] == inputs["Label"][0][:, 0]).all()
    assert not np.array_equal(first, again)       # a fresh draw a run
    neg = first[:, 1:].reshape(-1)
    cc = np.arange(c)
    q = ((np.log(cc + 2) - np.log(cc + 1)) / np.log(c + 1)
         if sampler == "log_uniform" else np.full(c, 1.0 / c))
    freq = np.bincount(neg, minlength=c) / neg.size
    se = np.sqrt(q * (1 - q) / neg.size)
    assert (np.abs(freq - q) < 5 * se).all(), (freq, q)


def test_c23_log_uniform_q_is_correctly_rounded():
    """ROADMAP C23: at conll05's 44,068 words the JAX package's float32
    log(c + 2) - log(c + 1) keeps a few bits of q(c) for large c; the
    port takes it in float64 and rounds once."""
    import torch
    from paddle_tpu.ops import sequence_loss_ops as jsl
    from paddle_tpu_torch.ops import sequence_loss_ops as psl

    c = 44068
    cc = np.arange(c, dtype=np.float64)
    exact = ((np.log(cc + 2) - np.log(cc + 1)) / np.log(c + 1.0))
    port = psl._sampler_probs("log_uniform", c, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(port, exact.astype(np.float32))
    jax_q = np.asarray(jsl._sampler_probs("log_uniform", c))
    assert np.max(np.abs(jax_q / exact - 1)) > 1e-2
    np.testing.assert_allclose(jax_q[:10], port[:10], rtol=1e-5)


# ----------------------------------------------------- hierarchical_sigmoid

def _hs_inputs(rng, c, b=4, dim=3, labels=None):
    return {
        "X": [rng.uniform(-1, 1, (b, dim)).astype(np.float32)],
        "W": [rng.uniform(-1, 1, (c - 1, dim)).astype(np.float32)],
        "Bias": [rng.uniform(-1, 1, (c - 1,)).astype(np.float32)],
        "Label": [np.asarray(labels, np.int64).reshape(b, 1)
                  if labels is not None
                  else rng.randint(0, c, (b, 1)).astype(np.int64)],
    }


@pytest.mark.parametrize("num_classes,labels", [
    (6, None), (2 ** 15 + 1, [2 ** 15 - 1, 0, 2 ** 15, 12345])])
def test_hsigmoid_forward_and_grads_match_jax(num_classes, labels):
    """At 2^15 + 1 classes label 2^15 - 1 has the code 2^16: its path has
    16 levels, the root's included."""
    inputs = _hs_inputs(np.random.RandomState(10), num_classes,
                        labels=labels)
    assert_op_and_grads("hierarchical_sigmoid", inputs,
                        {"num_classes": num_classes}, ["X", "W", "Bias"],
                        {"Out": 1}, {"PreOut": 1})
    if labels is not None:
        _, p = assert_forward("hierarchical_sigmoid", inputs,
                              {"num_classes": num_classes})
        assert np.count_nonzero(p["PreOut"][0][0]) == 16


def test_hsigmoid_grads_match_central_differences():
    c = 6
    inputs = _hs_inputs(np.random.RandomState(11), c)
    x, w, bias = (inputs[k][0] for k in ("X", "W", "Bias"))
    lab = inputs["Label"][0][:, 0]

    def out(xx, ww, bb):      # float64 throughout (NEP 50)
        return ref.hsigmoid_reference(
            xx.astype(np.float64), ww.astype(np.float64),
            bb.astype(np.float64), lab, c).sum()

    got = _port_grads("hierarchical_sigmoid", inputs, {"num_classes": c},
                      ["X", "W", "Bias"], "Out")
    _close(got["X"], _central(lambda v: out(v, w, bias), x), "X")
    _close(got["W"], _central(lambda v: out(x, v, bias), w), "W")
    _close(got["Bias"], _central(lambda v: out(x, w, v), bias), "Bias")


# ----------------------------------------------------------------- builders

B, T, D = 3, 5, 4


def _crf_builder(pkg):
    L = pkg.layers
    emission = L.fc(L.data("x", shape=[T, 6], dtype="float32"), size=D,
                    num_flatten_dims=2)
    label = L.data("y", shape=[T], dtype="int64")
    lens = L.data("lens", shape=[], dtype="int64")
    cost = L.linear_chain_crf(emission, label,
                              param_attr=pkg.ParamAttr(name="crfw"),
                              seq_len=lens)
    path = L.crf_decoding(emission, "crfw", seq_len=lens)
    right = L.crf_decoding(emission, pkg.ParamAttr(name="crfw"),
                           label=label, seq_len=lens)
    return [cost, path, right]


def _ctc_builder(pkg):
    L = pkg.layers
    logits = L.fc(L.data("x", shape=[T, 6], dtype="float32"), size=D,
                  num_flatten_dims=2)
    return [L.warpctc(logits, L.data("lab", shape=[2], dtype="int64"),
                      norm_by_times=True,
                      input_length=L.data("lens", shape=[], dtype="int64"),
                      label_length=L.data("lab_lens", shape=[],
                                          dtype="int64"))]


def _edit_builder(pkg):
    L = pkg.layers
    return list(L.edit_distance(
        L.data("hyp", shape=[T], dtype="int64"),
        L.data("lab", shape=[2], dtype="int64"), normalized=True,
        input_length=L.data("lens", shape=[], dtype="int64"),
        label_length=L.data("lab_lens", shape=[], dtype="int64")))


def _hs_builder(pkg):
    L = pkg.layers
    return [L.hsigmoid(L.data("v", shape=[6], dtype="float32"),
                       L.data("cls", shape=[1], dtype="int64"),
                       num_classes=9)]


BUILDERS = {"crf": _crf_builder, "warpctc": _ctc_builder,
            "edit_distance": _edit_builder, "hsigmoid": _hs_builder}


def _builder_feed():
    rng = np.random.RandomState(12)
    return {"x": rng.randn(B, T, 6).astype(np.float32),
            "y": rng.randint(0, D, (B, T)).astype(np.int64),
            "lens": np.array([5, 3, 1], np.int64),
            "lab": rng.randint(1, D, (B, 2)).astype(np.int64),
            "lab_lens": np.array([2, 1, 1], np.int64),
            "hyp": rng.randint(0, D, (B, T)).astype(np.int64),
            "v": rng.randn(B, 6).astype(np.float32),
            "cls": rng.randint(0, 9, (B, 1)).astype(np.int64)}


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_builder_emits_the_jax_program_and_values(case):
    want, got = run_programs_both(BUILDERS[case], _builder_feed(),
                                  lambda outs: outs)
    assert_steps_close(got, want, atol=1e-5, rtol=1e-5)


def test_nce_builder_emits_the_jax_program_and_prices_its_samples(
        monkeypatch):
    """The same program; from the JAX startup's weights the port, given
    the JAX run's samples, gives its cost."""
    from paddle_tpu_torch import convert

    def build(pkg):
        L = pkg.layers
        v = L.data("v", shape=[6], dtype="float32")
        return L.nce(v, L.data("cls", shape=[1], dtype="int64"),
                     num_total_classes=9, num_neg_samples=4,
                     sampler="log_uniform")

    (jm, js, jcost), (pm, ps, pcost) = (build_program(pkg, g, build)
                                        for pkg, g in BOTH)
    assert normalized_ints(pm) == normalized_ints(jm)
    assert normalized_ints(ps) == normalized_ints(js)
    samples = next(op for op in jm.global_block().ops
                   if op.type == "nce").output("SampleLabels")[0]
    feed = {k: v for k, v in _builder_feed().items() if k in ("v", "cls")}
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    want = [np.asarray(a) for a in jexe.run(
        jm, feed=feed, fetch_list=[jcost, samples], scope=jscope)]
    pscope = pt.Scope()
    convert.load_params(pscope, {v.name: np.asarray(jscope.find_var(v.name))
                                 for v in js.list_vars() if v.persistable},
                        pt.CPUPlace(), [pm])
    monkeypatch.setattr(preg.OPS["nce"], "forward",
                        testing.nce_given_samples(want[1]))
    got = pt.Executor(pt.CPUPlace()).run(pm, feed=feed,
                                         fetch_list=[pcost, samples],
                                         scope=pscope)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[0], want[0], "Cost")
