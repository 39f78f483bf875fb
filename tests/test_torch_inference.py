"""The inference transpiler (paddle_tpu_torch/transpiler/, framework/ir.py)
and the Predictor (paddle_tpu_torch/inference/) against the JAX package's.

Each of the four passes (conv_bn_fuse, conv_relu_fuse, fc_fuse,
dropout_strip), and the whole line-up, leaves the program dict the JAX
pass leaves on the same built program (cifar ResNet-8, VGG-16 at 32x32,
AlexNet at 64x64: their test clones), and the folded filters and biases
agree with the JAX fold's (numpy, float32) at rtol 1e-6, and bit for bit
(the same float32 operations in the same order, each correctly rounded).  The port's
line-up is the JAX package's, its RNN fusions included (their own
parity tests are tests/test_torch_rnn_fuse_passes.py); those fusions
rewrite nothing on the port's image models.  The port's Predictor on a directory the JAX
package saved gives the JAX Predictor's outputs (rtol 1e-5 of the largest
output; the float32 products of a CPU run), clones run from 4 threads give
the sequential run's outputs (the JAX test's rtol 1e-6, atol 1e-7), and
`Predictor.generate` gives the JAX Predictor's tokens and a port
Generator's over the saving scope, with one Generator cached per spec.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import decode as jdecode
from paddle_tpu import inference as jinference
from paddle_tpu.framework import ir as jir
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.transpiler import InferenceTranspiler as JTranspiler
from paddle_tpu.transpiler.inference_transpiler import (
    INFERENCE_PASSES as JPASSES)
from paddle_tpu.transpiler.rnn_fuse_passes import RNN_FUSE_PASSES
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, inference, testing
from paddle_tpu_torch.framework import ir as pir
from paddle_tpu_torch.transpiler import INFERENCE_PASSES
from port_models import BUILDERS

PASSES = ("conv_bn_fuse", "conv_relu_fuse", "fc_fuse", "dropout_strip")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _image_model(pkg, name):
    """(test program, startup, prediction) of `name` built by `pkg`."""
    import importlib

    def model(sub):
        return importlib.import_module(f"{pkg.__name__}.models.{sub}")

    build = {
        "resnet": lambda: model("resnet").build(dataset="cifar10", depth=8),
        "vgg16": lambda: model("vgg").build(image_shape=(3, 32, 32),
                                            class_dim=10, depth=16),
        "alexnet": lambda: model("alexnet").build(image_shape=(3, 64, 64),
                                                  class_dim=10),
    }[name]
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    guard = jun.guard if pkg is fluid else pt.unique_name.guard
    with pkg.program_guard(main, startup), guard():
        _, prediction, _ = build()
    return main.clone(for_test=True), startup, prediction


@pytest.fixture(scope="module")
def image_models():
    """Per model, the JAX startup's persistables (the port carries them),
    with every batch norm's scale, bias, running mean and variance moved
    off their initial 1, 0, 0, 1 (seeded), so that the fold computes
    something."""
    out = {}
    rs = np.random.RandomState(4)
    with testing.fresh_programs():
        for name in ("resnet", "vgg16", "alexnet"):
            jtest, jstartup, _ = _image_model(fluid, name)
            jscope = JScope()
            fluid.Executor(fluid.CPUPlace()).run(jstartup, scope=jscope)
            out[name] = weights = {
                v.name: np.asarray(jscope.find_var(v.name))
                for v in jtest.list_vars()
                if v.persistable and jscope.find_var(v.name) is not None}
            for op in jtest.global_block().ops:
                if op.type != "batch_norm":
                    continue
                for slot in ("Scale", "Bias", "Mean", "Variance"):
                    n = op.input(slot)[0]
                    w = weights[n] * rs.uniform(0.5, 1.5, weights[n].shape)
                    if slot in ("Bias", "Mean"):
                        w = w + rs.uniform(-0.5, 0.5, w.shape)
                    weights[n] = w.astype(np.float32)
    return out


def _normalized(d):
    """Integer var dtypes as one kind (the JAX package narrows int64 to
    int32 with x64 off)."""
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _both(name, weights):
    jtest, _, jpred = _image_model(fluid, name)
    ptest, _, ppred = _image_model(pt, name)
    jscope = JScope()
    for n, v in weights.items():
        jscope.set_var(n, jnp.asarray(v))
    pscope = pt.Scope()
    for n, v in weights.items():
        pscope.set_var(n, torch.as_tensor(v))
    return (jtest, jscope, jpred), (ptest, pscope, ppred)


@pytest.mark.parametrize("passes", list(PASSES) + ["all"])
@pytest.mark.parametrize("name", ["resnet", "vgg16", "alexnet"])
def test_passes_leave_the_jax_program_and_weights(image_models, name,
                                                  passes):
    weights = image_models[name]
    (jtest, jscope, _), (ptest, pscope, _) = _both(name, weights)
    assert _normalized(ptest.to_dict()) == _normalized(jtest.to_dict())
    if passes == "all":
        JTranspiler().transpile(jtest, scope=jscope)
        pt.transpiler.InferenceTranspiler().transpile(ptest, scope=pscope)
    else:
        jir.apply_passes(jtest, [passes], scope=jscope)
        pir.apply_passes(ptest, [passes], scope=pscope)
    jd, pd = _normalized(jtest.to_dict()), _normalized(ptest.to_dict())
    assert [o["type"] for o in pd["blocks"][0]["ops"]] == \
        [o["type"] for o in jd["blocks"][0]["ops"]]
    assert pd == jd
    folded = [v for v in ptest.list_vars()
              if v.name.endswith("@bn_folded_bias")]
    if name == "resnet" and passes in ("conv_bn_fuse", "all"):
        assert folded   # cifar ResNet's convs carry no bias: each folds
    for v in folded:
        w_name = v.name[:-len("@bn_folded_bias")]
        for n in (w_name, v.name):
            got, want = pscope.find_var(n).numpy(), np.asarray(
                jscope.find_var(n))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            assert got.tobytes() == want.tobytes(), n


def test_transpiled_forward_matches_untranspiled(image_models):
    """The point of the passes: the transpiled cifar ResNet computes what
    the test program computes (the fold reassociates float32 products)."""
    weights = image_models["resnet"]
    _, (ptest, pscope, ppred) = _both("resnet", weights)
    ptest = ptest._prune([ppred])
    feed = {"img": np.random.RandomState(2).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)}
    exe = pt.Executor(pt.CPUPlace())
    (before,) = exe.run(ptest, feed=feed, fetch_list=[ppred], scope=pscope)
    pt.transpiler.InferenceTranspiler().transpile(ptest, scope=pscope)
    assert not any(op.type == "batch_norm" for op in ptest.global_block().ops)
    (after,) = exe.run(ptest, feed=feed, fetch_list=[ppred], scope=pscope)
    np.testing.assert_allclose(after, before, rtol=1e-4, atol=1e-6)


def test_unknown_pass_names_raise_before_any_rewrite(image_models):
    (jtest, jscope, _), (ptest, pscope, _) = _both("resnet",
                                                   image_models["resnet"])
    before = ptest.to_dict()
    for mod, prog, scope in ((jir, jtest, jscope), (pir, ptest, pscope)):
        with pytest.raises(ValueError, match=r"unknown pass name\(s\) "
                           r"\['nope'\]"):
            mod.apply_passes(prog, ["conv_bn_fuse", "nope"], scope=scope)
        with pytest.raises(KeyError, match="has not been registered"):
            mod.get_pass("nope")
    assert ptest.to_dict() == before


def test_line_up_is_the_jax_line_up_without_the_rnn_fusions():
    """Since the RNN fusions were ported, the line-up is the JAX one
    whole: the RNN passes sit between fc_fuse and dropout_strip."""
    assert INFERENCE_PASSES == list(JPASSES)
    assert INFERENCE_PASSES[3:-1] == RNN_FUSE_PASSES


@pytest.mark.parametrize("model", sorted(BUILDERS))
def test_jax_rnn_fusions_rewrite_nothing_on_port_models(model):
    """The JAX line-up's RNN passes over each port model's test program
    (read into the JAX package from its dict): nothing matches."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        BUILDERS[model]()
    d = main.clone(for_test=True).to_dict()
    prog = fluid.Program.from_dict(d)
    jir.apply_passes(prog, RNN_FUSE_PASSES, scope=JScope())
    assert prog.to_dict() == d


# ---------------------------------------------------------------------------
# the Predictor
# ---------------------------------------------------------------------------


def _save_jax_resnet(tmp_path):
    """cifar ResNet-8's prediction saved by the JAX package (batch norms
    in it: each Predictor transpiles on load)."""
    jtest, jstartup, jpred = _image_model(fluid, "resnet")
    d = str(tmp_path / "resnet")
    with jscope_guard(JScope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(jstartup)
        fluid.io.save_inference_model(d, ["img"], [jpred], exe,
                                      main_program=jtest)
    return d


def test_predictor_run_matches_jax_predictor(tmp_path):
    d = _save_jax_resnet(tmp_path)
    feed = {"img": np.random.RandomState(3).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)}
    pred = inference.create_predictor(inference.Config(
        d, place=pt.CPUPlace()))
    assert pred.feed_names == ["img"] and pred.quantized is False
    assert not any(op.type == "batch_norm"
                   for op in pred._program.global_block().ops)
    (got,) = pred.run(feed)
    (want,) = jinference.create_predictor(jinference.Config(d)).run(feed)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # without the transpiler the port runs the batch norms themselves
    (plain,) = inference.create_predictor(inference.Config(
        d, use_transpiler=False, place=pt.CPUPlace())).run(feed)
    assert np.abs(plain - want).max() <= 1e-5 * np.abs(want).max()


def test_predictor_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    d = _save_jax_resnet(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.create_predictor(inference.Config(d))


def _save_float_model(tmp_path):
    """The JAX concurrency test's float model (tests/test_inference.py),
    saved by the port."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data(name="x", shape=[6], dtype="float32")
        h = pt.layers.fc(input=x, size=8, act="relu", param_attr="pw0")
        out = pt.layers.fc(input=h, size=3, act="softmax", param_attr="pw1")
    d = str(tmp_path / "float_model")
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        pt.io.save_inference_model(d, ["x"], [out], exe, main_program=main)
    return d


def test_clones_in_threads_match_the_sequential_run(tmp_path):
    """4 threads x 3 runs over clone()d predictors (a short switch
    interval, so the threads interleave inside run()): every output
    equals the sequential run's (the JAX test's rtol 1e-6, atol 1e-7)."""
    n_threads, runs = 4, 3
    rng = np.random.RandomState(7)
    feeds = [{"x": rng.rand(4, 6).astype(np.float32)}
             for _ in range(n_threads * runs)]
    base = inference.create_predictor(inference.Config(
        _save_float_model(tmp_path), place=pt.CPUPlace()))
    sequential = [base.run(f)[0] for f in feeds]
    predictors = [base.clone() for _ in range(n_threads)]
    results, errors = [None] * len(feeds), []

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
    # the clones share the weights, not copies of them
    for n in ("pw0", "pw1"):
        assert all(p._scope.find_var(n) is base._scope.find_var(n)
                   for p in predictors)


def test_quantized_model_raises_naming_the_int8_tier(tmp_path):
    """An int8 model saved by the JAX package (the JAX test's
    QuantizeTranspiler flow) is served: the port's Predictor loads it as
    quantized, with its int8 weights and float32 sidecars, skips the
    transpiler, and gives the JAX Predictor's outputs (rtol 1e-6; XLA's
    jit rounds the fused dequant an ulp away).  (The name is from when
    the int8 tier was a later slice and the load raised.)"""
    from paddle_tpu.contrib import QuantizeTranspiler

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), jun.guard():
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu", param_attr="qw0")
        out = fluid.layers.fc(input=h, size=3, act="softmax",
                              param_attr="qw1")
    qt = QuantizeTranspiler()
    qt.training_transpile(main, startup)
    infer = main.clone(for_test=True)
    d = str(tmp_path / "int8_model")
    with jscope_guard(JScope()):
        from paddle_tpu.framework.scope import global_scope

        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        frozen = qt.freeze_int8(infer, global_scope(), as_int8=True)
        qt.convert_to_int8(frozen, global_scope())
        fluid.io.save_inference_model(
            d, ["x"], [frozen.global_block().var(out.name)], exe,
            main_program=frozen)
    pred = inference.create_predictor(inference.Config(d,
                                                       place=pt.CPUPlace()))
    jpred = jinference.create_predictor(jinference.Config(d))
    assert pred.quantized and jpred.quantized
    assert pred._scope.find_var("qw0").dtype == torch.int8
    assert pred._scope.find_var("qw0@int8_scale").dtype == torch.float32
    assert {op.type for op in pred._program.global_block().ops} >= {
        "quantized_matmul", "fake_quantize_abs_max"}
    feed = {"x": np.random.RandomState(6).randn(5, 6).astype(np.float32)}
    got = pred.run(feed)[0]
    np.testing.assert_allclose(got, np.asarray(jpred.run(feed)[0]),
                               rtol=1e-6, atol=1e-7)
    assert pred.clone().quantized


def test_predictor_generate_matches_jax_and_the_saving_scope(tmp_path):
    """tests/test_decode.py:226-265's world (a 1-layer tiny transformer,
    src 8, prefix 2, a 12-slot cache) with the JAX startup's weights x3
    (so that greedy tokens do not collapse): the port saves the model,
    its Predictor loads it and generates; the tokens equal the JAX
    Predictor's on the JAX package's save, and a port Generator's over the
    saving scope.  One Generator is cached per spec."""
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch import decode as pdecode
    from paddle_tpu_torch.models import transformer as PT

    def cfg_of(T):
        cfg = T.tiny(vocab=30, max_length=8)
        cfg.n_layer = 1
        return cfg

    jmain, jstartup = fluid.Program(), fluid.Program()
    with fluid.program_guard(jmain, jstartup), jun.guard():
        _, jlogits = JT.build(cfg_of(JT), seq_len=8, use_src_lens=True)
    pmain, pstartup = pt.Program(), pt.Program()
    with pt.program_guard(pmain, pstartup), pt.unique_name.guard():
        _, plogits = PT.build(cfg_of(PT), seq_len=8, use_src_lens=True)
    jscope = JScope()
    fluid.Executor(fluid.CPUPlace()).run(jstartup, scope=jscope)
    weights = {v.name: np.asarray(jscope.find_var(v.name)) * 3
               for v in jmain.list_vars()
               if v.persistable and jscope.find_var(v.name) is not None
               and np.asarray(jscope.find_var(v.name)).dtype == np.float32}
    for n, w in weights.items():
        jscope.set_var(n, jnp.asarray(w))
    feeds = ["src_ids", "trg_ids", "src_lens"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jscope_guard(jscope):
        fluid.io.save_inference_model(jdir, feeds, [jlogits],
                                      fluid.Executor(fluid.CPUPlace()),
                                      main_program=jmain)
    saving = pt.Scope()
    convert.load_params(saving, weights, pt.CPUPlace(), [pmain])
    with pt.scope_guard(saving):
        pt.io.save_inference_model(pdir, feeds, [plogits],
                                   pt.Executor(pt.CPUPlace()),
                                   main_program=pmain)

    rng = np.random.RandomState(0)
    feed = {"src_ids": rng.randint(2, 30, (2, 8)).astype(np.int64),
            "src_lens": np.array([8, 6], np.int64),
            "trg_ids": np.full((2, 2), 2, np.int64),
            "prefix_lens": np.array([2, 2], np.int64)}
    with pt.unique_name.guard():
        pspec = PT.build_decode(cfg_of(PT), src_len=8, prefix_len=2,
                                max_len=12)
    with jun.guard():
        jspec = JT.build_decode(cfg_of(JT), src_len=8, prefix_len=2,
                                max_len=12)
    pred = inference.create_predictor(inference.Config(
        pdir, place=pt.CPUPlace()))
    toks = pred.generate(pspec, feed, max_new_tokens=5, eos_id=-1)
    assert toks.shape == (2, 5) and len(np.unique(toks)) > 1
    jtoks = jinference.create_predictor(jinference.Config(jdir)).generate(
        jspec, feed, max_new_tokens=5, eos_id=-1)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    ref = pdecode.Generator(pspec, scope=saving, place=pt.CPUPlace()
                            ).generate(feed, max_new_tokens=5, eos_id=-1)
    np.testing.assert_array_equal(toks, ref)
    jref = jdecode.Generator(jspec, scope=jscope).generate(
        feed, max_new_tokens=5, eos_id=-1)
    np.testing.assert_array_equal(toks, np.asarray(jref))
    assert len(pred._generators) == 1
    gen = next(iter(pred._generators.values()))[1]
    again = pred.generate(pspec, feed, max_new_tokens=5, eos_id=-1)
    np.testing.assert_array_equal(again, toks)
    assert len(pred._generators) == 1
    assert next(iter(pred._generators.values()))[1] is gen
