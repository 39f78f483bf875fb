"""The training slice against the JAX package: programs, grad lowerings,
optimizer updates, AMP, and transformer training end to end.

Model: the head_dim-64 config `TransformerConfig(src_vocab_size=64,
trg_vocab_size=64, n_layer=2, n_head=2, d_model=128, d_inner=256,
dropout=0.0, max_length=128)` at seq 128, batch 4, with ragged source
lengths [128, 100, 64, 17] (`use_src_lens=True`), so that every attention
takes the mha_block tier: flash_attention="interpret" runs the JAX
package's Pallas kernels in interpret mode and the port's kernel wrappers
as their plain versions.  (transformer.tiny() has head_dim 16, which the
kernel gates send to the composite.)

The port's startup draws from a torch.Generator, the JAX package's from
jax.random, so the port starts from the JAX scope's persistables (weights,
moments, beta powers, learning rate), carried with `convert.load_params`.

Tolerances: op lowerings 1e-5 (float32, other summation orders); grads
after one backward rtol 1e-4 / atol 1e-5; losses over three Adam steps
rtol 2e-4 (the bar ROADMAP.md set for the training slice); the AMP step-1 loss 2e-2 relative (both
packages round to bfloat16 at other points).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import amp as jamp
from paddle_tpu import flags as jflags
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import convert, flags as pflags, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import attention_ops as pattn
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.ops.cuda import flash_attention as pfa
from paddle_tpu_torch.ops.cuda import mha_block as pmha

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0, max_length=128)
BATCH, STEPS, LR = 4, 3, 1e-3
SRC_LENS = [128, 100, 64, 17]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for f in (jflags, pflags):
        f.reset("flash_attention")


def _feed(small=SMALL, src_lens=SRC_LENS):
    feed = JT.synthetic_batch(BATCH, JT.TransformerConfig(**small), seed=3)
    feed["src_lens"] = np.asarray(src_lens, np.int64)
    return feed


def _jax_build(use_amp, l2=0.0, small=SMALL):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), jun.guard():
        loss, _ = JT.build(JT.TransformerConfig(**small), use_src_lens=True)
        flipped = (jamp.cast_model_to_bf16(main, startup) if use_amp
                   else set())
        reg = fluid.regularizer.L2Decay(l2) if l2 else None
        _, pg = fluid.optimizer.Adam(LR, multi_precision=use_amp,
                                     regularization=reg).minimize(loss)
    return main, startup, loss, pg, flipped


def _port_build(use_amp, l2=0.0, small=SMALL):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = PT.build(PT.TransformerConfig(**small), use_src_lens=True)
        flipped = (pamp.cast_model_to_bf16(main, startup) if use_amp
                   else set())
        reg = pt.regularizer.L2Decay(l2) if l2 else None
        _, pg = pt.optimizer.Adam(LR, multi_precision=use_amp,
                                  regularization=reg).minimize(loss)
    return main, startup, loss, pg, flipped


def _jax_train(use_amp, steps, small=SMALL, src_lens=SRC_LENS):
    """The JAX package's startup persistables, its per-step losses and the
    first step's param grads."""
    jflags.set("flash_attention", "interpret")
    try:
        main, startup, loss, pg, flipped = _jax_build(use_amp, small=small)
        scope = JScope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        params = {v.name: np.asarray(scope.find_var(v.name))
                  for v in main.list_vars() if v.persistable}
        grads = [g.name for _, g in pg]
        losses, first = [], None
        for step in range(steps):
            # every step fetches the grads: one fetch list, one compiled
            # plan
            outs = exe.run(main, feed=_feed(small, src_lens), scope=scope,
                           fetch_list=[loss.name] + grads)
            losses.append(float(np.asarray(outs[0], np.float32).ravel()[0]))
            if not step:
                first = {n: np.asarray(o, np.float32)
                         for n, o in zip(grads, outs[1:])}
        after = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
    finally:
        jflags.reset("flash_attention")
    return dict(params=params, losses=losses, grads=first, after=after,
                flipped=flipped)


@pytest.fixture(scope="module")
def jax_f32():
    return _jax_train(False, STEPS)


@pytest.fixture(scope="module")
def jax_amp():
    return _jax_train(True, 1)


# seq 200: off mha_block's 128 grid, so every attention (encoder, causal
# decoder self-attention, cross) takes the streaming flash tier
SMALL_200 = dict(SMALL, max_length=200)
SRC_LENS_200 = [200, 150, 77, 17]


@pytest.fixture(scope="module")
def jax_f32_flash():
    return _jax_train(False, STEPS, SMALL_200, SRC_LENS_200)


def _port_train(jrun, use_amp, steps, small=SMALL, src_lens=SRC_LENS):
    pflags.set("flash_attention", "interpret")
    main, startup, loss, pg, flipped = _port_build(use_amp, small=small)
    scope = pt.Scope()
    convert.load_params(scope, jrun["params"], pt.CPUPlace(), [main])
    exe = pt.Executor(pt.CPUPlace())
    grads = [g.name for _, g in pg]
    losses, first = [], None
    pattn.TIER_CALLS.clear()
    counts = (pmha.launches, pmha.bwd_launches, pfa.launches,
              pfa.bwd_dq_launches, pfa.bwd_dkv_launches)
    for step in range(steps):
        outs = exe.run(main, feed=_feed(small, src_lens), scope=scope,
                       fetch_list=[loss] + (grads if not step else []))
        losses.append(float(outs[0].ravel()[0]))
        if not step:
            first = dict(zip(grads, outs[1:]))
    # on the CPU the wrappers run their plain versions and count nothing
    assert (pmha.launches, pmha.bwd_launches, pfa.launches,
            pfa.bwd_dq_launches, pfa.bwd_dkv_launches) == counts
    return dict(main=main, scope=scope, losses=losses, grads=first,
                flipped=flipped, tiers=dict(pattn.TIER_CALLS))


# ---------------------------------------------------------------- programs


def _normalized(prog):
    """The program dict, with integer var dtypes read as one kind: the JAX
    package runs with x64 off, so its shape inference narrows int64 labels
    to int32 where the port keeps int64 (values agree, dtypes do not)."""
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


SMALL_DROP = dict(SMALL, dropout=0.1)


@pytest.mark.parametrize("use_amp,l2,small", [
    (False, 0.0, SMALL), (True, 0.0, SMALL), (False, 1e-4, SMALL),
    (False, 0.0, SMALL_DROP), (True, 0.0, SMALL_DROP)],
    ids=["f32", "amp", "l2decay", "dropout", "dropout_amp"])
def test_training_programs_are_identical(use_amp, l2, small):
    """After minimize: the same main and startup programs, op for op (type,
    inputs, outputs, attrs with op_role and op_role_var), var for var;
    with L2Decay, the same decay `scale` and `sum` ops on every grad; at
    dropout 0.1, the 16 dropouts (and their grads) where the JAX package
    puts them."""
    jm, js, _, jpg, jflipped = _jax_build(use_amp, l2, small)
    pm, ps, _, ppg, pflipped = _port_build(use_amp, l2, small)
    assert sum(op.type == "dropout_grad" for op in pm.global_block().ops) \
        == (16 if small["dropout"] else 0)
    for j, p in ((jm, pm), (js, ps)):
        jd, pd = _normalized(j), _normalized(p)
        jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
        assert [o["type"] for o in pops] == [o["type"] for o in jops]
        for jo, po in zip(jops, pops):
            assert po == jo, jo["type"]
        assert pd == jd
    assert [(p.name, g.name) for p, g in ppg] == \
        [(p.name, g.name) for p, g in jpg]
    assert pflipped == jflipped


def test_transformer_base_step_op_counts():
    """transformer-base + Adam: the op census of the JAX package's program
    (44 `sum` ops fold multi-consumer grads, one of them for the tied
    src_word_emb; 372 of the 374 `scale` ops are beta-power updates)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = PT.build(PT.TransformerConfig(max_length=256, dropout=0.0))
        pt.optimizer.Adam(1e-4).minimize(loss)
    counts = collections.Counter(op.type for op in main.global_block().ops)
    assert counts == {
        "lookup_table": 2, "scale": 374, "elementwise_add": 56,
        "layer_norm": 32, "mul": 97, "fused_attention": 18, "relu": 12,
        "reshape": 2, "softmax_with_cross_entropy": 1, "mean": 1,
        "fill_constant": 1, "mean_grad": 1,
        "softmax_with_cross_entropy_grad": 1, "reshape_grad": 1,
        "mul_grad": 97, "layer_norm_grad": 32, "elementwise_add_grad": 56,
        "relu_grad": 12, "sum": 44, "fused_attention_grad": 18,
        "scale_grad": 2, "lookup_table_grad": 2, "adam": 186}
    emb_sums = [op for op in main.global_block().ops if op.type == "sum"
                and op.output("Out") == ["src_word_emb@GRAD"]]
    assert len(emb_sums) == 1
    assert emb_sums[0].input("X") == ["src_word_emb@GRAD",
                                      "src_word_emb@GRAD@RENAME@1"]
    st = collections.Counter(op.type for op in startup.global_block().ops)
    assert st == {"uniform_random": 98, "assign_value": 1,
                  "fill_constant": 833}


# ----------------------------------------------------- grad lowerings


def _run(reg, backend, op_type, inputs, attrs, out_names):
    info = reg.get_runtime_info(op_type)
    if backend == "jax":
        ins = {p: [None if a is None else jnp.asarray(a) for a in v]
               for p, v in inputs.items()}
        outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names)
        return {p: [None if o is None else np.asarray(o, np.float32)
                    for o in v] for p, v in outs.items()}
    ins = {p: [None if a is None else torch.as_tensor(np.array(a))
               for a in v] for p, v in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names,
                           device=torch.device("cpu"))
    return {p: [None if o is None else o.float().numpy() for o in v]
            for p, v in outs.items()}


def _assert_same(op_type, inputs, attrs, out_names):
    j = _run(jreg, "jax", op_type, inputs, attrs, out_names)
    p = _run(preg, "torch", op_type, inputs, attrs, out_names)
    assert sorted(p) == sorted(j), (sorted(p), sorted(j))
    for param in j:
        for a, b in zip(j[param], p[param], strict=True):
            assert (a is None) == (b is None), param
            if a is not None:
                assert b.shape == a.shape, (param, b.shape, a.shape)
                np.testing.assert_allclose(b, a, rtol=0, atol=ATOL,
                                           err_msg=f"{op_type}.{param}")


def _grad_case(op_type, fwd_inputs, attrs, diff, seed, dropped=()):
    """Run `<op_type>_grad` in both packages: the forward inputs, the
    forward outputs (from the JAX lowering) and a random cotangent for
    each output not in `dropped` (those get none, as when no grad flows
    into them); `diff` are the params whose grads are asked for."""
    rng = np.random.RandomState(seed)
    fwd = _run(jreg, "jax", op_type, fwd_inputs, attrs,
               {p: [f"o{i}"] for i, p in enumerate(("Out", "Y", "Loss",
                                                     "Softmax"))})
    inputs = dict(fwd_inputs)
    for param, vals in fwd.items():
        inputs[param] = vals
        inputs[param + "@GRAD"] = [
            None if param in dropped
            else rng.standard_normal(v.shape).astype(np.float32)
            for v in vals]
    out_names = {p + "@GRAD": [f"{p}@GRAD"] * len(fwd_inputs[p])
                 for p in diff}
    _assert_same(op_type + "_grad", inputs, attrs, out_names)


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_mul_grad():
    rng = np.random.RandomState(0)
    _grad_case("mul", {"X": [_r(rng, 2, 3, 16)], "Y": [_r(rng, 16, 5)]},
               {"x_num_col_dims": 2, "y_num_col_dims": 1}, ("X", "Y"), 1)


@pytest.mark.parametrize("y_shape,axis", [((3, 8), 1), ((8,), 2),
                                          ((2, 3, 8), -1)],
                         ids=["position_table", "bias", "same_shape"])
def test_elementwise_add_grad_reduces_broadcast_dims(y_shape, axis):
    rng = np.random.RandomState(2)
    _grad_case("elementwise_add", {"X": [_r(rng, 2, 3, 8)],
                                   "Y": [_r(rng, *y_shape)]},
               {"axis": axis}, ("X", "Y"), 3)


def test_scale_reshape_relu_mean_grads():
    rng = np.random.RandomState(4)
    _grad_case("scale", {"X": [_r(rng, 3, 7)]},
               {"scale": 22.627417, "bias": 0.0, "bias_after_scale": True},
               ("X",), 5)
    _grad_case("reshape", {"X": [_r(rng, 2, 3, 8)]}, {"shape": [-1, 8]},
               ("X",), 6)
    _grad_case("mean", {"X": [_r(rng, 12, 1)]}, {}, ("X",), 7)
    x = _r(rng, 4, 9)
    out = np.maximum(x, 0)
    _assert_same("relu_grad", {"Out": [out], "Out@GRAD": [_r(rng, 4, 9)]},
                 {}, {"X@GRAD": ["x@GRAD"]})


def test_layer_norm_grad():
    rng = np.random.RandomState(8)
    _grad_case("layer_norm", {"X": [_r(rng, 2, 5, 16)],
                              "Scale": [_r(rng, 16)], "Bias": [_r(rng, 16)]},
               {"epsilon": 1e-5, "begin_norm_axis": 2},
               ("X", "Scale", "Bias"), 9, dropped=("Mean", "Variance"))


@pytest.mark.parametrize("eps", [0.0, 0.1], ids=["plain", "smoothed"])
def test_softmax_with_cross_entropy_and_its_grad(eps):
    rng = np.random.RandomState(10)
    logits = _r(rng, 12, 33)
    label = rng.randint(0, 33, size=(12, 1)).astype(np.int64)
    label[3, 0] = -100                       # ignore_index: zero loss
    attrs = {"soft_label": False, "ignore_index": -100,
             "label_smooth_eps": eps}
    _assert_same("softmax_with_cross_entropy",
                 {"Logits": [logits], "Label": [label]}, attrs,
                 {"Softmax": ["s"], "Loss": ["l"]})
    _grad_case("softmax_with_cross_entropy",
               {"Logits": [logits], "Label": [label]}, attrs, ("Logits",),
               11, dropped=("Softmax",))


def test_sum_mean_cast():
    rng = np.random.RandomState(12)
    xs = [_r(rng, 3, 4) for _ in range(3)]
    _assert_same("sum", {"X": xs}, {}, {"Out": ["o"]})
    _assert_same("mean", {"X": [_r(rng, 5, 7)]}, {}, {"Out": ["o"]})
    j = _run(jreg, "jax", "cast", {"X": [xs[0]]},
             {"in_dtype": "float32", "out_dtype": "bfloat16"}, {"Out": ["o"]})
    p = _run(preg, "torch", "cast", {"X": [xs[0]]},
             {"in_dtype": "float32", "out_dtype": "bfloat16"}, {"Out": ["o"]})
    np.testing.assert_array_equal(p["Out"][0], j["Out"][0])


@pytest.mark.parametrize("padding_idx", [-1, 2])
def test_lookup_table_grad_adds_repeated_ids(padding_idx):
    rng = np.random.RandomState(13)
    w = _r(rng, 6, 8)
    ids = np.asarray([[1, 2, 1], [5, 1, 2]], np.int64)   # repeated ids
    attrs = {"padding_idx": padding_idx, "is_sparse": False,
             "is_distributed": False, "strip_trailing_one": False}
    inputs = {"W": [w], "Ids": [ids], "Out@GRAD": [_r(rng, 2, 3, 8)]}
    _assert_same("lookup_table_grad", inputs, attrs,
                 {"W@GRAD": ["w@GRAD"]})
    g = _run(preg, "torch", "lookup_table_grad", inputs, attrs,
             {"W@GRAD": ["w@GRAD"]})["W@GRAD"][0]
    if padding_idx == 2:
        assert not g[2].any()
    np.testing.assert_allclose(
        g[1], inputs["Out@GRAD"][0].reshape(6, 8)[[0, 2, 4]].sum(0),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
def test_adam_update(master):
    rng = np.random.RandomState(14)
    p = _r(rng, 5, 3)
    inputs = {"Param": [p], "Grad": [_r(rng, 5, 3)],
              "Moment1": [_r(rng, 5, 3) * 0.1],
              "Moment2": [np.abs(_r(rng, 5, 3)) * 0.01],
              "Beta1Pow": [np.asarray([0.81], np.float32)],
              "Beta2Pow": [np.asarray([0.998], np.float32)],
              "LearningRate": [np.asarray([1e-2], np.float32)]}
    out_names = {"ParamOut": ["p"], "Moment1Out": ["m1"],
                 "Moment2Out": ["m2"]}
    if master:
        inputs["MasterParam"] = [p + 1e-3]
        out_names["MasterParamOut"] = ["pm"]
    _assert_same("adam", inputs,
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, out_names)


@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
def test_sgd_update(master):
    rng = np.random.RandomState(15)
    p = _r(rng, 4, 6)
    inputs = {"Param": [p], "Grad": [_r(rng, 4, 6)],
              "LearningRate": [np.asarray([0.5], np.float32)]}
    out_names = {"ParamOut": ["p"]}
    if master:
        inputs["MasterParam"] = [p - 1e-3]
        out_names["MasterParamOut"] = ["pm"]
    _assert_same("sgd", inputs, {}, out_names)


# ------------------------------------------------------------ executor


def test_executor_writes_back_persistables_and_fetches_only():
    """A training step stores the updated persistables and the fetch
    targets; activations and grads die after their last reader.  The
    startup's parameters are ordinary tensors that autograd can use."""
    pm, ps, loss, pg, _ = _port_build(False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(ps, scope=scope)
    w = scope.find_var("src_word_emb")
    assert not w.is_inference() and not w.requires_grad
    before = w.clone()
    exe.run(pm, feed=_feed(), fetch_list=[loss, pg[0][1]], scope=scope)
    persistable = {v.name for v in pm.list_vars() if v.persistable}
    names = set(scope.local_var_names()) - {"@RNG_COUNTER@"}
    feeds = set(_feed())
    assert names == persistable | feeds | {loss.name, pg[0][1].name}
    assert not torch.equal(scope.find_var("src_word_emb"), before)


def test_sgd_trains_the_tiny_transformer():
    """SGD end to end on the composite tier (head_dim 16): the loss falls."""
    cfg = PT.tiny(vocab=50, max_length=16)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = PT.build(cfg)
        pt.optimizer.SGD(0.5).minimize(loss)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = PT.synthetic_batch(4, cfg, seed=1)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1


def test_feed_shapes_and_synthetic_batch_match():
    assert PT.feed_shapes(8, 64) == JT.feed_shapes(8, 64)
    j = JT.synthetic_batch(3, JT.TransformerConfig(**SMALL), seed=5)
    p = PT.synthetic_batch(3, PT.TransformerConfig(**SMALL), seed=5)
    assert sorted(p) == sorted(j)
    for name in j:
        np.testing.assert_array_equal(p[name], j[name])


def test_calc_gradient_matches_jax():
    """backward.gradients of a loss with respect to a non-parameter input:
    the same grad ops, and the same values from the same weights."""
    from paddle_tpu import backward as jbackward

    def build(pkg, guard, backward):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            x = pkg.layers.data(name="x", shape=[8], dtype="float32",
                                stop_gradient=False)
            h = pkg.layers.fc(input=x, size=6, act="relu", name="h")
            loss = pkg.layers.mean(pkg.layers.scale(h, scale=3.0))
            (dx,) = backward.gradients(loss, [x])
        return main, startup, dx

    jm, js, jdx = build(fluid, jun.guard, jbackward)
    pm, ps, pdx = build(pt, pt.unique_name.guard, pt.backward)
    assert _normalized(pm) == _normalized(jm)
    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    x = np.random.RandomState(16).standard_normal((5, 8)).astype(np.float32)
    (jg,) = jexe.run(jm, feed={"x": x}, fetch_list=[jdx.name], scope=jscope)
    scope = pt.Scope()
    convert.load_params(scope, {n: np.asarray(jscope.find_var(n))
                                for n in ("h.w_0", "h.w_1")},
                        pt.CPUPlace(), [pm])
    (pg,) = pt.Executor(pt.CPUPlace()).run(pm, feed={"x": x},
                                           fetch_list=[pdx], scope=scope)
    np.testing.assert_allclose(pg, np.asarray(jg), rtol=0, atol=ATOL)


def test_untrainable_configs_raise():
    """Every config builds now: MoE FFNs (a gating op each, their aux
    losses folded into the loss, the JAX package's program); dropout (its
    op is ported): 2 embeddings, 2 x 3 encoder and 2 x 4 decoder sites;
    the fused loss head builds one linear_softmax_ce in place of the
    logits fc and its loss."""
    progs = []
    for pkg, T, guard in ((pt, PT, pt.unique_name.guard),
                          (fluid, JT, jun.guard)):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), guard():
            T.build(T.TransformerConfig(**dict(SMALL, moe_experts=4)))
        progs.append([op.type for op in main.global_block().ops])
    assert progs[0] == progs[1]
    assert progs[0].count("top_k_gating") == 4
    main = pt.Program()
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard():
        PT.build(PT.TransformerConfig(**dict(SMALL, dropout=0.1)))
    assert [op.type for op in main.global_block().ops].count("dropout") == 16
    main = pt.Program()
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard():
        PT.build(PT.TransformerConfig(**SMALL), fused_head=True)
    types = [op.type for op in main.global_block().ops]
    assert types.count("linear_softmax_ce") == 1
    assert "softmax_with_cross_entropy" not in types


# ---------------------------------------------------------- end to end


def test_grads_and_adam_losses_match_jax(jax_f32):
    """One backward: every param@GRAD within rtol 1e-4 / atol 1e-5 of the
    JAX package's; three Adam steps: losses within rtol 2e-4; and the
    persistables after the steps agree."""
    port = _port_train(jax_f32, False, STEPS)
    n = SMALL["n_layer"]
    # every attention took the mha_block tier, forward and backward
    assert port["tiers"] == {"mha_block": STEPS * 3 * n}
    assert sorted(port["grads"]) == sorted(jax_f32["grads"])
    for name, ref in jax_f32["grads"].items():
        np.testing.assert_allclose(port["grads"][name], ref, rtol=1e-4,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(port["losses"], jax_f32["losses"], rtol=2e-4)
    assert port["losses"][-1] < port["losses"][0]
    scope = port["scope"]
    for name, ref in jax_f32["after"].items():
        np.testing.assert_allclose(scope.find_var(name).numpy(), ref,
                                   rtol=1e-3, atol=1e-5, err_msg=name)


# seq 32 (ragged source lengths up to 32), dropout 0.1
SMALL_DROP_32 = dict(SMALL_DROP, max_length=32)
SRC_LENS_32 = [32, 25, 9, 3]


def test_dropout_grads_and_adam_losses_match_jax_with_carried_masks(
        monkeypatch):
    """At dropout 0.1, with both packages' dropout drawing the same masks
    (testing.seeded_dropout, keyed by each Mask var's name): every
    param@GRAD within rtol 1e-4 / atol 1e-5, three Adam losses within
    rtol 2e-4."""
    for reg, as_array in (
            (jreg, lambda k, x: jnp.asarray(k, dtype=x.dtype)),
            (preg, lambda k, x: torch.as_tensor(k).to(x.device, x.dtype))):
        info = reg.OPS["dropout"]
        monkeypatch.setattr(info, "forward",
                            testing.seeded_dropout(info.forward, as_array))
    ref = _jax_train(False, STEPS, SMALL_DROP_32, SRC_LENS_32)
    port = _port_train(ref, False, STEPS, SMALL_DROP_32, SRC_LENS_32)
    assert sorted(port["grads"]) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(port["grads"][name], want, rtol=1e-4,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=2e-4)
    assert port["losses"][-1] < port["losses"][0]


def test_flash_tier_grads_and_adam_losses_match_jax(jax_f32_flash):
    """The same model at seq 200: every attention's forward and grad takes
    the flash tier (the plain versions of kernels #3, #4 and #5 against
    the JAX package's Pallas kernels in interpret mode); grads rtol 1e-4 /
    atol 1e-5 and three Adam losses rtol 2e-4."""
    port = _port_train(jax_f32_flash, False, STEPS, SMALL_200, SRC_LENS_200)
    assert port["tiers"] == {"flash": STEPS * 3 * SMALL["n_layer"]}
    assert sorted(port["grads"]) == sorted(jax_f32_flash["grads"])
    for name, ref in jax_f32_flash["grads"].items():
        np.testing.assert_allclose(port["grads"][name], ref, rtol=1e-4,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(port["losses"], jax_f32_flash["losses"],
                               rtol=2e-4)
    assert port["losses"][-1] < port["losses"][0]


def test_amp_step_matches_jax(jax_amp):
    """cast_model_to_bf16 flips the same names; after one AMP step the
    params are bf16 and the `_master` vars f32 under the JAX names; the
    step-1 loss is within 2e-2 relative."""
    port = _port_train(jax_amp, True, 1)
    assert port["flipped"] == jax_amp["flipped"]
    scope, main = port["scope"], port["main"]
    masters = [v.name for v in main.list_vars() if "_master" in v.name]
    assert masters and sorted(masters) == sorted(
        n for n in jax_amp["after"] if "_master" in n)
    for v in main.list_vars():
        if not v.persistable:
            continue
        t = scope.find_var(v.name)
        if isinstance(v, pt.Parameter) and v.trainable:
            assert t.dtype == torch.bfloat16, v.name
        if "_master" in v.name:
            assert t.dtype == torch.float32, v.name
            param = scope.find_var(v.name.rsplit("_master", 1)[0])
            assert torch.equal(t.to(torch.bfloat16), param), v.name
    assert abs(port["losses"][0] - jax_amp["losses"][0]) <= \
        2e-2 * abs(jax_amp["losses"][0])
