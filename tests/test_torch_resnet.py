"""The ResNet slice against the JAX package: the conv, pool, batch_norm,
top_k, accuracy, softmax, cross_entropy and momentum lowerings and their
grads, the Program dicts of resnet.build + Momentum.minimize, and ResNet
training end to end.

Models: `resnet.build(dataset="cifar10", depth=8)` (basic blocks, softmax
+ cross_entropy) at batch 4; the bottleneck path at batch 2 with a
[3, 32, 32] image: the 7x7 stem, the max pool, a bottleneck with a
channel-changing 1x1 shortcut and one with a strided 1x1 shortcut, the
global pool and the fc, built from the models' own conv_bn / bottleneck /
_layer_warp; and `resnet.resnet_imagenet(img, depth=50, class_dim=10,
act=None)` + softmax_with_cross_entropy at batch 2 on [3, 64, 64] images,
whose step-1 loss is compared.  (At 32x32 the depth-50 net's last maps are
1x1, so its batch norms see 2 values per channel and pass back a gradient
that is 0 in exact arithmetic and rounding noise in either package.)  The
port starts from the JAX scope's persistables (filters, BN scale/bias and
running stats, velocities, master weights), carried with
`convert.load_params`.

Tolerances: op lowerings and grads rtol 1e-5 / atol 1e-5 (float32, other
summation orders); grads after one backward rtol 1e-4 / atol 1e-5; losses
over three Momentum steps rtol 2e-4; the AMP step-1 loss 2e-2 relative
(both packages round to bfloat16 at other points).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import amp as jamp
from paddle_tpu import flags as jflags
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import resnet as JR
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import convert, flags as pflags, testing
from paddle_tpu_torch.models import resnet as PR
from paddle_tpu_torch.ops import nn_ops as pnn
from paddle_tpu_torch.ops import registry as preg

TOL = 1e-5
STEPS, LR, MU = 3, 0.1, 0.9


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for f in (jflags, pflags):
        f.reset("conv1x1_as_dot")


# ------------------------------------------------------------ op lowerings


def _run(reg, backend, op_type, inputs, attrs, out_names):
    info = reg.get_runtime_info(op_type)
    if backend == "jax":
        ins = {p: [None if a is None else jnp.asarray(a) for a in v]
               for p, v in inputs.items()}
        outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names)
        return {p: [None if o is None else np.asarray(o) for o in v]
                for p, v in outs.items()}
    ins = {p: [None if a is None else torch.as_tensor(np.array(a))
               for a in v] for p, v in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names,
                           device=torch.device("cpu"))
    return {p: [None if o is None else o.numpy() for o in v]
            for p, v in outs.items()}


def _assert_same(op_type, inputs, attrs, out_names):
    """Every output the JAX lowering sets, at rtol/atol 1e-5, the same
    shape and dtype kind (integers compare as one kind: the JAX package
    narrows int64 to int32)."""
    j = _run(jreg, "jax", op_type, inputs, attrs, out_names)
    p = _run(preg, "torch", op_type, inputs, attrs, out_names)
    j = {k: v for k, v in j.items() if any(o is not None for o in v)}
    p = {k: v for k, v in p.items() if any(o is not None for o in v)}
    assert sorted(p) == sorted(j), (sorted(p), sorted(j))
    for param in j:
        for a, b in zip(j[param], p[param], strict=True):
            assert b.shape == a.shape, (param, b.shape, a.shape)
            assert (b.dtype == a.dtype
                    or b.dtype.kind == a.dtype.kind == "i"), \
                (param, b.dtype, a.dtype)
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=TOL,
                                       atol=TOL, err_msg=f"{op_type}.{param}")
    return j, p


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (name, x shape, filter shape, strides, paddings, groups)
_CONVS = {
    "stem 7x7/2 pad 3": ((2, 3, 16, 16), (8, 3, 7, 7), 2, 3, 1),
    "3x3/1": ((2, 8, 9, 9), (8, 8, 3, 3), 1, 1, 1),
    "3x3/2": ((2, 8, 9, 9), (16, 8, 3, 3), 2, 1, 1),
    "1x1/1": ((2, 8, 7, 7), (16, 8, 1, 1), 1, 0, 1),
    "1x1/2": ((2, 8, 7, 7), (16, 8, 1, 1), 2, 0, 1),
    "grouped 3x3": ((2, 8, 6, 6), (12, 4, 3, 3), 1, 1, 2),
}


def _conv_case(name, seed=0):
    xs, ws, s, p, g = _CONVS[name]
    rng = np.random.RandomState(seed)
    fan_in = ws[1] * ws[2] * ws[3]
    inputs = {"Input": [_r(rng, *xs)],
              "Filter": [_r(rng, *ws, scale=fan_in ** -0.5)]}
    attrs = {"strides": [s, s], "paddings": [p, p], "dilations": [1, 1],
             "groups": g, "use_cudnn": True}
    return inputs, attrs


@pytest.mark.parametrize("as_dot", [False, True], ids=["conv", "as_dot"])
@pytest.mark.parametrize("name", list(_CONVS))
def test_conv2d_and_its_grad_match_jax(name, as_dot):
    """The forward, and the hand-written grad (one convolution backward
    from Input and Filter) against the JAX package's jax.vjp replay."""
    for f in (jflags, pflags):
        f.set("conv1x1_as_dot", as_dot)
    inputs, attrs = _conv_case(name)
    j, _ = _assert_same("conv2d", inputs, attrs, {"Output": ["o"]})
    rng = np.random.RandomState(1)
    out = j["Output"][0]
    g_in = dict(inputs, Output=[out], **{"Output@GRAD": [_r(rng,
                                                            *out.shape)]})
    _assert_same("conv2d_grad", g_in, attrs,
                 {"Input@GRAD": ["x@GRAD"], "Filter@GRAD": ["w@GRAD"]})


def test_conv2d_fuse_relu_and_a_filter_only_grad():
    """fuse_relu masks the grad where the output is 0; a grad desc that
    asks for Filter@GRAD only computes and sets that one."""
    inputs, attrs = _conv_case("3x3/1", seed=2)
    attrs["fuse_relu"] = True
    j, _ = _assert_same("conv2d", inputs, attrs, {"Output": ["o"]})
    out = j["Output"][0]
    assert (out == 0).mean() > 0.2
    g_in = dict(inputs, Output=[out], **{"Output@GRAD": [
        _r(np.random.RandomState(3), *out.shape)]})
    _assert_same("conv2d_grad", g_in, attrs,
                 {"Input@GRAD": ["x@GRAD"], "Filter@GRAD": ["w@GRAD"]})
    p = _run(preg, "torch", "conv2d_grad", g_in, attrs,
             {"Input@GRAD": [pt.framework.framework.EMPTY_VAR_NAME],
              "Filter@GRAD": ["w@GRAD"]})
    assert "Input@GRAD" not in p and p["Filter@GRAD"][0].shape == (8, 8, 3,
                                                                   3)


def test_conv2d_grad_does_not_replay_the_forward(monkeypatch):
    """The grad lowering is the hand-written one and runs no forward
    convolution."""
    assert preg.get_runtime_info("conv2d_grad").forward is pnn.conv2d_grad
    calls = []
    real = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    inputs, attrs = _conv_case("3x3/2")
    g_in = dict(inputs, Output=[np.zeros((2, 16, 5, 5), np.float32)],
                **{"Output@GRAD": [np.ones((2, 16, 5, 5), np.float32)]})
    _run(preg, "torch", "conv2d_grad", g_in, attrs,
         {"Input@GRAD": ["x@GRAD"], "Filter@GRAD": ["w@GRAD"]})
    assert calls == []


_POOLS = {
    "max 3x3/2 pad 1": dict(pooling_type="max", ksize=[3, 3],
                            strides=[2, 2], paddings=[1, 1]),
    "global avg": dict(pooling_type="avg", ksize=[-1, -1], strides=[1, 1],
                       paddings=[0, 0], global_pooling=True),
    "avg exclusive pad 1": dict(pooling_type="avg", ksize=[3, 3],
                                strides=[2, 2], paddings=[1, 1],
                                exclusive=True),
    "avg inclusive pad 1": dict(pooling_type="avg", ksize=[3, 3],
                                strides=[2, 2], paddings=[1, 1],
                                exclusive=False),
    "max ceil_mode": dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
                          paddings=[0, 0], ceil_mode=True),
    "avg ceil_mode exclusive": dict(pooling_type="avg", ksize=[2, 2],
                                    strides=[2, 2], paddings=[0, 0],
                                    ceil_mode=True, exclusive=True),
}


@pytest.mark.parametrize("name", list(_POOLS))
def test_pool2d_and_its_grad_match_jax(name):
    """Forward and the generic grad.  The input is relu'd, so max windows
    tie at 0 and both packages must send the grad to the same element."""
    attrs = dict(_POOLS[name])
    rng = np.random.RandomState(4)
    x = np.maximum(_r(rng, 2, 3, 9, 9), 0.0)
    x[0, 0, :4, :4] = 0.0      # all-zero windows
    j, _ = _assert_same("pool2d", {"X": [x]}, attrs, {"Out": ["o"]})
    out = j["Out"][0]
    _assert_same("pool2d_grad",
                 {"X": [x], "Out": [out],
                  "Out@GRAD": [_r(rng, *out.shape)]},
                 attrs, {"X@GRAD": ["x@GRAD"]})


def _bn_inputs(seed, c=6):
    rng = np.random.RandomState(seed)
    return {"X": [_r(rng, 4, c, 5, 5) * 2 + 0.5],
            "Scale": [1.0 + _r(rng, c, scale=0.2)],
            "Bias": [_r(rng, c, scale=0.2)],
            "Mean": [_r(rng, c, scale=0.3)],
            "Variance": [np.abs(_r(rng, c)) + 0.5]}


_BN_OUTS = {"Y": ["y"], "MeanOut": ["m"], "VarianceOut": ["v"],
            "SavedMean": ["sm"], "SavedVariance": ["sv"]}


@pytest.mark.parametrize("act", [None, "relu"], ids=["no_act", "relu"])
@pytest.mark.parametrize("mode", ["train", "test", "global_stats"])
def test_batch_norm_matches_jax(mode, act):
    """Y and the MeanOut/VarianceOut/SavedMean/SavedVariance outputs."""
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": mode == "test",
             "data_layout": "NCHW",
             "use_global_stats": mode == "global_stats", "act": act}
    _assert_same("batch_norm", _bn_inputs(5), attrs, _BN_OUTS)


@pytest.mark.parametrize("act", [None, "relu"], ids=["no_act", "relu"])
@pytest.mark.parametrize("mode", ["train", "test", "standalone"])
def test_batch_norm_grad_matches_jax(mode, act):
    """The hand-written grad in both packages, from the forward's saved
    statistics (train), the running stats (test) or none (standalone:
    reduced from X again); with act relu it masks on the recomputed
    pre-activation."""
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": mode == "test",
             "data_layout": "NCHW", "use_global_stats": False, "act": act}
    inputs = _bn_inputs(6)
    fwd = _run(jreg, "jax", "batch_norm", inputs, attrs, _BN_OUTS)
    rng = np.random.RandomState(7)
    g = dict(inputs, **{"Y@GRAD": [_r(rng, *fwd["Y"][0].shape)]})
    if mode != "standalone":
        g["SavedMean"] = fwd["SavedMean"]
        g["SavedVariance"] = fwd["SavedVariance"]
    assert preg.get_runtime_info("batch_norm_grad").no_grad
    _assert_same("batch_norm_grad", g, attrs,
                 {"X@GRAD": ["x@GRAD"], "Scale@GRAD": ["s@GRAD"],
                  "Bias@GRAD": ["b@GRAD"]})


def test_batch_norm_grad_is_not_a_vjp_of_the_forward():
    """The train-mode grad equals autograd through the forward (the
    statistics are functions of X) without running the forward."""
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": "NCHW", "use_global_stats": False, "act": "relu"}
    ins = {k: torch.as_tensor(v[0]).double() for k, v in
           _bn_inputs(8).items()}
    x = ins["X"].clone().requires_grad_(True)
    s = ins["Scale"].clone().requires_grad_(True)
    b = ins["Bias"].clone().requires_grad_(True)
    mu = x.mean(dim=(0, 2, 3))
    var = (x * x).mean(dim=(0, 2, 3)) - mu * mu
    rstd = 1.0 / torch.sqrt(var + 1e-5)
    y = torch.relu((x - mu[:, None, None]) * rstd[:, None, None]
                   * s[:, None, None] + b[:, None, None])
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    want = torch.autograd.grad(y, (x, s, b), gy)
    inputs = {k: [v.float().numpy()] for k, v in ins.items()}
    inputs["SavedMean"] = [mu.detach().float().numpy()]
    inputs["SavedVariance"] = [rstd.detach().float().numpy()]
    inputs["Y@GRAD"] = [gy.float().numpy()]
    got = _run(preg, "torch", "batch_norm_grad", inputs, attrs,
               {"X@GRAD": ["x"], "Scale@GRAD": ["s"], "Bias@GRAD": ["b"]})
    for name, w in zip(("X@GRAD", "Scale@GRAD", "Bias@GRAD"), want):
        np.testing.assert_allclose(got[name][0], w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_top_k_accuracy_softmax_cross_entropy_match_jax():
    rng = np.random.RandomState(9)
    logits = _r(rng, 6, 10)
    label = rng.randint(0, 10, (6, 1)).astype(np.int64)
    for k in (1, 3):
        j, _ = _assert_same("top_k", {"X": [logits]}, {"k": k},
                            {"Out": ["o"], "Indices": ["i"]})
        _assert_same("accuracy", {"Out": j["Out"], "Indices": j["Indices"],
                                  "Label": [label]}, {},
                     {"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]})
    sm, _ = _assert_same("softmax", {"X": [logits]}, {}, {"Out": ["o"]})
    probs = sm["Out"][0]
    _assert_same("softmax_grad", {"X": [logits], "Out": [probs],
                                  "Out@GRAD": [_r(rng, 6, 10)]}, {},
                 {"X@GRAD": ["x@GRAD"]})
    soft = np.abs(_r(rng, 6, 10))
    soft /= soft.sum(-1, keepdims=True)
    for lab, attrs in ((label, {"soft_label": False, "ignore_index": -100}),
                       (soft, {"soft_label": True, "ignore_index": -100})):
        j, _ = _assert_same("cross_entropy", {"X": [probs], "Label": [lab]},
                            attrs, {"Y": ["y"]})
        _assert_same("cross_entropy_grad",
                     {"X": [probs], "Label": [lab], "Y": j["Y"],
                      "Y@GRAD": [_r(rng, 6, 1)]}, attrs,
                     {"X@GRAD": ["x@GRAD"]})


def _tied_logits():
    """A bf16-rounded logit batch whose rows tie at their maximum."""
    rng = np.random.RandomState(4)
    x = _r(rng, 8, 10)
    x[:, [2, 5, 7]] = x.max(axis=1, keepdims=True) + 0.25
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("x, k, label", [
    ([[1, 2, 2, 2, 0, 2]], 1, [[1]]),
    ([[1, 2, 2, 2, 0, 2]], 2, [[2]]),
    ([[1, 2, 2, 2, 0, 2]], 3, [[3]]),
    ([[0.5] * 7, [-1.0] * 7], 3, [[2], [4]]),
    (_tied_logits(), 1, [[2]] * 4 + [[5]] * 4),
    (_tied_logits(), 2, [[5]] * 4 + [[7]] * 4),
], ids=["k1", "k2", "k3", "all_equal", "bf16_tied_max_k1",
        "bf16_tied_max_k2"])
def test_top_k_and_accuracy_break_ties_as_jax(x, k, label):
    """Equal values come lower index first, as jax.lax.top_k gives them,
    so accuracy reads the same hits in both packages."""
    x = np.asarray(x, dtype=np.float32)
    label = np.asarray(label, dtype=np.int64)
    j, p = _assert_same("top_k", {"X": [x]}, {"k": k},
                        {"Out": ["o"], "Indices": ["i"]})
    np.testing.assert_array_equal(p["Indices"][0], j["Indices"][0])
    _assert_same("accuracy", {"Out": p["Out"], "Indices": p["Indices"],
                              "Label": [label]}, {},
                 {"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]})


@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
@pytest.mark.parametrize("nesterov", [False, True], ids=["heavy_ball",
                                                         "nesterov"])
def test_momentum_matches_jax(master, nesterov):
    rng = np.random.RandomState(10)
    p = _r(rng, 5, 4)
    inputs = {"Param": [p], "Grad": [_r(rng, 5, 4)],
              "Velocity": [_r(rng, 5, 4)],
              "LearningRate": [np.asarray([0.1], np.float32)]}
    outs = {"ParamOut": ["p"], "VelocityOut": ["v"]}
    if master:
        inputs["MasterParam"] = [p + _r(rng, 5, 4, scale=1e-3)]
        outs["MasterParamOut"] = ["m"]
    _assert_same("momentum", inputs, {"mu": 0.9, "use_nesterov": nesterov},
                 outs)


def test_gaussian_random_draws_from_the_program_generator():
    """Normal(mean, std) in the op's dtype, reproducible per seed."""
    info = preg.get_runtime_info("gaussian_random")
    attrs = {"shape": [400, 50], "dtype": "float32", "mean": 1.0,
             "std": 0.5, "seed": 0}

    def draw(seed, dtype="float32"):
        gen = torch.Generator().manual_seed(seed)
        return preg.run_forward(info, {}, dict(attrs, dtype=dtype), rng=gen,
                                device=torch.device("cpu"))["Out"][0]

    a = draw(1)
    assert torch.equal(a, draw(1)) and not torch.equal(a, draw(2))
    assert abs(a.mean().item() - 1.0) < 0.01
    assert abs(a.std().item() - 0.5) < 0.01
    assert draw(1, "bfloat16").dtype == torch.bfloat16


@pytest.mark.parametrize("init, shape", [
    ("normal", [16, 8, 3, 3]),
    ("xavier_normal", [64, 32]),
    ("xavier_normal", [16, 8, 3, 3]),
])
def test_normal_initializers_emit_the_jax_startup_op(init, shape):
    """Normal(loc, scale) and Xavier(uniform=False) (std sqrt(2 / (fan_in
    + fan_out)), a conv filter's fans counted over its receptive field)
    append the same gaussian_random op as the JAX package."""
    def startup(pkg):
        prog = pkg.Program()
        initializer = (pkg.initializer.Normal(0.5, 0.02) if init == "normal"
                       else pkg.initializer.Xavier(uniform=False))
        with pkg.program_guard(pkg.Program(), prog):
            pkg.layers.create_parameter(shape, "float32", name="w",
                                        default_initializer=initializer)
        return _normalized(prog)

    assert startup(pt) == startup(fluid)


# --------------------------------------------------------------- programs


def _normalized(prog):
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


_BATCH = {"cifar8": 4, "bottleneck50": 2, "bottleneck2": 2}
_HW = {"cifar8": 32, "bottleneck50": 64, "bottleneck2": 32}


def _bottleneck_net(pkg, models):
    """A [3, 64, 64] image through resnet_imagenet(depth=50, 10 classes,
    logits) + softmax_with_cross_entropy."""
    img = pkg.layers.data(name="img", shape=[3, _HW["bottleneck50"],
                                             _HW["bottleneck50"]],
                          dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    logits = models.resnet_imagenet(img, depth=50, class_dim=10, act=None)
    return pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
        logits=logits, label=label))


def _short_bottleneck_net(pkg, models):
    """The bottleneck path at a depth whose grads are well conditioned:
    the 7x7 stem, the max pool, one bottleneck with a 64 -> 256 channel
    1x1 shortcut and one with a strided 1x1 shortcut, the global pool and
    the fc, from the models' own conv_bn / bottleneck / _layer_warp."""
    img = pkg.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    x = models.conv_bn(img, 64, 7, 2, 3)
    x = pkg.layers.pool2d(input=x, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="max")
    x = models._layer_warp(models.bottleneck, x, 64, 1, 1)
    x = models._layer_warp(models.bottleneck, x, 128, 1, 2)
    x = pkg.layers.pool2d(input=x, pool_type="avg", global_pooling=True)
    logits = pkg.layers.fc(input=x, size=10)
    return pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
        logits=logits, label=label))


_NETS = {
    "bottleneck2": _short_bottleneck_net,
    "cifar8": lambda pkg, models: models.build(dataset="cifar10",
                                               depth=8)[0],
    "bottleneck50": _bottleneck_net,
    "imagenet50": lambda pkg, models: models.build(dataset="imagenet",
                                                   fused_loss=True)[0],
}


def _jax_build(net, use_amp):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), jun.guard():
        loss = _NETS[net](fluid, JR)
        flipped = (jamp.cast_model_to_bf16(main, startup) if use_amp
                   else set())
        _, pg = fluid.optimizer.Momentum(
            learning_rate=LR, momentum=MU,
            multi_precision=use_amp).minimize(loss)
    return main, startup, loss, pg, flipped


def _port_build(net, use_amp):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = _NETS[net](pt, PR)
        flipped = (pamp.cast_model_to_bf16(main, startup) if use_amp
                   else set())
        _, pg = pt.optimizer.Momentum(
            learning_rate=LR, momentum=MU,
            multi_precision=use_amp).minimize(loss)
    return main, startup, loss, pg, flipped


@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("net", ["cifar8", "imagenet50"])
def test_resnet_programs_are_identical(net, use_amp):
    """After Momentum.minimize: the same main and startup programs, op for
    op and var for var, the same (param, grad) pairs and the same AMP
    flips (BN statistics stay float32)."""
    jm, js, _, jpg, jflipped = _jax_build(net, use_amp)
    pm, ps, _, ppg, pflipped = _port_build(net, use_amp)
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
    if net == "imagenet50":
        types = [op.type for op in pm.global_block().ops]
        assert types.count("conv2d") == 53
        assert types.count("batch_norm_grad") == 53
        assert types.count("momentum") == 161


# ------------------------------------------------------------- end to end

def _feed(net, batch, seed=11):
    rng = np.random.RandomState(seed)
    hw = _HW[net]
    return {"img": rng.randn(batch, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


def _jax_feed(main, feed):
    """The feed in the JAX program's declared dtypes (img is bfloat16
    under AMP)."""
    out = dict(feed)
    if main.global_block().var("img").dtype == "bfloat16":
        out["img"] = np.asarray(jnp.asarray(feed["img"], jnp.bfloat16))
    return out


def _jax_train(net, use_amp, steps):
    main, startup, loss, pg, _ = _jax_build(net, use_amp)
    scope = JScope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable}
    grads = [g.name for _, g in pg]
    feed = _jax_feed(main, _feed(net, _BATCH[net]))
    losses, first = [], None
    for step in range(steps):
        outs = exe.run(main, feed=feed, scope=scope,
                       fetch_list=[loss.name] + (grads if not step else []))
        losses.append(float(np.asarray(outs[0], np.float32).ravel()[0]))
        if not step:
            first = {n: np.asarray(o, np.float32)
                     for n, o in zip(grads, outs[1:])}
    return dict(params=params, losses=losses, grads=first)


def _port_train(jrun, net, use_amp, steps):
    main, _, loss, pg, _ = _port_build(net, use_amp)
    scope = pt.Scope()
    convert.load_params(scope, jrun["params"], pt.CPUPlace(), [main])
    exe = pt.Executor(pt.CPUPlace())
    grads = [g.name for _, g in pg]
    feed = _feed(net, _BATCH[net])
    losses, first = [], None
    for step in range(steps):
        outs = exe.run(main, feed=feed, scope=scope,
                       fetch_list=[loss] + (grads if not step else []))
        losses.append(float(outs[0].ravel()[0]))
        if not step:
            first = dict(zip(grads, outs[1:]))
    return dict(losses=losses, grads=first, scope=scope, main=main)


@pytest.fixture(scope="module", params=["cifar8", "bottleneck2"])
def jax_f32(request):
    return request.param, _jax_train(request.param, False, STEPS)


def test_resnet_grads_and_momentum_losses_match_jax(jax_f32):
    """One backward: every param@GRAD within rtol 1e-4 / atol 1e-5 of the
    JAX package's (conv filters through the hand-written conv grad, BN
    scale/bias through batch_norm_grad, the stem through the max pool's
    grad); three Momentum steps: losses within rtol 2e-4."""
    net, ref = jax_f32
    port = _port_train(ref, net, False, STEPS)
    assert sorted(port["grads"]) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(port["grads"][name], want, rtol=1e-4,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=2e-4)
    assert port["losses"][-1] < port["losses"][0]


def test_resnet50_bottleneck_step_matches_jax():
    """resnet_imagenet(depth=50) end to end (all 16 bottlenecks): the same
    grads (names, shapes, finite) and the step-1 loss within rtol 2e-4.
    Its grads are not compared value for value: at this size and a random
    init they are ill conditioned in float32, in either package (a 1e-7
    relative perturbation of the image moves the port's own grads by up
    to 7%); the two-bottleneck net above holds them at rtol 1e-4."""
    ref = _jax_train("bottleneck50", False, 1)
    port = _port_train(ref, "bottleneck50", False, 1)
    assert sorted(port["grads"]) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        got = port["grads"][name]
        assert got.shape == want.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=2e-4)


@pytest.mark.parametrize("net", ["cifar8", "bottleneck2"])
def test_resnet_amp_step_matches_jax(net):
    """bf16 AMP with Momentum(multi_precision): the step-1 loss within
    2e-2 relative; the BN running stats, velocities and master weights
    stay float32 in the port's scope, the filters bfloat16."""
    ref = _jax_train(net, True, 1)
    port = _port_train(ref, net, True, 1)
    assert abs(port["losses"][0] - ref["losses"][0]) <= \
        2e-2 * abs(ref["losses"][0])
    scope, main = port["scope"], port["main"]
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            for p in ("Mean", "Variance"):
                v = scope.find_var(op.input(p)[0])
                assert v.dtype == torch.float32, op.input(p)
            assert scope.find_var(op.input("Scale")[0]).dtype == \
                torch.bfloat16
        if op.type == "momentum":
            assert scope.find_var(op.input("Velocity")[0]).dtype == \
                torch.float32
            assert scope.find_var(op.input("MasterParam")[0]).dtype == \
                torch.float32
        if op.type == "conv2d":
            assert scope.find_var(op.input("Filter")[0]).dtype == \
                torch.bfloat16
