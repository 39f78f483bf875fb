"""VGG and AlexNet (models/vgg.py, models/alexnet.py, nets.py, the `lrn`
and `fc` ops) against the JAX package.

`lrn` against the JAX lowering (rtol 1e-5) and its grad (the registry's
generic replay on both sides, rtol 1e-4); `fc`, the op the inference
transpiler's fc_fuse emits, in float32 (rtol 1e-5) and bfloat16 (2e-2,
both round the float32 product to bfloat16); `nets.img_conv_group` and
`build()` + Momentum of VGG-16, VGG-19 and AlexNet give the JAX package's
Program dicts.  From the JAX startup's weights (VGG at 32x32, AlexNet at
64x64, batch 2, 10 classes): the `clone(for_test=True)` forward within
rtol 1e-5 of the largest output, and 3 Momentum(1e-5, 0.9) losses at
batch 4 within rtol 2e-4 with both packages' dropout drawing the same masks
(`testing.seeded_dropout`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_reference import XLA_DEFAULT_LEVEL, jit_at_level

import paddle_tpu as fluid
from paddle_tpu import nets as jnets
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import alexnet as JA
from paddle_tpu.models import vgg as JV
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, nets as pnets, testing
from paddle_tpu_torch.models import alexnet as PA
from paddle_tpu_torch.models import vgg as PV
from paddle_tpu_torch.ops import registry as preg

CLASSES, BATCH, STEPS = 10, 2, 3
# the training steps' batch and learning rate, where 3 float32 steps are
# well conditioned.  At batch 2, VGG's batch norm after its first fc
# normalises 2 values a channel, and a 1e-7 relative change of the images
# moves the port's own second and third Momentum(0.01) losses by 2e-3 and
# 0.15.  At batch 4 the third loss still moves by 1.4e-3 (VGG-16, lr 0.01)
# and 9e-3 (VGG-19, lr 1e-3); at lr 1e-4 the JAX reference's own third
# VGG-19 loss moves by 2.5e-4 between this suite's XLA flags and none.  At
# lr 1e-5 (phase R1's rate) the losses still fall (VGG-16 2.28, 2.08, 1.80)
# and the port is within 3.4e-6 of the reference
TRAIN_BATCH, LR = 4, 1e-5


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _run(reg, backend, op_type, inputs, attrs, out_names, dtype=None):
    info = reg.get_runtime_info(op_type)
    if backend == "jax":
        ins = {p: [None if a is None else jnp.asarray(a, dtype=dtype)
                   for a in v] for p, v in inputs.items()}
        outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names)
        return {p: [None if o is None else np.asarray(o, np.float32)
                    for o in v] for p, v in outs.items()}
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else None
    ins = {p: [None if a is None else torch.as_tensor(np.array(a)).to(
               tdtype or torch.float32) for a in v]
           for p, v in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names,
                           device=torch.device("cpu"))
    return {p: [None if o is None else o.float().numpy() for o in v]
            for p, v in outs.items()}


def _assert_same(op_type, inputs, attrs, out_names, rtol, dtype=None):
    j = _run(jreg, "jax", op_type, inputs, attrs, out_names, dtype)
    p = _run(preg, "torch", op_type, inputs, attrs, out_names, dtype)
    wanted = [k for k in out_names if any(o is not None for o in j.get(k,
                                                                      []))]
    assert wanted
    for param in wanted:
        for a, b in zip(j[param], p[param], strict=True):
            assert b.shape == a.shape, (param, b.shape, a.shape)
            np.testing.assert_allclose(b, a, rtol=rtol,
                                       atol=rtol * np.abs(a).max(),
                                       err_msg=f"{op_type}.{param}")
    return j


@pytest.mark.parametrize("n,hw", [(5, 6), (3, 5), (4, 3)])
def test_lrn_and_its_grad_match_jax(n, hw):
    """Odd and even windows over 7 channels (the edge windows are
    zero-padded); Out and MidOut, then the grad of Out."""
    rng = np.random.RandomState(n)
    x = rng.standard_normal((2, 7, hw, hw)).astype(np.float32) * 3
    attrs = {"n": n, "k": 2.0, "alpha": 1e-2, "beta": 0.75}
    j = _assert_same("lrn", {"X": [x]}, attrs,
                     {"Out": ["o"], "MidOut": ["m"]}, rtol=1e-5)
    gy = rng.standard_normal(j["Out"][0].shape).astype(np.float32)
    _assert_same("lrn_grad",
                 {"X": [x], "Out": j["Out"], "MidOut": j["MidOut"],
                  "Out@GRAD": [gy], "MidOut@GRAD": [None]},
                 attrs, {"X@GRAD": ["x@GRAD"]}, rtol=1e-4)


@pytest.mark.parametrize("dtype,rtol", [(None, 1e-5), (jnp.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("x_shape,ncd", [((4, 12), 1), ((2, 3, 12), 2),
                                         ((2, 3, 2, 2), 1)])
def test_fc_matches_jax(x_shape, ncd, dtype, rtol):
    rng = np.random.RandomState(len(x_shape))
    k = int(np.prod(x_shape[ncd:]))
    inputs = {"Input": [rng.standard_normal(x_shape).astype(np.float32)],
              "W": [rng.standard_normal((k, 5)).astype(np.float32)],
              "Bias": [rng.standard_normal(5).astype(np.float32)]}
    j = _assert_same("fc", inputs, {"in_num_col_dims": ncd},
                     {"Out": ["o"]}, rtol=rtol, dtype=dtype)
    assert j["Out"][0].shape == tuple(x_shape[:ncd]) + (5,)


def _normalized(prog):
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _assert_same_program(jprog, pprog):
    jd, pd = _normalized(jprog), _normalized(pprog)
    jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in pops] == [o["type"] for o in jops]
    for jo, po in zip(jops, pops):
        assert po == jo, jo["type"]
    assert pd == jd


def test_img_conv_group_builds_the_jax_program():
    """Per-conv lists (filter sizes, paddings, batch norm on some convs, a
    dropout after one) and a strided average pool."""
    progs = []
    for pkg, nets, guard in ((fluid, jnets, jun.guard),
                             (pt, pnets, pt.unique_name.guard)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            img = pkg.layers.data(name="img", shape=[3, 12, 12],
                                  dtype="float32")
            out = nets.img_conv_group(
                input=img, conv_num_filter=[4, 6, 8], pool_size=2,
                conv_padding=[1, 0, 1], conv_filter_size=[3, 1, 3],
                conv_act="relu", conv_with_batchnorm=[True, False, True],
                conv_batchnorm_drop_rate=[0.0, 0.0, 0.3], pool_stride=2,
                pool_type="avg")
            out = nets.simple_img_conv_pool(
                input=out, num_filters=5, filter_size=3, pool_size=2,
                pool_stride=1, act="relu")
        progs.append((main, startup, out))
    (jm, js, jout), (pm, ps, pout) = progs
    _assert_same_program(jm, pm)
    _assert_same_program(js, ps)
    assert pout.shape == jout.shape == (-1, 5, 3, 3)


# ---------------------------------------------------------------- models


MODELS = {
    "vgg16": (JV, PV, dict(image_shape=(3, 32, 32), class_dim=CLASSES,
                           depth=16)),
    "vgg19": (JV, PV, dict(image_shape=(3, 32, 32), class_dim=CLASSES,
                           depth=19)),
    "alexnet": (JA, PA, dict(image_shape=(3, 64, 64), class_dim=CLASSES)),
}


def _build(pkg, model, kwargs, guard):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.program_guard(main, startup), guard():
        loss, prob, _ = model.build(**kwargs)
        pkg.optimizer.Momentum(learning_rate=LR,
                               momentum=0.9).minimize(loss)
    return main, startup, loss, prob


@pytest.fixture(scope="module", params=sorted(MODELS))
def both(request):
    """Both builds of one model and the JAX startup's persistables."""
    jmod, pmod, kwargs = MODELS[request.param]
    with testing.fresh_programs():
        j = _build(fluid, jmod, kwargs, jun.guard)
        p = _build(pt, pmod, kwargs, pt.unique_name.guard)
    jscope = JScope()
    fluid.Executor(fluid.CPUPlace()).run(j[1], scope=jscope)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    return request.param, kwargs, j, p, params


def _feed(kwargs, seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    return {"img": rng.standard_normal(
                (batch,) + tuple(kwargs["image_shape"])).astype(np.float32),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}


def _scopes(j, p, params):
    jscope = JScope()
    for n, v in params.items():
        jscope.set_var(n, jnp.asarray(v))
    pscope = pt.Scope()
    convert.load_params(pscope, params, pt.CPUPlace(), [p[0]])
    return jscope, pscope


def test_programs_are_identical(both):
    name, _, (jm, js, *_), (pm, ps, *_), _ = both
    _assert_same_program(jm, pm)
    _assert_same_program(js, ps)
    ops = [op.type for op in pm.global_block().ops]
    if name == "alexnet":
        assert ops.count("lrn") == 2 and ops.count("dropout") == 2
    else:
        assert ops.count("conv2d") == (13 if name == "vgg16" else 16)
        assert ops.count("batch_norm") == ops.count("conv2d") + 1


def test_for_test_forward_matches_jax(both):
    """clone(for_test=True): the probabilities and the loss within rtol
    1e-5 of their largest magnitude."""
    _, kwargs, j, p, params = both
    jscope, pscope = _scopes(j, p, params)
    jt, ptest = j[0].clone(for_test=True), p[0].clone(for_test=True)
    feed = _feed(kwargs)
    jouts = fluid.Executor(fluid.CPUPlace()).run(
        jt, feed=feed, fetch_list=[j[2].name, j[3].name], scope=jscope)
    pouts = pt.Executor(pt.CPUPlace()).run(
        ptest, feed=feed, fetch_list=[p[2], p[3]], scope=pscope)
    for a, b in zip(jouts, pouts):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max())


def test_momentum_losses_match_jax_with_carried_masks(both, monkeypatch):
    """3 Momentum(LR, 0.9) steps on one batch of TRAIN_BATCH, both
    packages' dropout drawing the same masks: every loss within rtol
    2e-4.  The JAX steps compile at XLA's default backend level: at the
    suite's level 0 its VGG-16 conv filter grads move by up to 18% of
    their largest magnitude from the default level's (2x2 maps under batch
    norm: sums that cancel), and its second loss by 2e-3, while the port's
    grads agree with the default level's within 1e-4 and its own losses
    move by 2e-5 under a 1e-7 relative change of the images."""
    _, kwargs, j, p, params = both
    for reg, as_array in (
            (jreg, lambda k, x: jnp.asarray(k, dtype=x.dtype)),
            (preg, lambda k, x: torch.as_tensor(k).to(x.device, x.dtype))):
        info = reg.OPS["dropout"]
        monkeypatch.setattr(info, "forward",
                            testing.seeded_dropout(info.forward, as_array))
    jscope, pscope = _scopes(j, p, params)
    feed = _feed(kwargs, seed=1, batch=TRAIN_BATCH)
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jl, pl = [], []
    for _ in range(STEPS):
        with jit_at_level(XLA_DEFAULT_LEVEL):
            jl.append(float(np.asarray(jexe.run(
                j[0], feed=feed, fetch_list=[j[2].name],
                scope=jscope)[0]).ravel()[0]))
        pl.append(float(pexe.run(p[0], feed=feed, fetch_list=[p[2]],
                                 scope=pscope)[0].ravel()[0]))
    assert np.all(np.isfinite(pl)) and pl[-1] != pl[0]
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
