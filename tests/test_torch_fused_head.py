"""The fused loss head (paddle_tpu_torch/ops/loss_ops.py linear_softmax_ce,
layers.fused_linear_cross_entropy, and the `fused_head` paths of
models/bert.py and models/transformer.py) against the JAX package.

The op and its hand-written grad run in both registries on the same numpy
inputs (N 64, d 16, V 50; 1, 4 and 8 chunks; label smoothing 0 and 0.1;
an ignore_index some labels hit; W as [d, V] and as the tied [V, d]):
Loss, dX and dW within rtol 1e-5 / atol 1e-6.  Inside the port the fused
op equals `mul` + `softmax_with_cross_entropy` and autograd through them
(1e-5).  End to end, bert.tiny() and transformer.tiny() build the JAX
package's programs with fused_head=True and, from the JAX startup's
weights, train 3 Adam steps to its losses within rtol 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import bert as JB
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.models import bert as PB
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import registry as preg

N, D, V = 64, 16, 50
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _inputs(transpose_w, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal((V, D) if transpose_w else (D, V)).astype(
        np.float32) * 0.5
    lab = rng.randint(0, V, (N, 1)).astype(np.int64)
    lab[::7, 0] = 0                      # rows ignore_index=0 masks
    dloss = rng.random_sample((N, 1)).astype(np.float32)
    return x, w, lab, dloss


def _run(reg, jax_side, op_type, inputs, attrs, out_names):
    info = reg.get_runtime_info(op_type)
    if jax_side:
        outs = reg.run_forward(
            info, {k: [jnp.asarray(a) for a in v] for k, v in inputs.items()},
            dict(attrs), out_names=out_names)
        return {k: np.asarray(v[0]) for k, v in outs.items()}
    outs = reg.run_forward(
        info, {k: [torch.as_tensor(a) for a in v] for k, v in inputs.items()},
        dict(attrs), out_names=out_names, device=CPU)
    return {k: v[0].numpy() for k, v in outs.items()}


def _both(op_type, inputs, attrs, out_names):
    j = _run(jreg, True, op_type, inputs, attrs, out_names)
    p = _run(preg, False, op_type, inputs, attrs, out_names)
    assert sorted(p) == sorted(j)
    for name in j:
        assert p[name].shape == j[name].shape, name
        np.testing.assert_allclose(p[name], j[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    return p


@pytest.mark.parametrize("transpose_w", [False, True], ids=["dV", "tied"])
@pytest.mark.parametrize("eps,ignore", [(0.0, 0), (0.1, 0), (0.1, -100)],
                         ids=["eps0_ignore0", "eps0.1_ignore0",
                              "eps0.1_no_ignore"])
@pytest.mark.parametrize("chunks", [1, 4, 8])
def test_linear_softmax_ce_and_grad_match_jax(chunks, eps, ignore,
                                              transpose_w):
    x, w, lab, dloss = _inputs(transpose_w)
    attrs = {"label_smooth_eps": eps, "ignore_index": ignore,
             "chunks": chunks, "transpose_w": transpose_w}
    fwd = _both("linear_softmax_ce", {"X": [x], "W": [w], "Label": [lab]},
                attrs, {"Loss": ["loss"]})
    assert fwd["Loss"].dtype == np.float32 and fwd["Loss"].shape == (N, 1)
    if ignore == 0:
        assert np.all(fwd["Loss"][::7] == 0.0)
    _both("linear_softmax_ce_grad",
          {"X": [x], "W": [w], "Label": [lab], "Loss@GRAD": [dloss]},
          attrs, {"X@GRAD": ["x@GRAD"], "W@GRAD": ["w@GRAD"]})


@pytest.mark.parametrize("transpose_w", [False, True], ids=["dV", "tied"])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_equals_mul_and_softmax_with_cross_entropy(eps, transpose_w):
    """Inside the port: Loss, dX and dW of the fused op against the
    unfused ops' lowerings and autograd through them."""
    x, w, lab, dloss = (torch.as_tensor(a) for a in _inputs(transpose_w, 1))
    attrs = {"label_smooth_eps": eps, "ignore_index": 0, "chunks": 4,
             "transpose_w": transpose_w}
    fused = preg.run_forward(
        preg.get_runtime_info("linear_softmax_ce"),
        {"X": [x], "W": [w], "Label": [lab]}, attrs,
        out_names={"Loss": ["l"]}, device=CPU)["Loss"][0]
    grads = preg.run_forward(
        preg.get_runtime_info("linear_softmax_ce_grad"),
        {"X": [x], "W": [w], "Label": [lab], "Loss@GRAD": [dloss]}, attrs,
        out_names={"X@GRAD": ["dx"], "W@GRAD": ["dw"]}, device=CPU)
    xl, wl = (t.clone().requires_grad_(True) for t in (x, w))
    with torch.enable_grad():
        logits = preg.run_forward(
            preg.get_op_info("mul"),
            {"X": [xl], "Y": [wl.t() if transpose_w else wl]}, {},
            device=CPU)["Out"][0]
        loss = preg.run_forward(
            preg.get_op_info("softmax_with_cross_entropy"),
            {"Logits": [logits], "Label": [lab]},
            {"label_smooth_eps": eps, "ignore_index": 0},
            device=CPU)["Loss"][0]
        dx, dw = torch.autograd.grad(loss, (xl, wl), dloss)
    torch.testing.assert_close(fused, loss.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads["X@GRAD"][0], dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads["W@GRAD"][0], dw, rtol=1e-5, atol=1e-5)


def test_fused_linear_cross_entropy_layer_checks():
    """The JAX layer's checks: a weight of the wrong shape, and param_attr
    beside an existing weight, raise."""
    x = pt.layers.data("x", shape=[D], dtype="float32")
    lab = pt.layers.data("lab", shape=[1], dtype="int64")
    w = pt.layers.create_parameter([V, D], "float32", name="emb")
    with pytest.raises(ValueError, match="weight shape"):
        pt.layers.fused_linear_cross_entropy(x, lab, V, weight=w)
    with pytest.raises(ValueError, match="param_attr"):
        pt.layers.fused_linear_cross_entropy(
            x, lab, V, weight=w, transpose_w=True,
            param_attr=pt.ParamAttr(name="other"))
    loss = pt.layers.fused_linear_cross_entropy(x, lab, V, weight=w,
                                                transpose_w=True)
    assert loss.shape == (-1, 1)


# ------------------------------------------------------------- end to end


def _normalized(prog):
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _models(kind):
    if kind == "bert":
        return (lambda: JB.build(JB.tiny(), fused_head=True)[0],
                lambda: PB.build(PB.tiny(), fused_head=True)[0],
                JB.synthetic_batch(4, JB.tiny(), seed=2))
    cfg = dict(src_vocab_size=40, trg_vocab_size=40, n_layer=1, n_head=2,
               d_model=32, d_inner=64, dropout=0.0, max_length=12)
    return (lambda: JT.build(JT.TransformerConfig(**cfg),
                             fused_head=True)[0],
            lambda: PT.build(PT.TransformerConfig(**cfg),
                             fused_head=True)[0],
            JT.synthetic_batch(4, JT.TransformerConfig(**cfg), seed=2))


@pytest.mark.parametrize("kind", ["bert", "transformer"])
def test_fused_head_trains_to_the_jax_losses(kind):
    jbuild, pbuild, feed = _models(kind)
    jm, js = fluid.Program(), fluid.Program()
    with fluid.program_guard(jm, js), jun.guard():
        jloss = jbuild()
        fluid.optimizer.Adam(1e-3).minimize(jloss)
    pm, ps = pt.Program(), pt.Program()
    with pt.program_guard(pm, ps), pt.unique_name.guard():
        ploss = pbuild()
        pt.optimizer.Adam(1e-3).minimize(ploss)
    assert _normalized(pm) == _normalized(jm)
    assert [op.type for op in pm.global_block().ops].count(
        "linear_softmax_ce_grad") == 1
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jm.list_vars() if v.persistable}
    scope = pt.Scope()
    convert.load_params(scope, params, pt.CPUPlace(), [pm])
    pexe = pt.Executor(pt.CPUPlace())
    want, got = [], []
    for _ in range(3):
        (lj,) = jexe.run(jm, feed=feed, fetch_list=[jloss.name],
                         scope=jscope)
        (lp,) = pexe.run(pm, feed=feed, fetch_list=[ploss], scope=scope)
        want.append(float(np.asarray(lj).ravel()[0]))
        got.append(float(lp.ravel()[0]))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
