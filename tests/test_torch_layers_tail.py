"""The new layer builders, initializers and nets against the JAX
package's, and a primitive-level encoder trained in both.

- Every builder of the slice (layers/nn.py, layers/tensor.py,
  layers/ops.py, nets.glu, nets.scaled_dot_product_attention) emits the
  JAX builder's program for the same call, main and startup: op types,
  attrs, variable names, shapes and dtypes, compared through `to_dict`
  (integer dtypes as one kind, float64 as float32: the JAX package's
  shape inference narrows both with x64 off).  TruncatedNormal, MSRA and
  Bilinear put the JAX package's ops in the startup program; Bilinear's
  values equal the JAX package's.
- `from paddle_tpu_torch.layers import *` gives what the JAX package's
  gives but for the builders of the families still to port.
- `models/fluid_encoder.py` at 2 layers, d_model 64: the same program
  from both packages' builders, 3 Adam steps from the JAX startup's
  weights (`convert.load_params`), losses within rtol 2e-4.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.layers as jlayers
import paddle_tpu.nets as jnets
import paddle_tpu_torch as pt
import paddle_tpu_torch.layers as players
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.models import fluid_encoder
from torch_op_parity import BOTH, assert_same_program


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _img(pkg):
    return pkg.layers.data(name="img", shape=[4, 6, 6], dtype="float32")


def _vec(pkg, name="x", width=8, dtype="float32"):
    return pkg.layers.data(name=name, shape=[width], dtype=dtype)


def _seq(pkg):
    return pkg.layers.data(name="q", shape=[5, 16], dtype="float32")


# id -> fn(pkg) appending the builder's ops
BUILDERS = {
    "mul": lambda pkg: pkg.layers.mul(
        _vec(pkg), pkg.layers.create_parameter([8, 3], "float32", name="w")),
    "squeeze": lambda pkg: pkg.layers.squeeze(
        pkg.layers.data(name="x", shape=[1, 4, 1], dtype="float32"), [1, 3]),
    "unsqueeze": lambda pkg: pkg.layers.unsqueeze(_vec(pkg), [0, 2]),
    "transpose": lambda pkg: pkg.layers.transpose(_img(pkg), [0, 2, 3, 1]),
    "split_num": lambda pkg: pkg.layers.split(_img(pkg), 2, dim=1),
    "split_sections": lambda pkg: pkg.layers.split(_img(pkg), [1, 2, 3],
                                                   dim=-1),
    "stack": lambda pkg: pkg.layers.stack([_vec(pkg), _vec(pkg, "y")],
                                          axis=1),
    "unstack": lambda pkg: pkg.layers.unstack(_img(pkg), axis=1),
    "expand": lambda pkg: pkg.layers.expand(_vec(pkg), [2, 3]),
    "pad": lambda pkg: pkg.layers.pad(_vec(pkg), [0, 1, 2, 3], 0.5),
    "pad2d": lambda pkg: pkg.layers.pad2d(_img(pkg), [1, 0, 2, 1],
                                          mode="reflect"),
    "shape": lambda pkg: pkg.layers.shape(_img(pkg)),
    "scatter": lambda pkg: pkg.layers.scatter(
        pkg.layers.data(name="x", shape=[6, 8], dtype="float32",
                        append_batch_size=False),
        pkg.layers.data(name="ids", shape=[2], dtype="int64",
                        append_batch_size=False),
        pkg.layers.data(name="u", shape=[2, 8], dtype="float32",
                        append_batch_size=False)),
    "l2_normalize": lambda pkg: pkg.layers.l2_normalize(_img(pkg), axis=1),
    "label_smooth": lambda pkg: pkg.layers.label_smooth(_vec(pkg),
                                                        epsilon=0.2),
    "smooth_l1": lambda pkg: pkg.layers.smooth_l1(
        _vec(pkg), _vec(pkg, "y"), inside_weight=_vec(pkg, "w"), sigma=3.0),
    "cos_sim": lambda pkg: pkg.layers.cos_sim(_vec(pkg), _vec(pkg, "y")),
    "dot_product_attention": lambda pkg: pkg.layers.dot_product_attention(
        _seq(pkg), _seq(pkg), _seq(pkg)),
    "image_resize": lambda pkg: pkg.layers.image_resize(_img(pkg),
                                                        scale=1.5),
    "resize_bilinear": lambda pkg: pkg.layers.resize_bilinear(
        _img(pkg), out_shape=[3, 9]),
    "resize_nearest": lambda pkg: pkg.layers.resize_nearest(
        _img(pkg), out_shape=[12, 12]),
    "conv2d_transpose": lambda pkg: pkg.layers.conv2d_transpose(
        _img(pkg), num_filters=6, filter_size=3, stride=2, padding=1,
        groups=2, act="relu"),
    "conv2d_transpose_output_size": lambda pkg: pkg.layers.conv2d_transpose(
        _img(pkg), num_filters=3, output_size=[13, 13], stride=2,
        param_attr=pkg.ParamAttr(initializer=pkg.initializer.Bilinear())),
    "im2sequence": lambda pkg: pkg.layers.im2sequence(
        _img(pkg), filter_size=[2, 3], stride=[1, 2], padding=1),
    "auc": lambda pkg: pkg.layers.auc(
        pkg.layers.data(name="p", shape=[2], dtype="float32"),
        pkg.layers.data(name="l", shape=[1], dtype="int64"),
        num_thresholds=63),
    "chunk_eval": lambda pkg: pkg.layers.chunk_eval(
        _vec(pkg, "i", 7, "int64"), _vec(pkg, "l", 7, "int64"), "IOE", 3,
        excluded_chunk_types=[1]),
    "create_tensor": lambda pkg: pkg.layers.create_tensor("float32",
                                                          name="t"),
    "ones_zeros": lambda pkg: (pkg.layers.ones([2, 3], "float32"),
                               pkg.layers.zeros([4], "int64")),
    "zeros_like": lambda pkg: pkg.layers.zeros_like(_img(pkg)),
    "arg": lambda pkg: (pkg.layers.argmax(_img(pkg), axis=1),
                        pkg.layers.argmin(_vec(pkg), axis=-1),
                        pkg.layers.argsort(_vec(pkg, "y"))),
    "reverse": lambda pkg: pkg.layers.reverse(_img(pkg), [1, 3]),
    "overflow": lambda pkg: (pkg.layers.has_inf(_vec(pkg)),
                             pkg.layers.has_nan(_vec(pkg)),
                             pkg.layers.isfinite(_vec(pkg))),
    "range": lambda pkg: pkg.layers.tensor.range(
        0, pkg.layers.fill_constant([1], "int64", 7), 2, "int64"),
    "cumsum": lambda pkg: pkg.layers.cumsum(_vec(pkg), axis=1,
                                            exclusive=True, reverse=True),
    "random": lambda pkg: (pkg.layers.uniform_random([3, 4], min=0.0),
                           pkg.layers.gaussian_random([5], std=0.5),
                           pkg.layers.sampling_id(pkg.layers.softmax(
                               _vec(pkg)))),
    "glu": lambda pkg: pkg.nets.glu(_img(pkg), dim=1),
    "scaled_dot_product_attention":
        lambda pkg: pkg.nets.scaled_dot_product_attention(
            _seq(pkg), _seq(pkg), _seq(pkg), num_heads=4),
    "initializers": lambda pkg: [
        pkg.layers.create_parameter(
            [4, 3, 2, 2], "float32", name=f"w_{kind}",
            default_initializer=init)
        for kind, init in (
            ("tn", pkg.initializer.TruncatedNormal(0.5, 0.1)),
            ("msra_u", pkg.initializer.MSRA()),
            ("msra_n", pkg.initializer.MSRA(uniform=False, fan_in=7)),
            ("bilinear", pkg.initializer.Bilinear()))],
}


def _build(pkg, guard, fn):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        fn(pkg)
    return main, startup


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_builder_emits_the_jax_program(case):
    (jm, js), (pm, ps) = (_build(pkg, guard, BUILDERS[case])
                          for pkg, guard in BOTH)
    assert pm.global_block().vars
    assert_same_program(jm, pm)
    assert_same_program(js, ps)


def test_bilinear_initializer_values_are_the_jax_packages():
    (_, js), (_, ps) = (_build(pkg, guard, BUILDERS["initializers"])
                        for pkg, guard in BOTH)
    j_op, p_op = (next(o for o in prog.global_block().ops
                       if o.type == "assign_value")
                  for prog in (js, ps))
    assert p_op.attrs["values"] == j_op.attrs["values"]
    assert max(p_op.attrs["values"]) > 0


# the JAX package's public builders of the families still to port
# (ROADMAP A items 7-8): Print, detection, the reader
STILL_TO_PORT = {
    "Print", "anchor_generator",
    "bipartite_match", "box_coder", "detection", "detection_map",
    "detection_output", "generate_proposal_labels", "generate_proposals",
    "iou_similarity", "mine_hard_examples", "multiclass_nms", "prior_box",
    "roi_align", "roi_pool", "rpn_target_assign", "ssd_loss",
    "target_assign", "py_reader", "read_file",
}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_the_layers_namespace_is_the_jax_packages_but_items_6_to_8():
    missing = _public(jlayers) - _public(players)
    assert missing == STILL_TO_PORT
    star = {}
    exec("from paddle_tpu_torch.layers import *", star)
    jstar = {}
    exec("from paddle_tpu.layers import *", jstar)
    assert set(jstar) - set(star) - {"__builtins__"} <= STILL_TO_PORT
    for name in ("transpose", "split", "argmax", "cumsum", "auc",
                 "conv2d_transpose", "zeros_like", "image_resize"):
        assert name in star, name


def test_the_nets_are_the_jax_packages_but_sequence_conv_pool():
    assert _public(jnets) - _public(pt.nets) == set()


# ------------------------------------------------- the primitive encoder


def _encoder(pkg, guard, cfg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        loss, outs = fluid_encoder.build(cfg, layers=pkg.layers,
                                         nets=pkg.nets)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, outs


def test_encoder_trains_as_the_jax_package():
    cfg = fluid_encoder.tiny()
    jm, js, jloss, jouts = _encoder(fluid, jun.guard, cfg)
    pm, ps, ploss, pouts = _encoder(pt, pt.unique_name.guard, cfg)
    assert_same_program(jm, pm)
    assert_same_program(js, ps)
    types = {o.type for o in pm.global_block().ops}
    assert {"transpose", "split", "arg_max", "layer_norm", "matmul",
            "softmax", "reshape"} <= types
    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    pscope = pt.Scope()
    convert.load_params(pscope, {
        v.name: np.asarray(jscope.find_var(v.name))
        for v in jm.list_vars() if v.persistable}, pt.CPUPlace(), [pm])
    pexe = pt.Executor(pt.CPUPlace())
    fetch = [jloss.name, jouts["pred"].name, jouts["acc"].name]
    for step in range(3):
        feed = fluid_encoder.synthetic_batch(4, cfg, seed=step)
        want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        got = pexe.run(pm, feed=feed, fetch_list=fetch, scope=pscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=2e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-6)
