"""The misc and nn op tails (ops/misc_ops.py, ops/nn_ops.py) against the
JAX package's lowerings.

- Every new op type through both registries on the same inputs (the JAX
  package's own OpTest cases where it has them: tests/test_ops_misc.py,
  test_ops_misc_tail.py, test_ops_nn.py) and seeded ones: float32 at atol
  1e-5, integer and bool outputs exact.
- The resizes are `jax.image.resize`'s (half-pixel centres; a bilinear
  downscale antialiased): an upscale and a downscale in each of H and W,
  and a size that stays.
- conv2d_transpose with groups > 1, dilation and asymmetric strides and
  paddings; conv3d, conv3d_transpose, depthwise_conv2d_transpose, pool3d
  and max_pool3d_with_index on small volumes.
- The differentiable ops' grads through both packages' `append_backward`
  (rtol 1e-4 / atol 1e-5), the convolutions' by their hand-written
  `convolution_backward` lowering.
- max_pool2d_with_index / max_pool3d_with_index: the JAX package cannot
  differentiate them (ROADMAP C), so X's grad is held to its max
  pool2d / pool3d grad over the same windows.
- random_crop cannot match jax.random (ROADMAP C2): its output is a
  window of its input at an offset in range.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
import test_ops_misc as jmisc
import test_ops_misc_tail as jmisc_tail
import test_ops_nn as jnn
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu_torch import testing
from torch_op_parity import (
    _build_grad,
    assert_forward,
    assert_grads,
    optest_case,
)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


_R = np.random.RandomState(7)


def _f32(*shape):
    return _R.standard_normal(shape).astype(np.float32)


IMG = _f32(2, 4, 6, 7)
VOL = _f32(2, 3, 5, 6, 4)

OPTESTS = {
    "flatten": jmisc.TestFlatten, "flatten2": jmisc.TestFlatten2,
    "crop": jmisc.TestCrop, "multiplex": jmisc.TestMultiplex,
    "pad_constant_like": jmisc.TestPadConstantLike,
    "minus": jmisc.TestMinusL1Norm, "l1_norm": jmisc.TestL1Norm,
    "squared_l2_distance": jmisc.TestSquaredL2Distance,
    "modified_huber_loss": jmisc.TestModifiedHuberLoss,
    "mean_iou": jmisc.TestMeanIou, "affine_channel": jmisc.TestAffineChannel,
    "bilinear_tensor_product": jmisc.TestBilinearTensorProduct,
    "row_conv": jmisc.TestRowConv, "ctc_align": jmisc.TestCtcAlign,
    "max_pool2d_with_index": jmisc.TestMaxPoolWithIndexUnpool,
    "unpool": jmisc.TestUnpool, "spp": jmisc.TestSpp,
    "conv3d_transpose": jmisc.TestConv3dTranspose,
    "is_empty": jmisc.TestIsEmpty, "norm": jmisc_tail.TestNorm,
    "label_smooth": jmisc_tail.TestLabelSmooth,
    "cos_sim": jmisc_tail.TestCosSim,
    "conv2d_transpose": jnn.TestConv2dTranspose,
}


@pytest.mark.parametrize("case", sorted(OPTESTS))
def test_optest_cases_match_jax(case):
    cls = OPTESTS[case]
    inputs, attrs = optest_case(cls)
    assert_forward(cls.op_type, inputs, attrs, atol=1e-4 if "conv" in case
                   else 1e-5)


def _conv_t(groups, strides, pads, dilations, cin=4, cout_g=3, k=(3, 2)):
    return ("conv2d_transpose",
            {"Input": [_f32(2, cin, 5, 4)],
             "Filter": [_f32(cin, cout_g, *k)]},
            {"strides": strides, "paddings": pads, "dilations": dilations,
             "groups": groups})


FORWARD = {
    "conv2d_transpose_groups_dilation": _conv_t(2, [2, 3], [1, 0], [2, 1]),
    "conv2d_transpose_asym": _conv_t(1, [1, 2], [0, 1], [1, 1]),
    "depthwise_conv2d_transpose": (
        "depthwise_conv2d_transpose",
        {"Input": [_f32(2, 4, 5, 5)], "Filter": [_f32(4, 1, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 1], "groups": 4}),
    "conv3d": ("conv3d", {"Input": [VOL], "Filter": [_f32(4, 3, 3, 2, 3)]},
               {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                "dilations": [1, 1, 2], "groups": 1}),
    "conv3d_groups": ("conv3d",
                      {"Input": [_f32(1, 4, 4, 4, 4)],
                       "Filter": [_f32(6, 2, 2, 2, 2)]},
                      {"strides": [2, 2, 2], "paddings": [0, 0, 0],
                       "groups": 2}),
    "conv3d_transpose_groups": (
        "conv3d_transpose",
        {"Input": [_f32(1, 4, 3, 3, 2)], "Filter": [_f32(4, 2, 2, 3, 2)]},
        {"strides": [2, 1, 2], "paddings": [0, 1, 0], "groups": 2}),
    "pool3d_max": ("pool3d", {"X": [VOL]},
                   {"pooling_type": "max", "ksize": [2, 3, 2],
                    "strides": [2, 2, 1], "paddings": [1, 1, 0]}),
    "pool3d_avg": ("pool3d", {"X": [VOL]},
                   {"pooling_type": "avg", "ksize": [3, 3, 3],
                    "strides": [1, 2, 1], "paddings": [1, 1, 1]}),
    "pool3d_global": ("pool3d", {"X": [VOL]},
                      {"pooling_type": "avg", "global_pooling": True}),
    "max_pool2d_with_index_padded": (
        "max_pool2d_with_index", {"X": [IMG]},
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    "max_pool3d_with_index": (
        "max_pool3d_with_index", {"X": [VOL]},
        {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [1, 0, 1]}),
    "unpool_inferred_size": (
        "unpool", {"X": [_f32(1, 2, 2, 3)],
                   "Indices": [np.array([[[[0, 3, 5], [12, 14, 17]],
                                          [[6, 9, 11], [18, 21, 23]]]],
                                        np.int32)]},
        {"ksize": [2, 2], "strides": [2, 2]}),
    "spp_avg": ("spp", {"X": [IMG]}, {"pyramid_height": 3,
                                      "pooling_type": "avg"}),
    "spp_max": ("spp", {"X": [IMG]}, {"pyramid_height": 3,
                                      "pooling_type": "max"}),
    "group_norm": ("group_norm", {"X": [IMG], "Scale": [_f32(4)],
                                  "Bias": [_f32(4)]},
                   {"groups": 2, "epsilon": 1e-5}),
    "group_norm_3d": ("group_norm", {"X": [VOL]}, {"groups": 3}),
    "bilinear_up": ("bilinear_interp", {"X": [IMG]},
                    {"out_h": 11, "out_w": 16}),
    "bilinear_down": ("bilinear_interp", {"X": [IMG]},
                      {"out_h": 3, "out_w": 2}),
    "bilinear_mixed": ("bilinear_interp", {"X": [IMG]},
                       {"out_h": 6, "out_w": 4}),
    "nearest_up": ("nearest_interp", {"X": [IMG]}, {"out_h": 13,
                                                    "out_w": 9}),
    "nearest_down": ("nearest_interp", {"X": [IMG]}, {"out_h": 4,
                                                      "out_w": 3}),
    "im2sequence": ("im2sequence", {"X": [IMG]},
                    {"kernels": [3, 2], "strides": [2, 1],
                     "paddings": [1, 0, 0, 1]}),
    "norm_axis2": ("norm", {"X": [IMG]}, {"axis": 2, "epsilon": 1e-6}),
    "label_smooth_prior": ("label_smooth",
                           {"X": [_f32(3, 5)],
                            "PriorDist": [np.full((5,), 0.2, np.float32)]},
                           {"epsilon": 0.3}),
    "cos_sim_broadcast": ("cos_sim", {"X": [_f32(4, 6)], "Y": [_f32(1, 6)]},
                          {}),
    "crop_offsets_input": ("crop",
                           {"X": [IMG], "Y": [_f32(2, 2, 4, 3)],
                            "Offsets": [np.array([0, 1, 5, 2], np.int32)]},
                           {}),
    "is_empty_zero": ("is_empty", {"X": [np.zeros((0, 3), np.float32)]}, {}),
    "polygon_box_transform": ("polygon_box_transform", {"Input": [IMG]}, {}),
    "conv_shift": ("conv_shift", {"X": [_f32(3, 8)], "Y": [_f32(3, 5)]}, {}),
    "ctc_align_seqlen": ("ctc_align",
                         {"Input": [np.array([[0, 2, 2, 0, 3, 3, 1],
                                              [1, 1, 0, 0, 4, 4, 4]],
                                             np.int32)],
                          "SeqLen": [np.array([6, 5], np.int32)]},
                         {"blank": 0, "merge_repeated": True}),
    "mean_iou_streamed": ("mean_iou",
                          {"Predictions": [_R.randint(0, 4, (20,))],
                           "Labels": [_R.randint(0, 4, (20,))],
                           "InWrongs": [_R.randint(0, 3, (4,)).astype(
                               np.int32)],
                           "InCorrects": [_R.randint(0, 3, (4,)).astype(
                               np.int32)],
                           "InMeanIou": [np.array([0.25], np.float32)]},
                          {"num_classes": 4}),
    "fused_add_relu": ("fused_elemwise_activation",
                       {"X": [_f32(3, 4)], "Y": [_f32(3, 4)]},
                       {"functor_list": ["relu", "elementwise_add"]}),
    "fused_mul_scale": ("fused_elemwise_activation",
                        {"X": [_f32(3, 4)], "Y": [_f32(3)]},
                        {"functor_list": ["elementwise_mul", "scale"],
                         "scale": 0.5}),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_matches_jax(case):
    op_type, inputs, attrs = FORWARD[case]
    assert_forward(op_type, inputs, attrs,
                   atol=1e-4 if "conv" in case else 1e-5)


def test_bilinear_downscale_is_antialiased():
    """An 8 -> 2 downscale of a ramp averages over the tent widened 4x
    (the JAX semantics): output 0 samples 1.5 with weights 0.625, 0.875,
    0.875, 0.625, 0.375, 0.125 on inputs 0-5, 6.625 / 3.5; a plain
    half-pixel bilinear would read 1.5 and align-corners 0."""
    x = np.arange(8, dtype=np.float32).reshape(1, 1, 1, 8) * np.ones(
        (1, 1, 2, 1), np.float32)
    _, p = assert_forward("bilinear_interp", {"X": [x]},
                          {"out_h": 2, "out_w": 2})
    np.testing.assert_allclose(p["Out"][0][0, 0, 0],
                               [6.625 / 3.5, 7.0 - 6.625 / 3.5], atol=1e-6)


def test_random_crop_is_a_window_of_its_input():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 3
    with pt.program_guard(main, startup):
        blk = main.global_block()
        x = blk.create_var(name="x", shape=(2, 8, 8), dtype="float32")
        out = blk.create_var(name="out", dtype="float32")
        blk.append_op(type="random_crop", inputs={"X": [x]},
                      outputs={"Out": [out]}, attrs={"shape": [5, 5]})
    assert tuple(out.shape) == (2, 5, 5)
    arr = np.arange(2 * 64, dtype=np.float32).reshape(2, 8, 8)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    seen = set()
    for _ in range(6):
        (o,) = exe.run(main, feed={"x": arr}, fetch_list=["out"], scope=scope)
        i0, j0 = int(o[0, 0, 0]) // 8, int(o[0, 0, 0]) % 8
        assert 0 <= i0 <= 3 and 0 <= j0 <= 3
        np.testing.assert_array_equal(o, arr[:, i0:i0 + 5, j0:j0 + 5])
        seen.add((i0, j0))
    assert len(seen) > 1


# id -> (op type, inputs, attrs, differentiable inputs, {output: count})
GRADS = {
    "conv2d_transpose": FORWARD["conv2d_transpose_groups_dilation"][:3] + (
        ["Input", "Filter"], {"Output": 1}),
    "depthwise_conv2d_transpose": FORWARD["depthwise_conv2d_transpose"] + (
        ["Input", "Filter"], {"Output": 1}),
    "conv3d": FORWARD["conv3d"] + (["Input", "Filter"], {"Output": 1}),
    "conv3d_transpose": FORWARD["conv3d_transpose_groups"] + (
        ["Input", "Filter"], {"Output": 1}),
    "pool3d_max": FORWARD["pool3d_max"] + (["X"], {"Out": 1}),
    "pool3d_avg": FORWARD["pool3d_avg"] + (["X"], {"Out": 1}),
    "unpool": FORWARD["unpool_inferred_size"] + (["X"], {"Out": 1}),
    "spp": FORWARD["spp_avg"] + (["X"], {"Out": 1}),
    "group_norm": FORWARD["group_norm"] + (["X", "Scale", "Bias"],
                                           {"Y": 1}),
    "bilinear_down": FORWARD["bilinear_down"] + (["X"], {"Out": 1}),
    "bilinear_up": FORWARD["bilinear_up"] + (["X"], {"Out": 1}),
    "nearest_up": FORWARD["nearest_up"] + (["X"], {"Out": 1}),
    "im2sequence": FORWARD["im2sequence"] + (["X"], {"Out": 1}),
    "norm": FORWARD["norm_axis2"] + (["X"], {"Out": 1}),
    "label_smooth": FORWARD["label_smooth_prior"] + (["X"], {"Out": 1}),
    "cos_sim": FORWARD["cos_sim_broadcast"] + (["X", "Y"], {"Out": 1}),
    "flatten": ("flatten", {"X": [IMG]}, {"axis": 3}, ["X"], {"Out": 1}),
    "flatten2": ("flatten2", {"X": [IMG]}, {"axis": 2}, ["X"], {"Out": 1}),
    "crop": FORWARD["crop_offsets_input"] + (["X"], {"Out": 1}),
    "multiplex": ("multiplex", {"Ids": [np.array([[1], [0], [1]], np.int32)],
                                "X": [_f32(3, 4), _f32(3, 4)]}, {}, ["X"],
                  {"Out": 1}),
    "pad_constant_like": ("pad_constant_like",
                          {"X": [_f32(4, 5)], "Y": [_f32(2, 3)]},
                          {"pad_value": 0.5}, ["Y"], {"Out": 1}),
    "minus": ("minus", {"X": [_f32(3, 4)], "Y": [_f32(3, 4)]}, {},
              ["X", "Y"], {"Out": 1}),
    "l1_norm": ("l1_norm", {"X": [_f32(3, 4)]}, {}, ["X"], {"Out": 1}),
    "squared_l2_distance": ("squared_l2_distance",
                            {"X": [_f32(4, 3)], "Y": [_f32(1, 3)]}, {},
                            ["X", "Y"], {"Out": 1}),
    "modified_huber_loss": ("modified_huber_loss",
                            {"X": [_f32(8, 1)],
                             "Y": [_R.randint(0, 2, (8, 1)).astype(
                                 np.float32)]}, {}, ["X"], {"Out": 1}),
    "affine_channel": ("affine_channel", {"X": [IMG], "Scale": [_f32(4)],
                                          "Bias": [_f32(4)]}, {},
                       ["X", "Scale", "Bias"], {"Out": 1}),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                {"X": [_f32(3, 4)], "Y": [_f32(3, 5)],
                                 "Weight": [_f32(2, 4, 5)],
                                 "Bias": [_f32(1, 2)]}, {},
                                ["X", "Y", "Weight", "Bias"], {"Out": 1}),
    "row_conv": ("row_conv", {"X": [_f32(2, 5, 3)], "Filter": [_f32(3, 3)],
                              "SeqLen": [np.array([5, 3], np.int32)]}, {},
                 ["X", "Filter"], {"Out": 1}),
    "conv_shift": FORWARD["conv_shift"] + (["X", "Y"], {"Out": 1}),
    "fused_elemwise_activation": FORWARD["fused_mul_scale"] + (
        ["X", "Y"], {"Out": 1}),
}


@pytest.mark.parametrize("case", sorted(GRADS))
def test_grads_match_jax(case):
    op_type, inputs, attrs, diff, outs = GRADS[case]
    assert_grads(op_type, inputs, attrs, diff, outs, seed=len(case))


@pytest.mark.parametrize("case,plain", [
    ("max_pool2d_with_index_padded", "pool2d"),
    ("max_pool3d_with_index", "pool3d")])
def test_max_pool_with_index_grad_is_the_max_pools(case, plain):
    """The JAX package cannot differentiate these two ops (its
    reduce_window over (value, index) pairs refuses the symbolic zero
    cotangent of the index; ROADMAP C), so X's grad is held to the JAX
    package's max `pool2d` / `pool3d` grad over the same windows."""
    op_type, inputs, attrs = FORWARD[case]
    mine = assert_grads_against(op_type, plain, inputs, attrs)
    assert np.count_nonzero(mine) > 0


def assert_grads_against(op_type, jax_op_type, inputs, attrs):
    """`op_type`'s output and X grad in the port against `jax_op_type`'s
    (a max pool) in the JAX package, on the same feed."""
    jattrs = dict(attrs, pooling_type="max")
    jm, jouts = _build_grad(fluid, jun.guard, jax_op_type, inputs, jattrs,
                            ["X"], {"Out": 1})
    pm, _ = _build_grad(pt, pt.unique_name.guard, op_type, inputs, attrs,
                        ["X"], {"Out": 1})
    out = jouts["Out"][0]
    cot = np.random.RandomState(1).standard_normal(
        tuple(out.shape)).astype(np.float32)
    feed = {"X_0": inputs["X"][0], f"cot_{out.name}": cot}
    fetch = [out.name, "X_0@GRAD"]
    want = fluid.Executor(fluid.CPUPlace()).run(jm, feed=feed,
                                                fetch_list=fetch,
                                                scope=JScope())
    got = pt.Executor(pt.CPUPlace()).run(pm, feed=feed, fetch_list=fetch,
                                         scope=pt.Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)
    return got[1]
