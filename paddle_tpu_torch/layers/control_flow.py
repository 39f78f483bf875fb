"""Control-flow layer functions: increment and the compare helpers
(paddle_tpu/layers/control_flow.py:699-749)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape  # elementwise: consumers still see a shape
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)},
                     infer_shape=False)
    return out


def _compare(op_type, x, y, cond=None):
    """A bool [x.shape] output (`cond`, or a new var that stops
    gradients), without an axis attr, as the JAX helper builds it."""
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool",
                                                         stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]}, infer_shape=False)
    cond.dtype = "bool"
    cond.shape = x.shape
    return cond


def less_than(x, y, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)
