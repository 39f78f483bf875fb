"""Control-flow layer functions of the serving slice: increment
(paddle_tpu/layers/control_flow.py:699)."""

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
