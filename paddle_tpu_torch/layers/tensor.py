"""Tensor layer functions: create_parameter, create_global_var, sums
(paddle_tpu/layers/tensor.py:22-75)."""

from __future__ import annotations

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper, ParamAttr


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block var initialised to `value` by the startup program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(name=helper.name, shape=shape,
                                        dtype=dtype, persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out
