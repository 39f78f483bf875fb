"""Tensor layer functions of the serving slice: create_parameter
(paddle_tpu/layers/tensor.py:22)."""

from __future__ import annotations

from ..layer_helper import LayerHelper, ParamAttr


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)
