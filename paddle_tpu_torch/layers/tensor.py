"""Tensor layer functions: create_parameter, create_global_var, cast,
concat, sums, assign, fill_constant, fill_constant_batch_size_like
(paddle_tpu/layers/tensor.py:22-135)."""

from __future__ import annotations

import numpy as np

from ..framework.core_types import convert_dtype
from ..framework.framework import Variable
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


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=convert_dtype(dtype))
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype,
                            "out_dtype": convert_dtype(dtype)})
    return out


def concat(input, axis=0, name=None):
    """One `concat` op joining the `input` Variables along `axis`."""
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """A Variable -> an `assign` op; a numpy array -> an `assign_value` op
    holding its values."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(input.dtype))
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": str(input.dtype),
                                "values": input.reshape(-1).tolist()})
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=convert_dtype(dtype))
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": convert_dtype(dtype),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=convert_dtype(dtype))
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": [int(s) for s in shape],
               "dtype": convert_dtype(dtype), "value": float(value),
               "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out
