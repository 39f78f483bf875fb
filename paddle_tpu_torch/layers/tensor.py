"""Tensor layer functions: create_tensor, create_parameter,
create_global_var, cast, concat, sums, assign, fill_constant,
fill_constant_batch_size_like, ones, zeros, zeros_like, argmax, argmin,
argsort, reverse, has_inf, has_nan, isfinite and range
(paddle_tpu/layers/tensor.py:15-234)."""

from __future__ import annotations

import numpy as np

from ..framework.core_types import convert_dtype
from ..framework.framework import Variable
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper, ParamAttr


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


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


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def _arg(op_type, x, axis):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    return _arg("arg_max", x, axis)


def argmin(x, axis=0):
    return _arg("arg_min", x, axis)


def argsort(x, axis=-1, name=None):
    """-> (the sorted values, their int64 indices)."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def _overflow_check(x, op_type):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="bool",
                                                    stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def has_inf(x):
    """True if any element of x is +/-inf."""
    return _overflow_check(x, "isinf")


def has_nan(x):
    """True if any element of x is NaN."""
    return _overflow_check(x, "isnan")


def isfinite(x):
    """True if every element of x is finite."""
    return _overflow_check(x, "isfinite")


def range(start, end, step, dtype):
    """[start, end) by step, a host op (its length depends on the
    values); each bound a Variable or a number (a fill_constant)."""
    helper = LayerHelper("range")
    start, end, step = (
        v if isinstance(v, Variable) else fill_constant([1], dtype, v)
        for v in (start, end, step))
    out = helper.create_variable_for_type_inference(
        dtype=convert_dtype(dtype))
    helper.append_op(type="range",
                     inputs={"Start": [start], "End": [end], "Step": [step]},
                     outputs={"Out": [out]})
    return out
