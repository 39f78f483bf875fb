"""Generated layer functions (counterpart of paddle_tpu/layers/ops.py:
12-131): one wrapper a unary op of `_UNARY_OPS` (attrs pass through as
keywords), the compare and logical binaries, and cumsum, uniform_random,
gaussian_random and sampling_id."""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "tanh",
    "tanh_shrink",
    "softshrink",
    "sqrt",
    "rsqrt",
    "abs",
    "ceil",
    "floor",
    "cos",
    "sin",
    "round",
    "reciprocal",
    "log",
    "square",
    "softplus",
    "softsign",
    "gelu",
    "relu6",
    "hard_sigmoid",
    "swish",
    "leaky_relu",
    "elu",
    "brelu",
    "soft_relu",
    "stanh",
    "hard_shrink",
    "thresholded_relu",
    "maxout",
    "logical_not",
]

_COMPARE_OPS = ("less_than", "less_equal", "greater_than", "greater_equal",
                "equal", "not_equal")
_LOGICAL_OPS = ("logical_and", "logical_or", "logical_xor")


def _make_unary(op_type):
    def fn(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    fn.__name__ = op_type
    fn.__doc__ = f"Appends a `{op_type}` op (generated wrapper)."
    return fn


def _make_binary(op_type):
    """A bool output that stops gradients; `axis` as the elementwise
    broadcast takes it."""
    def fn(x, y, axis=-1, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype="bool",
                                                        stop_gradient=True)
        attrs["axis"] = axis
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    fn.__name__ = op_type
    return fn


for _op in _UNARY_OPS:
    globals()[_op] = _make_unary(_op)
for _op in _COMPARE_OPS + _LOGICAL_OPS:
    globals()[_op] = _make_binary(_op)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype, "min": min,
                            "max": max, "seed": seed})
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


__all__ = _UNARY_OPS + list(_COMPARE_OPS + _LOGICAL_OPS) + [
    "cumsum", "uniform_random", "gaussian_random", "sampling_id"]
