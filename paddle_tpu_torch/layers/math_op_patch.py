"""Operator overloading on Variable (a + b, a * 2, a < b, ...): the JAX
package's monkey_patch_variable (paddle_tpu/layers/math_op_patch.py:22-80),
appending the same ops.  `x + 1e-6` is a `scale` op with that bias, and
`a / b` an `elementwise_div`."""

from __future__ import annotations

from ..framework.framework import Variable
from ..layer_helper import LayerHelper


def _create_scalar_like(ref_var, value):
    from . import tensor as tensor_layers

    if ref_var.shape and all(s != -1 for s in ref_var.shape):
        return tensor_layers.fill_constant(ref_var.shape, ref_var.dtype, value)
    return tensor_layers.fill_constant_batch_size_like(
        ref_var, [1 if s == -1 else s for s in (ref_var.shape or (1,))],
        ref_var.dtype, value)


def _binary_op(op_type, reverse=False):
    def impl(self, other):
        from . import nn

        if isinstance(other, (int, float)):
            if op_type in ("elementwise_add", "elementwise_sub") \
                    and not reverse:
                sign = 1 if op_type == "elementwise_add" else -1
                return nn.scale(self, scale=1.0, bias=float(other) * sign)
            if op_type == "elementwise_mul" and not reverse:
                return nn.scale(self, scale=float(other))
            other = _create_scalar_like(self, float(other))
        x, y = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        return out

    return impl


def _cmp_op(op_type):
    def impl(self, other):
        if isinstance(other, (int, float)):
            other = _create_scalar_like(self, float(other))
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype="bool",
                                                        stop_gradient=True)
        helper.append_op(type=op_type, inputs={"X": [self], "Y": [other]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        return out

    return impl


def monkey_patch_variable():
    Variable.__add__ = _binary_op("elementwise_add")
    Variable.__radd__ = _binary_op("elementwise_add", reverse=True)
    Variable.__sub__ = _binary_op("elementwise_sub")
    Variable.__rsub__ = _binary_op("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary_op("elementwise_mul")
    Variable.__rmul__ = _binary_op("elementwise_mul", reverse=True)
    Variable.__truediv__ = _binary_op("elementwise_div")
    Variable.__rtruediv__ = _binary_op("elementwise_div", reverse=True)
    Variable.__pow__ = _binary_op("elementwise_pow")
    Variable.__mod__ = _binary_op("elementwise_mod")
    Variable.__lt__ = _cmp_op("less_than")
    Variable.__le__ = _cmp_op("less_equal")
    Variable.__gt__ = _cmp_op("greater_than")
    Variable.__ge__ = _cmp_op("greater_equal")

    def _neg(self):
        from . import nn

        return nn.scale(self, scale=-1.0)

    Variable.__neg__ = _neg
