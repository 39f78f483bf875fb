"""LayerHelper: shared plumbing for layer functions (counterpart of
paddle_tpu/layer_helper.py) — parameter creation with its startup-program
init op, temp var creation, activation and bias append."""

from __future__ import annotations

from . import initializer as init_mod
from .framework import unique_name
from .framework.framework import (
    Variable,
    default_main_program,
    default_startup_program,
)


class ParamAttr:
    """A parameter's name, initializer, per-parameter learning-rate factor,
    regularizer, trainability, gradient clip and model-average
    eligibility (None: eligible)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init_mod.Initializer):
            return ParamAttr(initializer=arg)
        if arg is False:
            return ParamAttr(trainable=False)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            inputs = [inputs]
        return list(inputs)

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for x in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = x.dtype
            elif dtype != x.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr.initializer is None:
            if default_initializer is not None:
                attr.initializer = default_initializer
            elif is_bias:
                attr.initializer = init_mod._global_bias_initializer()
            else:
                attr.initializer = init_mod._global_weight_initializer()
        name = attr.name or unique_name.generate(f"{self.name}.w")
        param = self.block.create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            do_model_average=attr.do_model_average)
        # mirror into the startup program with its init op
        sb = self.startup_program.global_block()
        if not sb.has_var(name):
            sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                               persistable=True)
            attr.initializer(sv, sb)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    def create_variable(self, **kwargs):
        return self.block.create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, **kwargs):
        """(the persistable global var `name`, whether it was created)."""
        gb = self.main_program.global_block()
        if gb.has_var(name):
            return gb.var(name), False
        return gb.create_var(name=name, persistable=True, **kwargs), True

    def set_variable_initializer(self, var, initializer):
        """Registers the var and its init op in the startup program."""
        sb = self.startup_program.global_block()
        if not sb.has_var(var.name):
            sv = sb.create_var(name=var.name, shape=var.shape,
                               dtype=var.dtype, persistable=True)
            initializer(sv, sb)
        return var

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        """Create/apply a bias over dims [dim_start, dim_end) of input."""
        size = input_var.shape[dim_start:dim_end]
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        b = self.create_parameter(
            attr=bias_attr if bias_attr not in (True, None) else None,
            shape=[int(s) for s in size] if len(size) > 1 else [int(size[0])],
            dtype=input_var.dtype,
            is_bias=True,
        )
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [out]},
            attrs={"axis": dim_start},
        )
        return out
