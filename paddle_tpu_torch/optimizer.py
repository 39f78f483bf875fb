"""Optimizers: append_backward + per-parameter update ops.

Counterpart of paddle_tpu/optimizer.py: the Optimizer base (minimize =
append_backward, gradient clipping, regularization, then the optimization
pass appending the global learning rate, the accumulators and one update
op per parameter, stamped OpRole.Optimize), SGDOptimizer,
MomentumOptimizer and AdamOptimizer with its beta-power `scale` ops.  The
update ops are ordinary IR ops (ops/optimizer_ops.py) that write over
their inputs in the scope.  The other optimizers (Lars, Adagrad, Adamax,
...) and RecomputeOptimizer/ModelAverage are later work (ROADMAP.md A).

`multi_precision=True` keeps an f32 master copy of every bf16 parameter
(made by a `cast` op in the startup program) and f32 moments: the update
runs in f32 on the master, and the bf16 parameter is its rounding.
"""

from __future__ import annotations

from collections import defaultdict

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import unique_name
from .framework.core_types import convert_dtype
from .framework.framework import (
    OpRole,
    Variable,
    default_main_program,
    default_startup_program,
    op_role_guard,
    program_guard,
)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from . import regularizer as regularizer_mod

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self.type = getattr(self, "type", "sgd")
        # {accumulator name: {param name: Variable}}
        self._accumulators = defaultdict(dict)
        self._learning_rate_map = {}
        self.helper = None
        self._multi_precision = multi_precision
        self._master_weights = {}

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        if program in self._learning_rate_map:
            return
        from .layers import tensor

        self._learning_rate_map[program] = tensor.create_global_var(
            name=unique_name.generate("learning_rate"), shape=[1],
            value=float(self._learning_rate), dtype="float32",
            persistable=True)

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        base = self._global_learning_rate()
        param_lr = (param_and_grad[0].optimize_attr or {}).get(
            "learning_rate", 1.0)
        if param_lr == 1.0:
            return base
        from .layers import nn

        with op_role_guard(OpRole.Optimize):
            return nn.scale(base, scale=float(param_lr))

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            persistable=True, dtype=dtype or param.dtype,
            shape=shape or param.shape)
        var.stop_gradient = True
        self.helper.set_variable_initializer(var,
                                             ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- f32 master weights (bf16 training) --------------------------------
    def _needs_master(self, param):
        return self._multi_precision and convert_dtype(param.dtype) in (
            "bfloat16", "float16")

    def _acc_dtype(self, param):
        """Moments live in f32 when the param is low-precision."""
        return "float32" if self._needs_master(param) else None

    def _create_master_weight(self, param):
        """f32 shadow of a low-precision param, made in the startup program
        by casting the freshly initialised param."""
        if param.name in self._master_weights:
            return self._master_weights[param.name]
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_master"),
            persistable=True, dtype="float32", shape=param.shape)
        var.stop_gradient = True
        sb = default_startup_program().global_block()
        if not sb.has_var(var.name):
            sb.create_var(name=var.name, shape=var.shape, dtype="float32",
                          persistable=True)
            sb.append_op(type="cast", inputs={"X": [param.name]},
                         outputs={"Out": [var.name]},
                         attrs={"in_dtype": param.dtype,
                                "out_dtype": "float32"},
                         infer_shape=False)
        self._master_weights[param.name] = var
        return var

    # -- hooks for subclasses ---------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- the optimization pass --------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program):
        """Global LR, accumulators, one update op per param (stamped
        OpRole.Optimize), then _finish_update."""
        program = loss.block.program
        self.helper = LayerHelper(self.__class__.__name__)
        with program_guard(program,
                           startup_program or default_startup_program()):
            self._create_global_learning_rate()
            self._create_accumulators(
                loss.block, [p for p, g in parameters_and_grads
                             if g is not None])
            optimize_ops = []
            with op_role_guard(OpRole.Optimize):
                for param_and_grad in parameters_and_grads:
                    if param_and_grad[1] is None:
                        continue
                    if not param_and_grad[0].trainable:
                        continue
                    op = self._append_optimize_op(loss.block, param_and_grad)
                    op.attrs[OpRole.ATTR_NAME] = OpRole.Optimize
                    op.attrs[OpRole.VAR_ATTR_NAME] = [
                        param_and_grad[0].name, param_and_grad[1].name]
                    optimize_ops.append(op)
                self._finish_update(loss.block, parameters_and_grads)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = regularizer_mod.append_regularization_ops(
            params_grads, self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            if self._needs_master(p):
                self._create_master_weight(p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        inputs = {"Param": [p], "Grad": [param_and_grad[1]],
                  "LearningRate": [self._create_param_lr(param_and_grad)]}
        outputs = {"ParamOut": [p]}
        if self._needs_master(p):
            master = self._master_weights[p.name]
            inputs["MasterParam"] = [master]
            outputs["MasterParamOut"] = [master]
        return block.append_op(type="sgd", inputs=inputs, outputs=outputs,
                               infer_shape=False)


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p,
                                  dtype=self._acc_dtype(p))
            if self._needs_master(p):
                self._create_master_weight(p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        velocity = self._get_accumulator(self._velocity_acc_str, p)
        inputs = {"Param": [p], "Grad": [param_and_grad[1]],
                  "Velocity": [velocity],
                  "LearningRate": [self._create_param_lr(param_and_grad)]}
        outputs = {"ParamOut": [p], "VelocityOut": [velocity]}
        if self._needs_master(p):
            master = self._master_weights[p.name]
            inputs["MasterParam"] = [master]
            outputs["MasterParamOut"] = [master]
        return block.append_op(
            type="momentum", inputs=inputs, outputs=outputs,
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            dt = self._acc_dtype(p)
            self._add_accumulator(self._moment1_acc_str, p, dtype=dt)
            self._add_accumulator(self._moment2_acc_str, p, dtype=dt)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1],
                                  dtype="float32")
            self._add_accumulator(self._beta2_pow_acc_str, p,
                                  fill_value=self._beta2, shape=[1],
                                  dtype="float32")
            if self._needs_master(p):
                self._create_master_weight(p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        m1 = self._get_accumulator(self._moment1_acc_str, p)
        m2 = self._get_accumulator(self._moment2_acc_str, p)
        inputs = {
            "Param": [p], "Grad": [param_and_grad[1]],
            "Moment1": [m1], "Moment2": [m2],
            "Beta1Pow": [self._get_accumulator(self._beta1_pow_acc_str, p)],
            "Beta2Pow": [self._get_accumulator(self._beta2_pow_acc_str, p)],
            "LearningRate": [self._create_param_lr(param_and_grad)],
        }
        outputs = {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2]}
        if self._needs_master(p):
            master = self._master_weights[p.name]
            inputs["MasterParam"] = [master]
            outputs["MasterParamOut"] = [master]
        return block.append_op(
            type="adam", inputs=inputs, outputs=outputs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False)

    def _finish_update(self, block, parameters_and_grads):
        """Per-param beta-power updates: one `scale` op each."""
        for p, g in parameters_and_grads:
            if g is None or not p.trainable:
                continue
            for acc, beta in ((self._beta1_pow_acc_str, self._beta1),
                              (self._beta2_pow_acc_str, self._beta2)):
                b = self._get_accumulator(acc, p)
                block.append_op(type="scale", inputs={"X": [b]},
                                outputs={"Out": [b]},
                                attrs={"scale": beta,
                                       OpRole.ATTR_NAME: OpRole.Optimize},
                                infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
