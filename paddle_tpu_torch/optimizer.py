"""Optimizers: append_backward + per-parameter update ops.

Counterpart of paddle_tpu/optimizer.py: the Optimizer base (minimize =
append_backward, gradient clipping, regularization, then the optimization
pass appending the global learning rate, the accumulators and one update
op per parameter, stamped OpRole.Optimize), SGD, Momentum, LarsMomentum,
Adagrad, ProximalGD, ProximalAdagrad, Adam and Adamax (with their
beta-power `scale` ops), DecayedAdagrad, Adadelta, RMSProp, Ftrl, and
ModelAverage.  The update ops are ordinary IR ops (ops/optimizer_ops.py)
that write over their inputs in the scope.  RecomputeOptimizer wraps any
of them and rewrites the minimized program with recompute.apply_recompute.

`multi_precision=True` keeps an f32 master copy of every bf16 parameter
(made by a `cast` op in the startup program) and f32 moments: the update
runs in f32 on the master, and the bf16 parameter is its rounding.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch

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

__all__ = [
    "Optimizer",
    "SGD", "SGDOptimizer",
    "Momentum", "MomentumOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer",
    "Adagrad", "AdagradOptimizer",
    "Adam", "AdamOptimizer",
    "Adamax", "AdamaxOptimizer",
    "DecayedAdagrad", "DecayedAdagradOptimizer",
    "Adadelta", "AdadeltaOptimizer",
    "RMSProp", "RMSPropOptimizer",
    "Ftrl", "FtrlOptimizer",
    "ProximalGD", "ProximalGDOptimizer",
    "ProximalAdagrad", "ProximalAdagradOptimizer",
    "ModelAverage",
    "RecomputeOptimizer",
]


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


def _beta_pow_scales(opt, block, parameters_and_grads, accs):
    """One `scale` op per (parameter, beta power): the power times beta."""
    for p, g in parameters_and_grads:
        if g is None or not p.trainable:
            continue
        for acc, beta in accs:
            b = opt._get_accumulator(acc, p)
            block.append_op(type="scale", inputs={"X": [b]},
                            outputs={"Out": [b]},
                            attrs={"scale": beta,
                                   OpRole.ATTR_NAME: OpRole.Optimize},
                            infer_shape=False)


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
        _beta_pow_scales(self, block, parameters_and_grads,
                         ((self._beta1_pow_acc_str, self._beta1),
                          (self._beta2_pow_acc_str, self._beta2)))




class LarsMomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
            infer_shape=False)


class _MomentOptimizer(Optimizer):
    """An update with one `moment` accumulator and the learning rate:
    adagrad, decayed_adagrad, proximal_adagrad."""

    _moment_acc_str = "moment"

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _attrs(self):
        raise NotImplementedError

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs=self._attrs(), infer_shape=False)


class AdagradOptimizer(_MomentOptimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _attrs(self):
        return {"epsilon": self._epsilon}


class DecayedAdagradOptimizer(_MomentOptimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class ProximalAdagradOptimizer(_MomentOptimizer):
    """An adagrad-scaled step, then the l1/l2 proximal shrink."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "proximal_adagrad"
        self._l1 = float(l1)
        self._l2 = float(l2)

    def _attrs(self):
        return {"l1": self._l1, "l2": self._l2}


class ProximalGDOptimizer(Optimizer):
    """A plain gradient step, then the l1/l2 proximal shrink (FOBOS)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "proximal_gd"
        self._l1 = float(l1)
        self._l2 = float(l2)

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="proximal_gd",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]},
            attrs={"l1": self._l1, "l2": self._l2}, infer_shape=False)


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [self._get_accumulator(
                        self._beta1_pow_acc_str, p)],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False)

    def _finish_update(self, block, parameters_and_grads):
        _beta_pow_scales(self, block, parameters_and_grads,
                         ((self._beta1_pow_acc_str, self._beta1),))


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        g_acc = self._get_accumulator(self._avg_squared_grad_acc_str, p)
        u_acc = self._get_accumulator(self._avg_squared_update_acc_str, p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "AvgSquaredGrad": [g_acc], "AvgSquaredUpdate": [u_acc]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [g_acc],
                     "AvgSquaredUpdateOut": [u_acc]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        momentum_acc = self._get_accumulator(self._momentum_acc_str, p)
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str, p)
        mean_grad_acc = self._get_accumulator(self._mean_grad_acc_str, p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "Moment": [momentum_acc], "MeanSquare": [mean_square_acc],
                    "MeanGrad": [mean_grad_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [momentum_acc],
                     "MeanSquareOut": [mean_square_acc],
                     "MeanGradOut": [mean_grad_acc]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        sq = self._get_accumulator(self._squared_acc_str, p)
        lin = self._get_accumulator(self._linear_acc_str, p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
            infer_shape=False)


class RecomputeOptimizer(Optimizer):
    """An optimizer with activation recompute over checkpoint vars
    (optimizer.py:739-770 of the JAX package; recompute.py):

        opt = optimizer.RecomputeOptimizer(optimizer.Adam(1e-4), ckpts)
        opt.minimize(loss)

    Every other attribute is the inner optimizer's."""

    def __init__(self, inner_optimizer, checkpoints=None):
        self._inner = inner_optimizer
        self._checkpoints = list(checkpoints or [])

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .recompute import apply_recompute

        optimize_ops, params_grads = self._inner.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        if self._checkpoints:
            apply_recompute(loss.block.program, self._checkpoints)
        return optimize_ops, params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (optimizer.py:786 of the JAX
    package).  Construct it after optimizer.minimize(): it appends one
    `average_accumulates` op per parameter to the main program, so every
    training step also advances the window's sums.  `with ma.apply():`
    binds each parameter to its window average in the scope (evaluation
    weights) and binds the live tensors back on exit; with
    need_restore=False they stay stashed until restore()."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, program=None, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        program = program or default_main_program()
        self._program = program
        self.helper = LayerHelper("model_average")
        block = program.global_block()
        self._params = [p for p in block.all_parameters()
                        if getattr(p, "do_model_average", None) is not False]
        self._accs = {}
        self._saved = {}
        with op_role_guard(OpRole.Optimize):
            for p in self._params:
                self._append_average_op(block, p)

    def _append_average_op(self, block, p):
        sums = [self._add_accumulator(f"ma_sum_{i}", p, dtype="float32")
                for i in (1, 2, 3)]
        counters = [self._add_accumulator(f"ma_{c}", p, dtype="int64",
                                          shape=(1,))
                    for c in ("num_acc", "old_num_acc", "num_upd")]
        self._accs[p.name] = (sums, counters)
        block.append_op(
            type="average_accumulates",
            inputs={"Param": [p], "InSum1": [sums[0]], "InSum2": [sums[1]],
                    "InSum3": [sums[2]], "InNumAccumulates": [counters[0]],
                    "InOldNumAccumulates": [counters[1]],
                    "InNumUpdates": [counters[2]]},
            outputs={"OutSum1": [sums[0]], "OutSum2": [sums[1]],
                     "OutSum3": [sums[2]],
                     "OutNumAccumulates": [counters[0]],
                     "OutOldNumAccumulates": [counters[1]],
                     "OutNumUpdates": [counters[2]]},
            attrs={"average_window": float(self.average_window),
                   "min_average_window": int(self.min_average_window),
                   "max_average_window": int(self.max_average_window),
                   OpRole.ATTR_NAME: OpRole.Optimize},
            infer_shape=False)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True, scope=None):
        """Bind each parameter to (sum_1 + sum_2 + sum_3) / (num_acc +
        old_num_acc), summed in float64 on the host and put back on the
        parameter's device in its dtype."""
        from .framework.scope import global_scope

        scope = scope if scope is not None else global_scope()
        saved = {}
        for p in self._params:
            sums, counters = self._accs[p.name]
            vals = [scope.find_var(v.name) for v in sums + counters]
            if any(v is None for v in vals):
                raise RuntimeError(
                    f"ModelAverage accumulators for {p.name!r} have no "
                    "values in this scope — run the startup program (after "
                    "constructing ModelAverage) and train at least one step")
            host = [torch.as_tensor(v).detach().cpu().numpy() for v in vals]
            s = sum(h.astype(np.float64) for h in host[:3])
            n = int(host[3].reshape(-1)[0]) + int(host[4].reshape(-1)[0])
            if n == 0:
                continue
            live = scope.find_var(p.name)
            saved[p.name] = live
            avg = torch.from_numpy(s / n)
            if isinstance(live, torch.Tensor):
                avg = avg.to(device=live.device, dtype=live.dtype)
            scope.set_var(p.name, avg)
        try:
            yield
        finally:
            if need_restore:
                for name, v in saved.items():
                    scope.set_var(name, v)
            else:
                self._saved = dict(saved)
                self._saved_scope = scope

    def restore(self, executor=None):
        """Bind back the live parameters that apply(need_restore=False)
        stashed."""
        if not self._saved:
            return
        for name, v in self._saved.items():
            self._saved_scope.set_var(name, v)
        self._saved = {}
