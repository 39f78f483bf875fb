"""Weight-decay regularizers appended as grad-modifying ops.

Counterpart of paddle_tpu/regularizer.py: between backward and the
optimizer update, each parameter's regularization term is added to its
gradient by a `sum` op.  With no regularizer the pairs pass through.
L1DecayRegularizer needs the `sign` op and lands with it (ROADMAP.md A).
"""

from __future__ import annotations

from .framework.framework import OpRole, op_role_guard


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=grad.name + "@L2DECAY", shape=param.shape, dtype=param.dtype,
            stop_gradient=True,
        )
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
            infer_shape=False,
        )
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """A parameter's own regularizer overrides the global one."""
    params_and_grads = []
    with op_role_guard(OpRole.Backward):
        for param, grad in parameters_and_grads:
            if grad is None:
                params_and_grads.append((param, grad))
                continue
            reg = (param.regularizer if param.regularizer is not None
                   else regularization)
            term = reg(param, grad, grad.block) if reg is not None else None
            if term is None:
                params_and_grads.append((param, grad))
                continue
            grad.block.append_op(
                type="sum",
                inputs={"X": [grad, term]},
                outputs={"Out": [grad]},
                infer_shape=False,
            )
            params_and_grads.append((param, grad))
    return params_and_grads


L2Decay = L2DecayRegularizer
