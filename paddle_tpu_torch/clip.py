"""Error and gradient clipping as program rewrites between backward and
optimize.

Counterpart of paddle_tpu/clip.py (:14-172): ErrorClipByValue (a `clip`
op after the grad op that produced the var's gradient, appended by
`error_clip_callback` during append_backward), GradientClipByValue
(`clip`), GradientClipByNorm (`clip_by_norm`), GradientClipByGlobalNorm
(a `squared_l2_norm` a gradient, then `sums`, `sqrt`, `fill_constant`,
`elementwise_max`, `elementwise_div` and one `elementwise_mul` a
gradient), `set_gradient_clip` and `append_gradient_clip_ops`, which
`Optimizer.minimize` runs on the (param, grad) pairs.  The ops are the
JAX package's, in its order, so both packages build the same program.
"""

from __future__ import annotations

from .framework.framework import OpRole, default_main_program, op_role_guard
from .layer_helper import LayerHelper


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clips the error (the activation's gradient) of a var to [min,
    max]."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        block.append_op(
            type="clip",
            inputs={"X": [grad_name]},
            outputs={"Out": [grad_name]},
            attrs={"min": self.min, "max": self.max},
            infer_shape=False,
        )


def error_clip_callback(block, context):
    """After each grad op, clip any produced grad whose forward var carries
    an `error_clip` attribute."""
    op_desc = context["op_desc"]
    for names in op_desc["outputs"].values():
        for grad_n in names:
            if grad_n is None or "@GRAD" not in grad_n:
                continue
            fwd_var_name = grad_n.split("@GRAD")[0]
            if not block.has_var(fwd_var_name):
                continue
            error_clip = getattr(block.var(fwd_var_name), "error_clip", None)
            if error_clip is not None:
                error_clip._append_clip_op(block, grad_n)


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        raise NotImplementedError

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient clipped elementwise to [min, max]."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        from .layers import nn

        return param, nn.clip(x=grad, min=self.min, max=self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled down to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        from .layers import nn

        return param, nn.clip_by_norm(x=grad, max_norm=self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient of a group scaled by clip_norm / max(global_norm,
    clip_norm), global_norm the L2 norm over the whole group.  The scale
    is a [1] tensor on the card: nothing is read back."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError(
                "all parameters in a group should share clip_norm")
        helper = LayerHelper("global_norm_clip")
        sq = helper.create_variable_for_type_inference("float32",
                                                       stop_gradient=True)
        helper.append_op(type="squared_l2_norm", inputs={"X": [grad]},
                         outputs={"Out": [sq]})
        context[self.group_name].append(sq)

    def _create_operators(self, param, grad):
        from .layers import nn, tensor
        from .layers import ops as layer_ops

        group = self.context[self.group_name]
        if self.group_name + "_global_scale" not in self.context:
            global_norm = layer_ops.sqrt(tensor.sums(group))
            clip_var = tensor.fill_constant([1], "float32", self.clip_norm)
            scale = nn.elementwise_div(
                clip_var, nn.elementwise_max(clip_var, global_norm))
            self.context[self.group_name + "_global_scale"] = scale
        scale = self.context[self.group_name + "_global_scale"]
        return param, nn.elementwise_mul(grad, scale)


def set_gradient_clip(clip, param_list=None, program=None):
    """Attach `clip` to every parameter of `param_list` (default: all of
    the program's)."""
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    context = {}
    with op_role_guard(OpRole.Backward):
        for p, g in param_grads:
            if g is None:
                continue
            clip_attr = (getattr(p, "gradient_clip_attr", None)
                         or NullGradientClipAttr())
            clip_attr._process_context(context=context, param=p, grad=g)
        res = []
        for p, g in param_grads:
            if g is None:
                res.append((p, g))
                continue
            clip_attr = (getattr(p, "gradient_clip_attr", None)
                         or NullGradientClipAttr())
            clip_attr.context = context
            res.append(clip_attr._create_operators(param=p, grad=g))
    return res
