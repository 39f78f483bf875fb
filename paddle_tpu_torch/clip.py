"""Gradient clipping as program rewrites between backward and optimize.

Counterpart of paddle_tpu/clip.py, kept to the path `Optimizer.minimize`
walks: `error_clip_callback` (run after every grad op by append_backward)
and `append_gradient_clip_ops` (run on the (param, grad) pairs), which
pass everything through when no var carries an `error_clip` and no
parameter a `gradient_clip_attr`.  The clip attributes themselves
(ErrorClipByValue, GradientClipByValue/ByNorm/ByGlobalNorm) and
`set_gradient_clip` need the `clip`, `clip_by_norm` and `squared_l2_norm`
ops and land with them (ROADMAP.md A).
"""

from __future__ import annotations

from .framework.framework import OpRole, op_role_guard


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
