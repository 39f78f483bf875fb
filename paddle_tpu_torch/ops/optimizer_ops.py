"""Optimizer update ops: sgd, momentum and adam
(paddle_tpu/ops/optimizer_ops.py:37, :45, :81).

Each update writes its outputs under the input var names (ParamOut is
Param), so the Executor stores the new values over the old ones in the
scope.  With an f32 MasterParam (bf16 training, optimizer
multi_precision) the update is computed on the master in f32 and both the
master and the param, cast back to its own dtype, are written.
"""

from __future__ import annotations

import torch

from .registry import register_op


def _lr(ctx, like):
    return ctx.input("LearningRate").reshape(()).to(like.dtype)


def _master(ctx, p):
    """(tensor the update computes on, whether it is a master weight)."""
    m = ctx.input("MasterParam") if ctx.has_input("MasterParam") else None
    return (m, True) if m is not None else (p, False)


def _emit_param(ctx, p, p_new, had_master):
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    if had_master:
        ctx.set_output("MasterParamOut", p_new)


def _const(value, like):
    """A python scalar rounded to `like`'s dtype, as jnp.asarray(v, dtype)."""
    return torch.tensor(value, dtype=like.dtype).item()


@register_op("sgd", no_grad=True)
def sgd(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    pc, had_master = _master(ctx, p)
    g = g.to(pc.dtype)
    _emit_param(ctx, p, pc - _lr(ctx, pc) * g, had_master)


@register_op("momentum", no_grad=True)
def momentum(ctx):
    """v' = mu v + g;  p' = p - lr v', or with Nesterov p - lr (g + mu v').
    The velocity lives in the master's dtype (float32 under AMP)."""
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    pc, had_master = _master(ctx, p)
    g = g.to(pc.dtype)
    mu = _const(ctx.attr("mu"), pc)
    lr = _lr(ctx, pc)
    v_out = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_out = pc - (g + mu * v_out) * lr
    else:
        p_out = pc - lr * v_out
    _emit_param(ctx, p, p_out, had_master)
    ctx.set_output("VelocityOut", v_out)


@register_op("adam", no_grad=True)
def adam(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    pc, had_master = _master(ctx, p)
    g = g.to(pc.dtype)
    b1p = ctx.input("Beta1Pow").reshape(()).to(pc.dtype)
    b2p = ctx.input("Beta2Pow").reshape(()).to(pc.dtype)
    b1 = _const(ctx.attr("beta1", 0.9), pc)
    b2 = _const(ctx.attr("beta2", 0.999), pc)
    eps = _const(ctx.attr("epsilon", 1e-8), pc)
    lr = _lr(ctx, pc) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    m_out = b1 * m + (1.0 - b1) * g
    v_out = b2 * v + (1.0 - b2) * g.square()
    p_out = pc - lr * m_out / (torch.sqrt(v_out) + eps)
    _emit_param(ctx, p, p_out, had_master)
    ctx.set_output("Moment1Out", m_out)
    ctx.set_output("Moment2Out", v_out)
