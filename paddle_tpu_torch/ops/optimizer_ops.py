"""Optimizer update ops (paddle_tpu/ops/optimizer_ops.py): sgd, momentum,
lars_momentum, adam, adamax, adagrad, decayed_adagrad, adadelta, rmsprop,
ftrl, proximal_gd, proximal_adagrad and ModelAverage's
average_accumulates, each the JAX lowering's arithmetic in its order.

Each update writes its outputs under the input var names (ParamOut is
Param), so the Executor stores the new values over the old ones in the
scope (on the jit path, into the same storage inside the captured step).
With an f32 MasterParam (bf16 training, optimizer multi_precision) sgd,
momentum and adam compute on the master in f32 and write both the master
and the param, cast back to its own dtype; the other updates take no
master, as in the JAX package.
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


@register_op("lars_momentum", no_grad=True)
def lars_momentum(ctx):
    """Layer-wise adaptive rate scaling (lars_momentum_op.cc): the local
    rate lr * coeff * |p| / (|g| + wd |p| + 1e-12) where both norms are
    positive, else lr."""
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    mu = _const(ctx.attr("mu"), p)
    lars_coeff = ctx.attr("lars_coeff", 0.001)
    lars_wd = ctx.attr("lars_weight_decay", 0.0005)
    lr = _lr(ctx, p)
    p_norm = torch.sqrt(torch.sum(p.square()))
    g_norm = torch.sqrt(torch.sum(g.square()))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + lars_wd * p_norm + 1e-12), lr)
    v_out = mu * v + local_lr * (g + lars_wd * p)
    ctx.set_output("ParamOut", p - v_out)
    ctx.set_output("VelocityOut", v_out)


@register_op("adamax", no_grad=True)
def adamax(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, inf = ctx.input("Moment"), ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow").reshape(()).to(p.dtype)
    b1 = _const(ctx.attr("beta1", 0.9), p)
    b2 = _const(ctx.attr("beta2", 0.999), p)
    eps = _const(ctx.attr("epsilon", 1e-8), p)
    lr = _lr(ctx, p) / (1.0 - b1p)
    m_out = b1 * m + (1.0 - b1) * g
    inf_out = torch.maximum(b2 * inf, g.abs())
    ctx.set_output("ParamOut", p - lr * m_out / (inf_out + eps))
    ctx.set_output("MomentOut", m_out)
    ctx.set_output("InfNormOut", inf_out)


@register_op("adagrad", no_grad=True)
def adagrad(ctx):
    p, g, mom = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    eps = _const(ctx.attr("epsilon", 1e-6), p)
    m_out = mom + g.square()
    ctx.set_output("ParamOut", p - _lr(ctx, p) * g / (torch.sqrt(m_out)
                                                      + eps))
    ctx.set_output("MomentOut", m_out)


@register_op("decayed_adagrad", no_grad=True)
def decayed_adagrad(ctx):
    p, g, mom = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    decay = _const(ctx.attr("decay", 0.95), p)
    eps = _const(ctx.attr("epsilon", 1e-6), p)
    m_out = decay * mom + (1.0 - decay) * g.square()
    ctx.set_output("ParamOut", p - _lr(ctx, p) * g / (torch.sqrt(m_out)
                                                      + eps))
    ctx.set_output("MomentOut", m_out)


@register_op("adadelta", no_grad=True)
def adadelta(ctx):
    """No learning rate: the step is sqrt((E[u^2] + eps) / (E[g^2] + eps))
    g."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    avg_sq_g = ctx.input("AvgSquaredGrad")
    avg_sq_u = ctx.input("AvgSquaredUpdate")
    rho = _const(ctx.attr("rho", 0.95), p)
    eps = _const(ctx.attr("epsilon", 1e-6), p)
    g_acc = rho * avg_sq_g + (1.0 - rho) * g.square()
    update = -torch.sqrt((avg_sq_u + eps) / (g_acc + eps)) * g
    u_acc = rho * avg_sq_u + (1.0 - rho) * update.square()
    ctx.set_output("ParamOut", p + update)
    ctx.set_output("AvgSquaredGradOut", g_acc)
    ctx.set_output("AvgSquaredUpdateOut", u_acc)


@register_op("rmsprop", no_grad=True)
def rmsprop(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    ms, mom = ctx.input("MeanSquare"), ctx.input("Moment")
    rho = _const(ctx.attr("decay", 0.9), p)
    eps = _const(ctx.attr("epsilon", 1e-10), p)
    mu = _const(ctx.attr("momentum", 0.0), p)
    lr = _lr(ctx, p)
    ms_out = rho * ms + (1.0 - rho) * g.square()
    if ctx.attr("centered", False):
        mg = ctx.input("MeanGrad")
        mg_out = rho * mg + (1.0 - rho) * g
        mom_out = mu * mom + lr * g / torch.sqrt(ms_out - mg_out.square()
                                                 + eps)
        ctx.set_output("MeanGradOut", mg_out)
    else:
        mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    ctx.set_output("ParamOut", p - mom_out)
    ctx.set_output("MeanSquareOut", ms_out)
    ctx.set_output("MomentOut", mom_out)


@register_op("ftrl", no_grad=True)
def ftrl(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    sq_acc = ctx.input("SquaredAccumulator")
    lin_acc = ctx.input("LinearAccumulator")
    tiny = _const(1e-10, p)
    l1 = _const(_const(ctx.attr("l1", 0.0), p) + tiny, p)
    l2 = _const(_const(ctx.attr("l2", 0.0), p) + tiny, p)
    power = -_const(ctx.attr("lr_power", -0.5), p)
    lr = _lr(ctx, p)
    new_sq = sq_acc + g.square()
    sigma = (torch.pow(new_sq, power) - torch.pow(sq_acc, power)) / lr
    lin_out = lin_acc + g - sigma * p
    quad = torch.pow(new_sq, power) / lr + 2.0 * l2
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    ctx.set_output("ParamOut", pre / quad)
    ctx.set_output("SquaredAccumOut", new_sq)
    ctx.set_output("LinearAccumOut", lin_out)


def _proximal_shrink(prox_param, lr, l1, l2):
    """FOBOS soft threshold: sign(z) max(|z| - lr l1, 0) / (1 + lr l2);
    without l1, plain scaling.  Shared by both proximal ops."""
    if l1 > 0.0:
        return (torch.sign(prox_param)
                * torch.clamp_min(prox_param.abs() - lr * l1, 0.0)
                / (1.0 + lr * l2))
    return prox_param / (1.0 + lr * l2)


@register_op("proximal_gd", no_grad=True)
def proximal_gd(ctx):
    """prox = p - lr g, then the l1/l2 proximal shrink."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = _lr(ctx, p)
    ctx.set_output("ParamOut", _proximal_shrink(
        p - lr * g, lr, float(ctx.attr("l1", 0.0)),
        float(ctx.attr("l2", 0.0))))


@register_op("proximal_adagrad", no_grad=True)
def proximal_adagrad(ctx):
    """An adagrad-scaled step, then the proximal shrink.  An element whose
    moment is exactly 0 (a gradient 0 since init) takes a zero step
    instead of 0/sqrt(0), as in the JAX package."""
    p, g, mom = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    lr = _lr(ctx, p)
    m_out = mom + g.square()
    live = m_out > 0.0
    step = torch.where(live, g, 0.0) / torch.sqrt(
        torch.where(live, m_out, 1.0))
    ctx.set_output("ParamOut", _proximal_shrink(
        p - lr * step, lr, float(ctx.attr("l1", 0.0)),
        float(ctx.attr("l2", 0.0))))
    ctx.set_output("MomentOut", m_out)


@register_op("average_accumulates", no_grad=True)
def average_accumulates(ctx):
    """ModelAverage's per-step state (average_accumulates_op.cc): sum_1
    takes the live window, rolls into sum_2 every 16384 updates, and the
    whole state shifts into sum_3 when the window is full; the counters
    reset with it."""
    p = ctx.input("Param")
    sum_1, sum_2, sum_3 = (ctx.input("InSum1"), ctx.input("InSum2"),
                           ctx.input("InSum3"))
    num_acc = ctx.input("InNumAccumulates")
    old_num = ctx.input("InOldNumAccumulates")
    num_upd = ctx.input("InNumUpdates")
    avg_window = ctx.attr("average_window", 0.15)
    max_avg = ctx.attr("max_average_window", 10000)
    min_avg = ctx.attr("min_average_window", 10000)
    k_max = 16384  # kMaxNumAccumulates

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    sum_1 = sum_1 + p.to(sum_1.dtype)
    roll = (num_upd % k_max) == 0
    sum_2 = torch.where(roll, sum_2 + sum_1, sum_2)
    sum_1 = torch.where(roll, torch.zeros_like(sum_1), sum_1)
    window = torch.clamp_max(num_upd.float() * float(avg_window),
                             float(max_avg))
    shift = (num_acc >= min_avg) & (num_acc.float() >= window)
    sum_3 = torch.where(shift, sum_1 + sum_2, sum_3)
    sum_1 = torch.where(shift, torch.zeros_like(sum_1), sum_1)
    sum_2 = torch.where(shift, torch.zeros_like(sum_2), sum_2)
    old_num = torch.where(shift, num_acc, old_num)
    num_acc = torch.where(shift, torch.zeros_like(num_acc), num_acc)

    ctx.set_output("OutSum1", sum_1)
    ctx.set_output("OutSum2", sum_2)
    ctx.set_output("OutSum3", sum_3)
    ctx.set_output("OutNumAccumulates", num_acc)
    ctx.set_output("OutOldNumAccumulates", old_num)
    ctx.set_output("OutNumUpdates", num_upd)
