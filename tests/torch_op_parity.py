"""Shared harness of the op-tail parity tests: one op through both
packages, forward by each registry's `run_forward`, grads through each
package's `append_backward` and `Executor` on the CPU.

Integer outputs compare exactly, float32 ones at atol 1e-5 (the JAX
package narrows int64 to int32 with x64 off, so integer dtypes are read
as one kind).  Grads: X (a var per input that takes a gradient) -> the
op -> the sum over its float outputs of reduce_sum(out * cot), one random
cotangent per output, then `append_backward`; the two packages' programs
must be the same op for op, and the outputs and input grads agree at
rtol 1e-4 / atol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import registry as preg

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BOTH = ((fluid, jun.guard), (pt, pt.unique_name.guard))


def optest_case(cls):
    """(inputs, attrs) of a JAX package OpTest class, inputs as
    {param: [array, ...]} (its list-of-(name, array) form flattened)."""
    case = cls()
    case.setup()
    inputs = {}
    for param, arrs in case.inputs.items():
        entries = arrs if isinstance(arrs, list) else [(param, arrs)]
        inputs[param] = [np.asarray(a) for _, a in entries]
    return inputs, dict(getattr(case, "attrs", {}) or {})


def run_both(op_type, inputs, attrs, out_names=None):
    """-> (jax outs, port outs), each {param: [ndarray | None]}."""
    j_in = {p: [None if a is None else jnp.asarray(a) for a in lst]
            for p, lst in inputs.items()}
    p_in = {p: [None if a is None else torch.as_tensor(np.array(a))
                for a in lst]
            for p, lst in inputs.items()}
    info = jreg.get_op_info(op_type)

    def forward(ins):
        return jreg.run_forward(info, ins, dict(attrs), out_names=out_names)

    # one compiled program: far cheaper than the op's primitives compiled
    # one by one; host-shaped (no_jit) ops run eagerly
    j_out = forward(j_in) if info.no_jit else jax.jit(forward)(j_in)
    p_out = preg.run_forward(preg.get_op_info(op_type), p_in, dict(attrs),
                             out_names=out_names, device=torch.device("cpu"))

    def host(outs, conv):
        return {k: [None if o is None else conv(o) for o in v]
                for k, v in outs.items()}

    return (host(j_out, np.asarray),
            host(p_out, lambda t: t.detach().numpy()))


def assert_same_arrays(got, want, what, atol=ATOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert got.dtype.kind == want.dtype.kind, (what, got.dtype,
                                                   want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=0,
                                   atol=atol, err_msg=what)


def assert_forward(op_type, inputs, attrs, out_names=None, atol=ATOL,
                   skip=()):
    """Every output of `op_type` equal in both packages; `skip`: output
    params whose values are not compared (their shapes are)."""
    j, p = run_both(op_type, inputs, attrs, out_names)
    assert sorted(j) == sorted(p), (sorted(j), sorted(p))
    for param in j:
        assert len(j[param]) == len(p[param]), param
        for i, (a, b) in enumerate(zip(j[param], p[param])):
            if param in skip:
                assert a.shape == b.shape, (param, a.shape, b.shape)
                continue
            assert_same_arrays(b, a, f"{op_type}.{param}[{i}]", atol)
    return j, p


def _normalized(prog):
    """The program dict with the dtypes the JAX package's shape inference
    narrows with x64 off read as their narrow kind: int64 and int32 as
    one, float64 (auc's AUC) as float32."""
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
            elif v["dtype"] == "float64":
                v["dtype"] = "float32"
    return d


def assert_same_program(jprog, pprog):
    """The same program dict, op for op (see `_normalized`)."""
    jd, pd = _normalized(jprog), _normalized(pprog)
    jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in pops] == [o["type"] for o in jops]
    for jo, po in zip(jops, pops):
        assert po == jo, jo["type"]
    assert pd == jd


def _build_grad(pkg, guard, op_type, inputs, attrs, diff, outs,
                more_outs=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        block = main.global_block()
        ivars = {}
        for param, arrs in inputs.items():
            ivars[param] = [block.create_var(
                name=f"{param}_{i}", shape=list(a.shape),
                dtype=str(a.dtype), stop_gradient=param not in diff)
                for i, a in enumerate(arrs)]
        every = dict(more_outs or {}, **outs)
        ovars = {param: [block.create_var(name=f"out_{param}_{i}",
                                          dtype="float32")
                         for i in range(n)]
                 for param, n in every.items()}
        block.append_op(type=op_type, inputs=ivars, outputs=ovars,
                        attrs=dict(attrs))
        terms = []
        for param, vs in ovars.items():
            if param not in outs:
                continue
            for v in vs:
                cot = block.create_var(name=f"cot_{v.name}",
                                       shape=list(v.shape), dtype=v.dtype,
                                       stop_gradient=True)
                terms.append(pkg.layers.reduce_sum(
                    pkg.layers.elementwise_mul(v, cot)))
        loss = terms[0] if len(terms) == 1 else pkg.layers.sums(terms)
        pkg.append_backward(loss)
    return main, {p: vs for p, vs in ovars.items() if p in outs}


def assert_grads(op_type, inputs, attrs, diff, outs, seed=0,
                 rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """`outs`: {output param: count} of the float outputs the loss reads;
    `diff`: the input params that take a gradient.  Builds the same
    program in both packages, runs each package's Executor on the same
    feed and compares the outputs and every input grad of `diff`, all at
    rtol/atol."""
    return assert_op_and_grads(op_type, inputs, attrs, diff, outs, seed=seed,
                               rtol=rtol, atol=atol, grad_rtol=rtol,
                               grad_atol=atol)


def assert_op_and_grads(op_type, inputs, attrs, diff, outs, more_outs=None,
                        seed=0, rtol=1e-5, atol=1e-6, grad_rtol=GRAD_RTOL,
                        grad_atol=GRAD_ATOL):
    """`assert_grads` in one program a package, every output of the op
    fetched: the outputs in `outs` (the loss's) and `more_outs` (read by
    nothing) within rtol/atol (integer ones equal), the input grads of
    `diff` within grad_rtol/grad_atol.  -> {name: port value}."""
    jm, jouts = _build_grad(fluid, jun.guard, op_type, inputs, attrs, diff,
                            outs, more_outs)
    pm, _ = _build_grad(pt, pt.unique_name.guard, op_type, inputs, attrs,
                        diff, outs, more_outs)
    assert_same_program(jm, pm)
    rng = np.random.RandomState(seed)
    feed = {f"{p}_{i}": a for p, arrs in inputs.items()
            for i, a in enumerate(arrs)}
    for vs in jouts.values():
        for v in vs:
            feed[f"cot_{v.name}"] = rng.standard_normal(
                tuple(v.shape)).astype(np.float32)
    outs_fetch = [f"out_{p}_{i}"
                  for p, n in dict(more_outs or {}, **outs).items()
                  for i in range(n)]
    grads = [f"{p}_{i}@GRAD" for p in diff for i in range(len(inputs[p]))]
    want = [np.asarray(a) for a in fluid.Executor(fluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=outs_fetch + grads, scope=JScope())]
    got = pt.Executor(pt.CPUPlace()).run(
        pm, feed=feed, fetch_list=outs_fetch + grads, scope=pt.Scope())
    for k, (name, g, w) in enumerate(zip(outs_fetch + grads, got, want,
                                         strict=True)):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        what = f"{op_type}: {name}"
        if w.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind, (what, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=what)
        elif k < len(outs_fetch):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=grad_rtol, atol=grad_atol,
                                       err_msg=what)
    return dict(zip(outs_fetch + grads, got))


# ------------------------------------------- whole programs in both packages


def normalized_ints(prog):
    """`_normalized`, with an attr naming an integer dtype (cast's
    in_dtype) read as one kind too."""
    d = _normalized(prog)
    for blk in d["blocks"]:
        for op in blk["ops"]:
            for k, v in op["attrs"].items():
                if v in ("int32", "int64"):
                    op["attrs"][k] = "int"
    return d


def build_program(pkg, guard, fn, seed=13):
    """(main, startup, fn(pkg)): `fn` builds into fresh programs."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), guard():
        out = fn(pkg)
    return main, startup, out


def _var_name(v):
    return v if isinstance(v, str) else v.name


def run_programs_both(fn, feed, fetch_of, steps=1, seed=13, mode=None):
    """Build `fn` in both packages, check the program dicts (sub-blocks
    included), run the JAX startup, carry its persistables into the port
    (`convert.load_params`) and run both `steps` times -> (JAX outputs,
    port outputs), a list of arrays a step.  `fetch_of(fn's result)`
    names what to fetch; `mode` is the port Executor's."""
    from paddle_tpu_torch import convert

    (jm, js, jo), (pm, ps, po) = (build_program(pkg, g, fn, seed)
                                  for pkg, g in BOTH)
    assert normalized_ints(pm) == normalized_ints(jm)
    jscope, pscope = JScope(), pt.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in js.list_vars() if v.persistable
              and jscope.find_var(v.name) is not None}
    convert.load_params(pscope, params, pt.CPUPlace(), [pm])
    pexe = pt.Executor(pt.CPUPlace(), mode=mode)
    jf = [_var_name(v) for v in fetch_of(jo)]
    pf = [_var_name(v) for v in fetch_of(po)]
    want, got = [], []
    for _ in range(steps):
        want.append([np.asarray(a) for a in jexe.run(
            jm, feed=feed, fetch_list=jf, scope=jscope)])
        got.append(pexe.run(pm, feed=feed, fetch_list=pf, scope=pscope))
    return want, got


def assert_steps_close(got, want, atol=ATOL, rtol=0.0):
    """Every step's every output: the same shape, within atol + rtol."""
    for step_g, step_w in zip(got, want, strict=True):
        for g, w in zip(step_g, step_w, strict=True):
            assert g.shape == w.shape, (g.shape, w.shape)
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=rtol,
                                       atol=atol)

