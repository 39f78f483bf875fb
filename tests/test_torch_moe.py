"""The mixture-of-experts tier against the JAX package (the twins of
tests/test_moe.py): `expert_capacity`, the two ops and their grads, the
builders, the MoE transformer and BERT trained from the same weights, the
program scanners and the load monitor, and the decode path.

The same numpy inputs, from a seed, go through both packages on the CPU.
Tolerances: gating Indices, Positions, Load and Dropped equal, Gates and
AuxLoss 1e-6, its logits grad 1e-5; the expert FFN rtol 1e-5 forward and
rtol 1e-4 / atol 1e-5 for its grads; the models' loss and every parameter
grad rtol 1e-4 / atol 1e-5 and 3 Adam losses rtol 2e-4; greedy tokens
equal.  The models are transformer.tiny_moe and bert.tiny_moe (head_dim
16: every attention takes the composite), their weights the JAX startup's
carried with `convert.load_params`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import decode as jdecode
from paddle_tpu import moe as jmoe
from paddle_tpu import telemetry as jtelem
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import bert as JB
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops.moe_ops import expert_capacity as j_capacity
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, moe as pmoe
from paddle_tpu_torch import serving, telemetry as ptelem, testing
from paddle_tpu_torch.models import bert as PB
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops.moe_ops import expert_capacity as p_capacity

import torch_op_parity as P

CPU = pt.CPUPlace()
GATING_OUTS = {"Gates": ["g"], "Indices": ["i"], "Positions": ["p"],
               "AuxLoss": ["a"], "Load": ["l"], "Dropped": ["d"]}
LR, STEPS = 1e-3, 3


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


# ------------------------------------------------------------- capacity


@pytest.mark.parametrize("cf", [0.0, -1.0, None, math.inf, math.nan, 0.01,
                                0.25, 0.5, 1.0, 1.25, 2.0, 100.0])
def test_expert_capacity_equals_the_jax_packages(cf):
    for n in (1, 7, 10, 64, 1000):
        for e in (1, 4, 8):
            for k in (1, 2):
                assert p_capacity(n, e, k, cf) == j_capacity(n, e, k, cf), \
                    (n, e, k, cf)


# ---------------------------------------------------------- top_k_gating


def _logits(kind, n=24, e=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, e).astype(np.float32)
    if kind == "ties":
        # integer logits: equal probabilities in most rows, often for the
        # top two and across the top-k boundary
        x = np.round(rng.randn(n, e)).astype(np.float32)
        x[::3] = 0.0                     # rows of all-equal experts
    elif kind == "skewed":
        x[:, 0] += 3.0                   # capacity bites on expert 0
    return x


@pytest.mark.parametrize("kind,cf,k,renorm", [
    ("random", 0.0, 2, True), ("random", 1.25, 2, True),
    ("skewed", 0.5, 2, True), ("skewed", 0.25, 1, False),
    ("ties", 0.5, 2, True), ("ties", 0.0, 3, True), ("ties", 1.0, 2, False),
])
def test_gating_forward_equals_the_jax_packages(kind, cf, k, renorm):
    x = _logits(kind)
    j, p = P.run_both("top_k_gating", {"Logits": [x]},
                      {"k": k, "capacity_factor": cf, "renormalize": renorm},
                      out_names=GATING_OUTS)
    for param in ("Indices", "Positions", "Load", "Dropped"):
        np.testing.assert_array_equal(p[param][0], j[param][0],
                                      err_msg=param)
    for param in ("Gates", "AuxLoss"):
        np.testing.assert_allclose(p[param][0], j[param][0], rtol=0,
                                   atol=1e-6, err_msg=param)
    assert p["Indices"][0].dtype == p["Positions"][0].dtype == np.int32
    assert p["Load"][0].dtype == p["Dropped"][0].dtype == np.float32
    dropped = float(p["Dropped"][0][0])
    assert float(p["Load"][0].sum()) + dropped == x.shape[0] * k
    if cf > 0 and kind == "skewed":
        assert dropped > 0
    if cf <= 0:
        assert dropped == 0


def test_gating_ties_take_the_lower_expert_first():
    x = np.zeros((3, 4), np.float32)
    x[1] = [1.0, 2.0, 2.0, 2.0]
    _, p = P.run_both("top_k_gating", {"Logits": [x]},
                      {"k": 2, "capacity_factor": 0.0},
                      out_names=GATING_OUTS)
    np.testing.assert_array_equal(p["Indices"][0],
                                  [[0, 1], [1, 2], [0, 1]])
    # slot-major: every first choice ranks ahead of every second, so row
    # 0's second choice (expert 1) comes after row 1's first
    np.testing.assert_array_equal(p["Positions"][0],
                                  [[0, 1], [0, 0], [1, 2]])


def test_gating_leading_dims_route_as_one_token_axis():
    x = _logits("skewed", n=30)
    attrs = {"k": 2, "capacity_factor": 0.5}
    _, flat = P.run_both("top_k_gating", {"Logits": [x]}, attrs,
                         out_names=GATING_OUTS)
    j, nested = P.run_both("top_k_gating", {"Logits": [x.reshape(5, 6, 4)]},
                           attrs, out_names=GATING_OUTS)
    for param in ("Gates", "Indices", "Positions"):
        assert nested[param][0].shape == (5, 6, 2)
        np.testing.assert_array_equal(nested[param][0].reshape(30, 2),
                                      flat[param][0])
        np.testing.assert_allclose(nested[param][0], j[param][0], rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("outs", [("Gates", "AuxLoss"), ("Gates",),
                                  ("AuxLoss",)])
@pytest.mark.parametrize("kind,cf", [("skewed", 0.5), ("ties", 0.0)])
def test_gating_logits_grad_equals_the_jax_packages(outs, kind, cf):
    """The loss reads only `outs`: the other float output's cotangent is
    missing and counts as zeros."""
    more = {p: 1 for p in GATING_OUTS if p not in outs}
    P.assert_op_and_grads("top_k_gating", {"Logits": [_logits(kind)]},
                          {"k": 2, "capacity_factor": cf}, ["Logits"],
                          {p: 1 for p in outs}, more_outs=more, rtol=0,
                          atol=1e-6, grad_rtol=0, grad_atol=1e-5)


# --------------------------------------------------------- moe_expert_ffn


def _ffn_inputs(n=24, d=6, f=8, e=4, k=2, cf=0.5, seed=1):
    rng = np.random.RandomState(seed)
    x = _logits("skewed", n=n, e=e, seed=seed)
    j, _ = P.run_both("top_k_gating", {"Logits": [x]},
                      {"k": k, "capacity_factor": cf}, out_names=GATING_OUTS)
    inputs = {"X": [rng.randn(n, d).astype(np.float32)],
              "Gates": [j["Gates"][0]],
              "Indices": [j["Indices"][0].astype(np.int32)],
              "Positions": [j["Positions"][0].astype(np.int32)],
              "W1": [rng.randn(e, d, f).astype(np.float32)],
              "B1": [rng.randn(e, f).astype(np.float32)],
              "W2": [rng.randn(e, f, d).astype(np.float32)],
              "B2": [rng.randn(e, d).astype(np.float32)]}
    return inputs, float(j["Dropped"][0][0])


@pytest.mark.parametrize("act,cf", [("relu", 0.5), ("gelu", 0.5),
                                    (None, 0.5), ("relu", 0.0)])
def test_expert_ffn_and_its_grads_equal_the_jax_packages(act, cf):
    inputs, dropped = _ffn_inputs(cf=cf)
    assert (dropped > 0) == (cf > 0)
    got = P.assert_op_and_grads(
        "moe_expert_ffn", inputs, {"k": 2, "capacity_factor": cf,
                                   "act": act},
        ["X", "Gates", "W1", "B1", "W2", "B2"], {"Out": 1}, rtol=1e-5,
        atol=1e-6)
    # a token whose both assignments dropped keeps only its residual
    keep = inputs["Positions"][0] < p_capacity(24, 4, 2, cf)
    gone = ~keep.any(axis=1)
    if gone.any():
        np.testing.assert_array_equal(got["out_Out_0"][gone], 0.0)


def _moe_ffn_program(pkg, guard, shape, experts, d_inner, top_k, cf,
                     act="relu", seed=11):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), guard():
        x = pkg.layers.data("x", shape=shape, dtype="float32")
        out, aux = pkg.layers.moe_ffn(x, num_experts=experts,
                                      d_inner=d_inner, top_k=top_k,
                                      capacity_factor=cf, act=act, name="m")
    return main, startup, out, aux


def _run_port(main, startup, feed, fetch, params=None):
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    for name, value in (params or {}).items():
        scope.set_var(name, torch.as_tensor(value))
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_single_expert_equals_the_dense_ffn():
    rng = np.random.RandomState(2)
    n, d, f = 8, 6, 10
    xv = rng.randn(n, d).astype(np.float32)
    main, startup, out, _ = _moe_ffn_program(pt, pt.unique_name.guard, [d],
                                             1, f, 1, 0.0)
    w = {"m_moe_w1": rng.randn(1, d, f), "m_moe_b1": rng.randn(1, f),
         "m_moe_w2": rng.randn(1, f, d), "m_moe_b2": rng.randn(1, d)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    (got,) = _run_port(main, startup, {"x": xv}, [out], w)
    want = np.maximum(xv @ w["m_moe_w1"][0] + w["m_moe_b1"][0], 0.0) \
        @ w["m_moe_w2"][0] + w["m_moe_b2"][0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_leading_dims_route_like_the_flat_batch():
    rng = np.random.RandomState(3)
    b, s, d = 3, 5, 8
    xv = rng.randn(b, s, d).astype(np.float32)
    w = {f"m_moe_{p}": rng.randn(*shape).astype(np.float32)
         for p, shape in (("w1", (4, d, 6)), ("b1", (4, 6)),
                          ("w2", (4, 6, d)), ("b2", (4, d)))}
    w["m_gate.w_0"] = rng.randn(d, 4).astype(np.float32)
    outs = []
    for shape, feed in (([d], xv.reshape(b * s, d)), ([s, d], xv)):
        with testing.fresh_programs():
            main, startup, out, _ = _moe_ffn_program(
                pt, pt.unique_name.guard, shape, 4, 6, 2, 0.5)
            outs.append(_run_port(main, startup, {"x": feed}, [out], w)[0])
    np.testing.assert_array_equal(outs[1].reshape(b * s, d), outs[0])


@pytest.mark.parametrize("shape,cf,act", [([6], 1.25, "relu"),
                                          ([5, 6], math.inf, "gelu")])
def test_moe_ffn_builds_the_jax_program(shape, cf, act):
    (jm, js, jo, ja), (pm, ps, po, pa) = (
        _moe_ffn_program(pkg, guard, shape, 4, 8, 2, cf, act)
        for pkg, guard in P.BOTH)
    P.assert_same_program(jm, pm)
    P.assert_same_program(js, ps)
    params = {v.name: tuple(v.shape)
              for v in pm.global_block().all_parameters()}
    assert params == {"m_gate.w_0": (6, 4), "m_moe_w1": (4, 6, 8),
                      "m_moe_b1": (4, 8), "m_moe_w2": (4, 8, 6),
                      "m_moe_b2": (4, 6)}
    (gating,) = [op for op in pm.global_block().ops
                 if op.type == "top_k_gating"]
    assert gating.attr("capacity_factor") == (0.0 if cf == math.inf
                                              else cf)
    blk = pm.global_block()
    assert blk.var(gating.output("Indices")[0]).stop_gradient
    assert blk.var(gating.output("Load")[0]).stop_gradient
    assert not blk.var(gating.output("Gates")[0]).stop_gradient
    assert (po.name, pa.name) == (jo.name, ja.name)


# ------------------------------------------------------ the MoE models


def _params(scope, program):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in program.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


def _train_both(build, feed, steps=STEPS):
    """`build(pkg)` -> loss in fresh programs of each package, with Adam;
    the port starts from the JAX startup's persistables.  -> (JAX, port)
    each (losses, first step's grads by name)."""
    built = []
    for pkg, guard in P.BOTH:
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup), guard():
            loss = build(pkg)
            _, pg = pkg.optimizer.Adam(LR).minimize(loss)
        built.append((main, startup, loss, [g.name for _, g in pg]))
    (jm, js, jl, jg), (pm, _, pl, pg) = built
    assert P.normalized_ints(pm) == P.normalized_ints(jm)
    assert jg == pg
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    pscope, pexe = pt.Scope(), pt.Executor(CPU)
    convert.load_params(pscope, _params(jscope, jm), CPU, [pm])
    runs = []
    for run in (lambda f: jexe.run(jm, feed=feed, fetch_list=f,
                                   scope=jscope),
                lambda f: pexe.run(pm, feed=feed, fetch_list=f,
                                   scope=pscope)):
        losses, grads = [], None
        for step in range(steps):
            outs = [np.asarray(o, np.float32)
                    for o in run([jl.name] + jg)]
            losses.append(float(outs[0].ravel()[0]))
            if not step:
                grads = dict(zip(jg, outs[1:]))
        runs.append((losses, grads))
    return runs


def _assert_trained_alike(runs, n_gates):
    (jl, jgrads), (pl, pgrads) = runs
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-4)
    assert sum("_moe_w1" in n for n in pgrads) == n_gates
    assert sum("_gate.w_0" in n for n in pgrads) == n_gates
    for name, want in jgrads.items():
        np.testing.assert_allclose(pgrads[name], want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert pl[-1] < pl[0]


def test_moe_transformer_trains_as_the_jax_packages():
    cfg = dict(vocab=64, max_length=12)
    feed = JT.synthetic_batch(4, JT.tiny_moe(**cfg), seed=3)

    def build(pkg):
        T = JT if pkg is fluid else PT
        loss, _ = T.build(T.tiny_moe(**cfg))
        aux = (jmoe if pkg is fluid else pmoe).collect_aux_losses()
        assert len(aux) == 4
        return loss

    _assert_trained_alike(_train_both(build, feed), 4)


def test_moe_bert_trains_as_the_jax_packages():
    feed = JB.synthetic_batch(4, JB.tiny_moe(), seed=3)

    def build(pkg):
        B = JB if pkg is fluid else PB
        return B.build(B.tiny_moe())[0]

    _assert_trained_alike(_train_both(build, feed), 2)


def test_expert_major_weights_keep_their_layout_through_load_params():
    main, startup, _, _ = _moe_ffn_program(pt, pt.unique_name.guard, [6], 4,
                                           8, 2, 1.25)
    w1 = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    params = {"m_moe_w1": w1, "m_moe_b1": np.zeros((4, 8), np.float32),
              "m_moe_w2": np.zeros((4, 8, 6), np.float32),
              "m_moe_b2": np.zeros((4, 6), np.float32),
              "m_gate.w_0": np.zeros((6, 4), np.float32)}
    scope = pt.Scope()
    convert.load_params(scope, params, CPU, [main])
    np.testing.assert_array_equal(scope.find_var("m_moe_w1").numpy(), w1)
    with pytest.raises(ValueError, match="shape"):
        convert.load_params(scope, dict(params, m_moe_w1=w1.transpose(
            0, 2, 1)), CPU, [main])


# ------------------------------------------- scanners, monitor, telemetry


def test_program_scanners_give_the_jax_packages_names():
    built = []
    for pkg, guard in P.BOTH:
        T = JT if pkg is fluid else PT
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), guard():
            T.build(T.tiny_moe(vocab=64, max_length=8))
        built.append(main)
    jm, pm = built
    assert [v.name for v in pmoe.collect_aux_losses(pm)] == \
        [v.name for v in jmoe.collect_aux_losses(jm)]
    assert pmoe.gating_fetches(pm) == jmoe.gating_fetches(jm)
    assert len(pmoe.gating_fetches(pm)[0]) == 4
    jp, pp = (mod.placements_for_program(m, 2)
              for mod, m in ((jmoe, jm), (pmoe, pm)))
    assert list(pp) == list(jp) == ["enc0_ffn", "enc1_ffn", "dec0_ffn",
                                    "dec1_ffn"]
    for name in pp:
        assert pp[name].to_meta() == jp[name].to_meta()
        np.testing.assert_array_equal(pp[name].owner_of(np.arange(4)),
                                      np.arange(4) % 2)


def test_placement_rebalance_and_meta_equal_the_jax_packages():
    loads = [10.0, 1.0, 1.0, 7.0, 3.0, 3.0]
    jp = jmoe.ExpertPlacement(6, 3, param_names=["a", "b"])
    pp = pmoe.ExpertPlacement(6, 3, param_names=["a", "b"])
    assert pp.rebalance(loads) == jp.rebalance(loads)
    assert pp.epoch == jp.epoch == 1
    assert pp.to_meta() == jp.to_meta()
    other = pmoe.ExpertPlacement(6, 3)
    other.load_meta(jp.to_meta())
    assert other.epoch == 1 and other.param_names == ["a", "b"]
    with pytest.raises(ValueError, match="experts"):
        pmoe.ExpertPlacement(4, 3).load_meta(pp.to_meta())
    with pytest.raises(ValueError, match="shards"):
        pmoe.ExpertPlacement(6, 2).load_meta(pp.to_meta())


@pytest.fixture
def telemetry_on():
    for t in (jtelem, ptelem):
        t.enable()
        t.reset_metrics()
    yield
    for t in (jtelem, ptelem):
        t.reset_metrics()
        t.disable()


def test_load_monitor_walks_the_jax_packages_states(telemetry_on):
    """tests/test_moe.py's drill on both monitors: sustained 50% drops
    walk the EWMA to overloaded, drop-free steps back to ok; the port's
    monitor also takes card-style tensors."""
    jm, pm = jmoe.MoeLoadMonitor(), pmoe.MoeLoadMonitor()
    assert pm.load_signal() == jm.load_signal()
    assert pm.load_signal()["state"] == "ok"
    seen = set()
    for loads, dropped, n in (([4.0, 4.0], 8.0, 30), ([8.0, 8.0], 0.0, 60),
                              ([12.0, 4.0], 2.0, 3)):
        for _ in range(n):
            jm.observe([np.array(loads)], dropped)
            pm.observe([torch.tensor(loads)], torch.tensor([dropped]))
            got, want = pm.load_signal(), jm.load_signal()
            seen.add(got.pop("state"))
            assert seen.issuperset({want.pop("state")})
            assert got == pytest.approx(want)
    assert seen == {"ok", "pressured", "overloaded"}
    assert pm.total_dropped == 246 and pm.steps == 93
    psnap, jsnap = ptelem.snapshot(), jtelem.snapshot()
    assert psnap["counters"]["moe.tokens_dropped"] == \
        jsnap["counters"]["moe.tokens_dropped"] == 246
    assert psnap["gauges"]["moe.expert_load"] == \
        jsnap["gauges"]["moe.expert_load"] == 1.5


def test_step_monitor_skips_names_a_step_does_not_fetch():
    mon, notify = pmoe.step_monitor(["l0", "l1"], ["d0", "d1"])
    assert notify.monitor is mon
    notify({"l0": torch.tensor([3.0, 1.0], dtype=torch.bfloat16),
            "d0": torch.tensor([0.0])})
    assert mon.steps == 1 and mon.imbalance == 1.5
    notify({"other": torch.zeros(1)})
    assert mon.steps == 1


# ----------------------------------------------------------------- decode

S, PREFIX, MAXLEN, V, NEW = 6, 2, 20, 40, 8


def _decode_cfg(T):
    cfg = T.tiny_moe(vocab=V, max_length=16)
    cfg.n_layer = 1
    return cfg


def _decode_feed(seed):
    r = np.random.RandomState(seed)
    return {"src_ids": r.randint(2, V, (1, S)).astype(np.int64),
            "src_lens": np.full(1, S, np.int64),
            "trg_ids": r.randint(2, V, (1, PREFIX)).astype(np.int64),
            "prefix_lens": np.full(1, PREFIX, np.int64)}


@pytest.fixture(scope="module")
def decode_world():
    """Both packages' MoE decode specs, the JAX startup's weights (times
    3, so that greedy tokens do not collapse onto one id) in both
    scopes, and the JAX Generator's greedy tokens."""
    with testing.fresh_programs():
        with jun.guard():
            jspec = JT.build_decode(_decode_cfg(JT), src_len=S,
                                    prefix_len=PREFIX, max_len=MAXLEN)
        jscope = JScope()
        jgen = jdecode.Generator(jspec, scope=jscope)
        spec = PT.build_decode(_decode_cfg(PT), src_len=S, prefix_len=PREFIX,
                               max_len=MAXLEN)
        progs = [spec.prefill_program, spec.step_program]
        declared = {v.name for p in progs for v in p.list_vars()
                    if v.persistable}
        for n in jscope.local_var_names():
            if n.endswith(".w_0") or "_moe_w" in n or n == "src_word_emb":
                jscope.set_var(n, jnp.asarray(jscope.find_var(n)) * 3.0)
        params = {n: np.asarray(jscope.find_var(n))
                  for n in jscope.local_var_names() if n in declared}
        scope = pt.Scope()
        convert.load_params(scope, params, CPU, progs)
        feeds = [_decode_feed(200 + i) for i in range(4)]
        jtoks = [np.asarray(jgen.generate(f, NEW, eos_id=-1))[0].tolist()
                 for f in feeds]
        return dict(jspec=jspec, spec=spec, scope=scope, feeds=feeds,
                    jtoks=jtoks)


def test_build_decode_serves_at_infinite_capacity_with_the_monitor():
    jspec = JT.build_decode(_decode_cfg(JT), src_len=S, prefix_len=PREFIX,
                            max_len=MAXLEN)
    spec = PT.build_decode(_decode_cfg(PT), src_len=S, prefix_len=PREFIX,
                           max_len=MAXLEN)
    assert spec.monitor is not None
    assert isinstance(spec.monitor.monitor, pmoe.MoeLoadMonitor)
    assert spec.monitor_fetches == jspec.monitor_fetches
    assert len(spec.monitor_fetches) == 2     # the step: dec0 Load, Dropped
    for prog in (spec.prefill_program, spec.step_program):
        cfs = [op.attr("capacity_factor") for op in prog.global_block().ops
               if op.type in ("top_k_gating", "moe_expert_ffn")]
        assert cfs and all(cf == 0.0 for cf in cfs)
    assert P.normalized_ints(spec.step_program) == \
        P.normalized_ints(jspec.step_program)


def test_greedy_tokens_equal_the_jax_generators(decode_world):
    w = decode_world
    gen = pdecode.Generator(w["spec"], scope=w["scope"], place=CPU)
    toks = [gen.generate(f, NEW, eos_id=-1)[0].tolist() for f in w["feeds"]]
    assert toks == w["jtoks"]
    assert len({t for row in toks for t in row}) > 2
    mon = w["spec"].monitor.monitor
    assert mon.steps >= 4 * (NEW - 1)
    assert mon.total_dropped == 0 and mon.load_signal()["state"] == "ok"


@pytest.mark.parametrize("paged_kv", [False, True])
def test_scheduler_equals_the_sequential_generator(decode_world, paged_kv):
    """Both pool paths: every request's tokens are the sequential
    Generator's (the JAX one's too), nothing drops, and the monitor
    observes every step, the paged rewrite's included."""
    w = decode_world
    mon = w["spec"].monitor.monitor
    sched = serving.Scheduler(w["spec"], scope=w["scope"], place=CPU,
                              max_batch=4, block_size=4, num_blocks=64,
                              paged_kv=paged_kv)
    try:
        before = mon.steps
        reqs = [sched.submit(f, NEW, eos_id=-1) for f in w["feeds"]]
        sched.run_until_idle(max_steps=1000)
        assert [r.status for r in reqs] == ["done"] * 4
        assert [list(r.tokens) for r in reqs] == w["jtoks"]
        assert mon.steps - before == sched.counters["steps"] > 0
        assert mon.total_dropped == 0
    finally:
        sched.close()
