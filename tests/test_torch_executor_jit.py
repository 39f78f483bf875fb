"""The Executor's jit path against the JAX package's.

`framework.executor.build_plan` must split a block into the same segments
and host ops as the JAX package's `Executor._build_plan`, with the same
inputs (first-read order), outputs (first-production order) and
donations, for the serving programs (the dense decode step, the paged
step, the verify window and a 512-row chunk window) and for a one-layer
transformer training program after Adam.  `Executor(mode="jit")` trains
that program for 3 Adam steps from the JAX startup's persistables
(carried with `convert.load_params`) to the JAX package's jit losses,
rtol 2e-4 (the training slice's bar).  On the CPU a segment runs eagerly;
the capture of a segment is held on the card by tests/test_torch_cuda.py.

Also: the plan cache (a hit at the same signature, eviction when the
program's version moves, a new plan when a trace-affecting flag moves),
a split at a test-local `no_jit` op and `program_as_function`'s refusal of
one on the fetch path, `check_prefix_mask` still raising when it runs
eagerly, and the static-shape `append_paged` against the JAX package's
scatter with rows past the table, negative table entries and duplicate
pad rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import flags as jflags
from paddle_tpu.framework.executor import Executor as JExecutor
from paddle_tpu.framework.executor import _Segment as JSegment
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import kv_cache as jkv
from paddle_tpu.serving import paged as jpaged
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, flags as pflags, testing
from paddle_tpu_torch.framework import executor as pexe
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import kv_cache as pkv
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.serving import paged as ppaged

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
TRAIN = dict(SMALL, n_layer=1, max_length=64)
BATCH, STEPS, LR = 4, 3, 1e-3
HOST_OP = "test_host_double"


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for f in (jflags, pflags):
        f.reset("flash_attention")


# ------------------------------------------------------------ the plans


def _specs(**windows):
    kw = dict(src_len=16, prefix_len=16, max_len=1024, **windows)
    return (JT.build_decode(JT.TransformerConfig(**SMALL), **kw),
            PT.build_decode(PT.TransformerConfig(**SMALL), **kw))


def _assert_same_plan(jprog, pprog, fetch):
    jplan = JExecutor(mode="jit")._build_plan(jprog, 0, JScope(), fetch,
                                              None)
    pplan = pexe.build_plan(pprog, fetch)
    assert len(pplan) == len(jplan)
    for j, p in zip(jplan, pplan):
        if not isinstance(j, JSegment):
            assert p == j
            continue
        assert isinstance(p, pexe._Segment)
        assert p.op_indices == j.op_indices
        assert p.in_names == j.in_names
        assert p.out_names == j.out_names
        assert tuple(p.donate) == tuple(j.donate)
        assert p.stateful == j.stateful
    return pplan


def _paged(spec, build, program=None):
    return build(spec, 16, 96, program=program)


@pytest.mark.parametrize("which", ["step", "paged_step", "verify", "chunk"])
def test_serving_plans_match_jax(which):
    js, ps = _specs(verify_len=4, chunk_len=512)
    if which == "step":
        jp, pp, fetch = js.step_program, ps.step_program, js.step_fetches()
    elif which == "paged_step":
        jp = _paged(js, jpaged.build_paged_step)
        pp = _paged(ps, ppaged.build_paged_step)
        fetch = js.step_fetches()
    elif which == "verify":
        jp = _paged(js, jpaged.build_paged_step, js.verify_program)
        pp = _paged(ps, ppaged.build_paged_step, ps.verify_program)
        fetch = js.verify_fetches()
    else:
        jp = _paged(js, jpaged.build_paged_step, js.chunk_program)
        pp = _paged(ps, ppaged.build_paged_step, ps.chunk_program)
        fetch = js.chunk_fetches()
    assert fetch == getattr(ps, {"step": "step_fetches",
                                 "paged_step": "step_fetches",
                                 "verify": "verify_fetches",
                                 "chunk": "chunk_fetches"}[which])()
    plan = _assert_same_plan(jp, pp, fetch)
    assert len(plan) == 1 and sorted(plan[0].out_names) == sorted(fetch)
    if which == "chunk":   # the window's per-row position ops are in it
        assert len(plan[0].op_indices) > 3 * 512


def _jax_train_build():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), jun.guard():
        loss, _ = JT.build(JT.TransformerConfig(**TRAIN), use_src_lens=True)
        fluid.optimizer.Adam(LR).minimize(loss)
    return main, startup, loss


def _port_train_build():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = PT.build(PT.TransformerConfig(**TRAIN), use_src_lens=True)
        pt.optimizer.Adam(LR).minimize(loss)
    return main, startup, loss


def test_training_plan_matches_jax():
    jmain, _, jloss = _jax_train_build()
    pmain, _, ploss = _port_train_build()
    plan = _assert_same_plan(jmain, pmain, [jloss.name])
    (seg,) = plan
    assert ploss.name in seg.out_names and seg.donate
    params = [p.name for p in pmain.global_block().all_parameters()
              if p.trainable]
    donated = {seg.in_names[i - 1] for i in seg.donate}
    assert set(params) <= donated


def _train_feed():
    feed = JT.synthetic_batch(BATCH, JT.TransformerConfig(**TRAIN), seed=5)
    feed["src_lens"] = np.asarray([64, 50, 33, 9], np.int64)
    return feed


def test_jit_executor_trains_to_the_jax_losses():
    jmain, jstartup, jloss = _jax_train_build()
    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace(), mode="jit")
    jexe.run(jstartup, scope=jscope)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jmain.list_vars() if v.persistable}
    jlosses = [float(np.asarray(jexe.run(jmain, feed=_train_feed(),
                                         scope=jscope,
                                         fetch_list=[jloss.name])[0]))
               for _ in range(STEPS)]

    pmain, _, ploss = _port_train_build()
    scope = pt.Scope()
    convert.load_params(scope, params, pt.CPUPlace(), [pmain])
    exe = pt.Executor(pt.CPUPlace(), mode="jit")
    plosses = [float(exe.run(pmain, feed=_train_feed(), scope=scope,
                             fetch_list=[ploss])[0].ravel()[0])
               for _ in range(STEPS)]
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-4)
    assert plosses[-1] < plosses[0]
    # the jit path writes back what the JAX plan writes back: every
    # persistable the step updates, and the fetch
    (seg,) = next(iter(exe._cache.values()))
    for n in seg.out_names:
        assert scope.find_var(n) is not None, n


def test_executor_mode_reads_the_flag():
    pflags.set("executor_mode", "jit")
    try:
        assert pt.Executor(pt.CPUPlace()).mode == "jit"
    finally:
        pflags.reset("executor_mode")
    with pytest.raises(ValueError, match="interpret"):
        pt.Executor(pt.CPUPlace(), mode="xla")


# ----------------------------------------------------------- plan cache


def _scale_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        y = pt.layers.scale(x, scale=3.0)
    return main, y


def test_plan_cache_hits_evicts_and_keys_on_flags():
    main, y = _scale_program()
    exe = pt.Executor(pt.CPUPlace(), mode="jit")
    feed = {"x": np.ones((2, 4), np.float32)}
    out = exe.run(main, feed=feed, fetch_list=[y])[0]
    np.testing.assert_array_equal(out, np.full((2, 4), 3.0, np.float32))
    (key, plan), = exe._cache.items()
    exe.run(main, feed=feed, fetch_list=[y])
    assert list(exe._cache.items()) == [(key, plan)]     # a hit
    exe.run(main, feed={"x": np.ones((3, 4), np.float32)}, fetch_list=[y])
    assert len(exe._cache) == 2                         # a new feed shape
    main._bump_version()                                # a rewrite
    exe.run(main, feed=feed, fetch_list=[y])
    assert len(exe._cache) == 1
    assert next(iter(exe._cache))[1] == main.version
    pflags.set("flash_attention", "0")                  # trace-affecting
    exe.run(main, feed=feed, fetch_list=[y])
    assert len(exe._cache) == 2
    pflags.reset("flash_attention")
    exe.run(main, feed=feed, fetch_list=[y])
    assert len(exe._cache) == 2                         # toggled back: hit


# --------------------------------------------------------- no_jit ops


@pytest.fixture
def host_op():
    """A test-local no_jit op (Out = 2 X), registered for one test only so
    that the registry's census stays the port's."""
    @preg.register_op(HOST_OP, no_jit=True, no_grad=True)
    def _double(ctx):
        ctx.set_output("Out", ctx.input("X") * 2)

    preg.get_runtime_info.cache_clear()
    yield HOST_OP
    del preg.OPS[HOST_OP]
    preg.get_runtime_info.cache_clear()


def _split_program(op_type):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        a = pt.layers.scale(x, scale=3.0)
        b = main.global_block().create_var(name="b", dtype="float32",
                                           shape=[-1, 4])
        main.global_block().append_op(type=op_type, inputs={"X": [a]},
                                      outputs={"Out": [b]})
        c = pt.layers.scale(b, scale=5.0)
        d = pt.layers.scale(x, scale=7.0)
    return main, a, c, d


def test_plan_splits_at_a_no_jit_op(host_op):
    main, a, c, d = _split_program(host_op)
    plan = pexe.build_plan(main, [c.name, d.name])
    assert [type(p).__name__ if not isinstance(p, int) else p
            for p in plan] == ["_Segment", 1, "_Segment"]
    first, _, second = plan
    assert first.in_names == ["x"] and first.out_names == [a.name]
    assert second.in_names == ["b", "x"]
    assert second.out_names == [c.name, d.name]
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}
    jit = pt.Executor(pt.CPUPlace(), mode="jit").run(
        main, feed=feed, fetch_list=[c, d], scope=pt.Scope())
    eager = pt.Executor(pt.CPUPlace(), mode="interpret").run(
        main, feed=feed, fetch_list=[c, d], scope=pt.Scope())
    for j, e in zip(jit, eager):
        np.testing.assert_array_equal(j, e)
    np.testing.assert_array_equal(jit[0], feed["x"] * 30)


def test_program_as_function_refuses_a_no_jit_op_on_the_fetch_path(host_op):
    main, _, c, d = _split_program(host_op)
    with pytest.raises(ValueError, match=HOST_OP):
        pexe.program_as_function(main, pt.Scope(), [c.name], pt.CPUPlace())
    # off the fetch path the host op is pruned away, as in the JAX package
    fn = pexe.program_as_function(main, pt.Scope(), [d.name], pt.CPUPlace())
    (out,) = fn({"x": np.ones((2, 4), np.float32)})
    np.testing.assert_array_equal(out.numpy(), np.full((2, 4), 7.0))


def test_check_prefix_mask_still_raises_eagerly():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        m = pt.layers.data("m", shape=[6], dtype="float32")
        out = main.global_block().create_var(name="m_checked",
                                             dtype="float32", shape=[-1, 6])
        main.global_block().append_op(type="check_prefix_mask",
                                      inputs={"X": [m]},
                                      outputs={"Out": [out]})
    good = np.asarray([[1, 1, 1, 0, 0, 0], [1, 0, 0, 0, 0, 0]], np.float32)
    bad = np.asarray([[1, 1, 1, 0, 0, 0], [1, 0, 1, 0, 0, 0]], np.float32)
    fn = pexe.program_as_function(main, pt.Scope(), [out.name],
                                  pt.CPUPlace())
    np.testing.assert_array_equal(fn({"m": good})[0].numpy(), good)
    with pytest.raises(ValueError, match="row 1 is not a prefix mask"):
        fn({"m": bad})
    exe = pt.Executor(pt.CPUPlace(), mode="jit")
    with pytest.raises(ValueError, match="row 1 is not a prefix mask"):
        exe.run(main, feed={"m": bad}, fetch_list=[out], scope=pt.Scope())


# ------------------------------------------------- static append_paged


@pytest.mark.parametrize("case", [
    # (table rows, cursors, window): in-table writes with a duplicate pad
    # row (row 2 repeats row 0)
    ([[3, 1, 4], [0, 2, 5], [3, 1, 4]], [2, 5, 2], 3),
    # negative ids wrap by +N; -7 and 9 lie outside and drop
    ([[-1, -7, 2], [9, 4, -2], [-1, -7, 2]], [1, 0, 1], 4),
    # cursors running past the table's 3 columns drop the tail rows
    ([[5, 4, 3], [1, 0, 2], [5, 4, 3]], [10, 7, 10], 4),
    # nothing lands: every write drops
    ([[9, 9, 9], [-8, 7, 9], [9, 9, 9]], [0, 1, 0], 2),
])
def test_static_append_paged_matches_jax(case):
    table, cursors, t = case
    n, bs, hd = 6, 4, 5
    rng = np.random.RandomState(len(cursors) + t)
    pool = rng.standard_normal((n, bs, hd)).astype(np.float32)
    new = rng.standard_normal((3, t, hd)).astype(np.float32)
    new[2] = new[0]                          # a pad row repeats row 0
    table = np.asarray(table, np.int64)
    cursors = np.asarray(cursors, np.int64)
    want = np.asarray(jkv.append_paged(jnp.asarray(pool), jnp.asarray(new),
                                       table, cursors))
    got = torch.as_tensor(pool.copy())
    out = pkv.append_paged(got, torch.as_tensor(new), torch.as_tensor(table),
                           torch.as_tensor(cursors))
    assert out is got                         # in place
    np.testing.assert_array_equal(got.numpy(), want)
