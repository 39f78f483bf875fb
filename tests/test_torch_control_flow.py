"""Control flow in the port (ops/control_flow_ops.py, layers/
control_flow.py) against the JAX package's, on the CPU at tiny sizes.

The same builders run in both packages (explicit programs under each
package's `unique_name.guard()`); the program dicts, sub-blocks
included, are the same; the port runs from the JAX startup's persistables
(`convert.load_params`) and gives the JAX package's values:

  * While: the counter loop; training through a `while` on its three
    grad paths (an inferred bound, an unbounded loop, a compare before
    the increment: one trip more), three SGD losses within rtol 1e-5 and
    equal to an unrolled program's; a `max_steps` below the trip count
    gives NaN gradients and a finite forward; the unbounded grad equals
    the bounded one (1e-6) within the sub-quadratic replay budget
    (tests/test_control_flow.py:330-401); the grad against central
    differences; a dead step of the bounded grad reads in bounds;
  * StaticRNN, DynamicRNN, IfElse and a hand-built conditional_block:
    outputs and parameter grads within 1e-5, also where the untaken
    branch gathers out of range and takes sqrt of a negative;
  * the jit plan of a program with a `while` is the JAX package's, item
    for item, and only an unbounded loop's segment is marked not
    capturable; `clone(for_test=True)` flips is_test inside sub-blocks
    and its BLOCK attrs name its own blocks.
"""

import functools

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.ops import control_flow_ops as jcf
import paddle_tpu_torch as pt
from paddle_tpu_torch import testing
from paddle_tpu_torch.framework import executor as pexec
from paddle_tpu_torch.ops import control_flow_ops as pcf

from torch_op_parity import (
    BOTH,
    assert_steps_close,
    build_program,
    normalized_ints,
    run_programs_both,
)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


# ------------------------------------------------------------------ While


def _counter(pkg):
    L = pkg.layers
    i = L.zeros(shape=[1], dtype="float32")
    limit = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    s = L.zeros(shape=[1], dtype="float32")
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        L.assign(L.elementwise_add(x=s, y=i), output=s)
        L.increment(i, value=1.0)
        L.less_than(x=i, y=limit, cond=cond)
    return s, i, cond


@pytest.mark.parametrize("mode", ["jit", "interpret"])
def test_while_loop_sums_counter_as_jax(mode):
    want, got = run_programs_both(_counter, {}, lambda o: o, mode=mode)
    assert float(got[0][0][0]) == 45.0 and float(got[0][1][0]) == 10.0
    assert not bool(got[0][2][0])     # the final condition is written back
    assert_steps_close(got, want, atol=0)


STEPS = 3


def _while_train(mode, unroll=None, max_steps=None):
    """tests/test_control_flow.py:TestWhileGrad._train's program: mode
    'unrolled' | 'while' | 'while_cmp_first' | 'while_unbounded'."""

    def fn(pkg):
        L = pkg.layers
        x = L.data(name="wgx", shape=[4], dtype="float32")
        w = L.create_parameter(shape=[4, 4], dtype="float32", name="wg_w")
        acc = L.mul(x, w)
        if mode == "unrolled":
            for _ in range(unroll or STEPS):
                acc = L.mul(acc, w)
        else:
            i = L.fill_constant(shape=[1], dtype="int64", value=0)
            limit = L.fill_constant(shape=[1], dtype="int64", value=STEPS)
            if mode == "while_unbounded":
                limit = L.elementwise_add(
                    limit, L.fill_constant(shape=[1], dtype="int64",
                                           value=0))
            cond = L.less_than(x=i, y=limit)
            wh = L.While(cond=cond, max_steps=max_steps)
            with wh.block():
                L.assign(L.mul(acc, w), acc)
                if mode == "while_cmp_first":
                    L.less_than(x=i, y=limit, cond=cond)
                    L.increment(i, in_place=True)
                else:
                    L.increment(i, in_place=True)
                    L.less_than(x=i, y=limit, cond=cond)
        loss = L.mean(acc)
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return loss

    return fn


@functools.lru_cache(maxsize=None)
def _unrolled_losses(unroll):
    """The JAX package's 3 SGD losses of the unrolled program."""
    main, startup, loss = build_program(fluid, BOTH[0][1],
                                        _while_train("unrolled", unroll))
    scope, exe = JScope(), fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return [[np.asarray(exe.run(main, feed=_wg_feed(), fetch_list=[loss],
                                scope=scope)[0])] for _ in range(3)]


def _wg_feed():
    return {"wgx": np.random.RandomState(3).rand(2, 4).astype("float32")}


@pytest.mark.parametrize("mode,unroll,bound", [
    ("while", STEPS, STEPS), ("while_unbounded", STEPS, None),
    ("while_cmp_first", STEPS + 1, STEPS + 1)])
def test_while_grad_trains_as_jax_and_as_unrolled(mode, unroll, bound):
    want, got = run_programs_both(_while_train(mode), _wg_feed(), lambda o: [o],
                          steps=3)
    assert_steps_close(got, want, atol=0, rtol=1e-5)
    main, _, _ = build_program(pt, pt.unique_name.guard, _while_train(mode))
    (wop,) = [op for op in main.global_block().ops if op.type == "while"]
    assert wop.attrs["max_steps"] == bound
    assert_steps_close(got, _unrolled_losses(unroll), atol=1e-7, rtol=1e-5)
    assert got[0][0] != got[-1][0]


def _grad_program(limit_steps, bounded=True, max_steps=None, body="mul"):
    def fn(pkg):
        L = pkg.layers
        x = L.data(name="wgx", shape=[4], dtype="float32")
        w = L.create_parameter(shape=[4, 4], dtype="float32", name="wg_w")
        acc = L.mul(x, w)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=limit_steps)
        if not bounded:
            limit = L.elementwise_add(
                limit, L.fill_constant(shape=[1], dtype="int64", value=0))
        cond = L.less_than(x=i, y=limit)
        wh = L.While(cond=cond, max_steps=max_steps)
        with wh.block():
            if body == "mul":
                nxt = L.mul(acc, w)
            else:
                nxt = L.elementwise_mul(acc, L.reduce_mean(w) * 0.0 + 0.99)
            L.assign(nxt, acc)
            L.increment(i, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        loss = L.mean(acc)
        grads = pkg.backward.append_backward(loss)
        gname = [g.name for p, g in grads if p.name == "wg_w"][0]
        return [loss.name, gname]

    return fn


def test_truncating_max_steps_poisons_grad_as_jax():
    want, got = run_programs_both(_grad_program(3, max_steps=1), _wg_feed(),
                          lambda o: o)
    (lv, gw), (jlv, jgw) = got[0], want[0]
    assert np.isfinite(lv).all() and np.isnan(gw).all()
    assert np.isnan(jgw).all()
    np.testing.assert_allclose(lv, jlv, rtol=1e-6)


def test_unbounded_checkpoint_grad_is_subquadratic_and_as_jax(monkeypatch):
    T, K = 24, 4
    _, bounded = run_programs_both(_grad_program(T, body="scale"), _wg_feed(),
                           lambda o: o)
    for mod in (jcf, pcf):
        monkeypatch.setattr(mod, "UNBOUNDED_CKPT_SLOTS", K)
    monkeypatch.setattr(pcf, "COUNT_BODY_REPLAYS", True)
    pcf.BODY_REPLAY_COUNT["n"] = 0
    want, got = run_programs_both(_grad_program(T, bounded=False, body="scale"),
                          _wg_feed(), lambda o: o)
    replays = pcf.BODY_REPLAY_COUNT["n"]
    np.testing.assert_allclose(got[0][1], bounded[0][1], rtol=1e-6,
                               atol=1e-8)
    assert_steps_close(got, want, atol=1e-8, rtol=1e-6)
    seg = -(-T // K)
    assert 0 < replays <= 4 * T + T * (seg - 1), replays


def test_while_grad_against_central_differences():
    main, startup, (loss, gname) = build_program(pt, pt.unique_name.guard,
                                          _grad_program(STEPS))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _wg_feed()
    _, gw = exe.run(main, feed=feed, fetch_list=[loss, gname], scope=scope)
    w0 = scope.find_var("wg_w").clone()
    eps = 1e-3
    for r, c in [(0, 0), (1, 2), (3, 3)]:
        num = []
        for sgn in (1, -1):
            wp = w0.clone().double()
            wp[r, c] += sgn * eps
            scope.set_var("wg_w", wp.float())
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            num.append(float(lv.reshape(-1)[0]))
        scope.set_var("wg_w", w0.clone())
        np.testing.assert_allclose(gw[r, c], (num[0] - num[1]) / (2 * eps),
                                   rtol=2e-2, atol=1e-4)


def test_plan_is_the_jax_packages_and_marks_only_unbounded_loops():
    # a hand-set bound makes no loop capturable: only the program's own
    # counter pattern fixes a trip count
    for bounded, max_steps in ((True, None), (False, None), (True, 1),
                               (False, STEPS + 2)):
        (jm, _, jo), (pm, _, po) = (
            build_program(pkg, g, _grad_program(STEPS, bounded=bounded,
                                                max_steps=max_steps))
            for pkg, g in BOTH)
        jplan = fluid.Executor(fluid.CPUPlace(), mode="jit")._build_plan(
            jm, 0, JScope(), jo, None)
        pplan = pexec.build_plan(pm, po)
        assert len(jplan) == len(pplan)
        for j, p in zip(jplan, pplan):
            assert p.op_indices == j.op_indices
            assert p.in_names == j.in_names and p.out_names == j.out_names
            assert p.donate == j.donate
            assert p.capturable == bounded


# --------------------------------------------------------------- StaticRNN

B, S, D, H = 2, 5, 3, 4


def _static_rnn(pkg):
    L = pkg.layers
    x = L.data(name="x", shape=[S, D], dtype="float32")
    x.stop_gradient = False
    h0 = L.data(name="h0", shape=[H], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(init=h0)
        z = rnn.memory(shape=[H], batch_ref=xt)
        nh = L.elementwise_add(
            x=L.fc(input=xt, size=H, bias_attr=False, name="xw"),
            y=L.fc(input=h, size=H, bias_attr=False, name="hu"), act="tanh")
        nz = L.elementwise_add(L.scale(z, scale=0.5), nh)
        rnn.update_memory(h, nh)
        rnn.update_memory(z, nz)
        rnn.step_output(nh)
        rnn.step_output(nz)
    out, zs = rnn()
    loss = L.mean(L.elementwise_add(out, zs))
    grads = pkg.backward.append_backward(loss)
    return [out.name, zs.name, loss.name] + sorted(
        g.name for _, g in grads) + ["x@GRAD"]


@pytest.mark.parametrize("mode", ["jit", "interpret"])
def test_static_rnn_outputs_and_grads_as_jax(mode):
    rng = np.random.RandomState(0)
    feed = {"x": rng.uniform(-1, 1, (B, S, D)).astype("float32"),
            "h0": rng.uniform(-1, 1, (B, H)).astype("float32")}
    want, got = run_programs_both(_static_rnn, feed, lambda o: o, mode=mode)
    assert_steps_close(got, want)
    assert got[0][0].shape == (B, S, H)


# -------------------------------------------------------------- DynamicRNN


def _dynamic_rnn(pkg, t=6, d=3, h_dim=5):
    L = pkg.layers
    xv = L.data("x", shape=[t, d], dtype="float32")
    lv = L.data("lens", shape=[], dtype="int64")
    drnn = L.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(xv, seq_len=lv)
        h = drnn.memory(shape=[h_dim], batch_ref=xt)
        new_h = L.fc(L.concat([xt, h], axis=1), size=h_dim, act="tanh",
                     param_attr="drnn_w", bias_attr="drnn_b")
        drnn.update_memory(h, new_h)
        drnn.output(new_h)
    out = drnn()
    last = drnn.last_step()
    loss = L.mean(L.elementwise_add(L.reduce_sum(out, dim=[1]), last))
    grads = pkg.backward.append_backward(loss)
    return [out.name, last.name, loss.name] + sorted(g.name for _, g in grads)


def test_dynamic_rnn_as_jax_and_per_row_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 3).astype(np.float32)
    lens = np.array([6, 2, 4, 1], dtype=np.int64)
    want, got = run_programs_both(_dynamic_rnn, {"x": x, "lens": lens}, lambda o: o)
    assert_steps_close(got, want)
    # rows stop at their length, and last_step reads each row's last step
    out, last = got[0][0], got[0][1]
    for i, n in enumerate(lens):
        assert not out[i, n:].any()
        np.testing.assert_allclose(last[i], out[i, n - 1], atol=0)


def _text_classifier(pkg):
    L = pkg.layers
    xv = L.data("ids", shape=[10], dtype="int64")
    lv = L.data("lens", shape=[], dtype="int64")
    yv = L.data("y", shape=[1], dtype="int64")
    e = L.embedding(xv, size=[40, 8])
    drnn = L.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(e, seq_len=lv)
        h = drnn.memory(shape=[12], batch_ref=xt)
        nh = L.fc(L.concat([xt, h], axis=1), size=12, act="tanh")
        drnn.update_memory(h, nh)
        drnn.output(nh)
    last = L.sequence_last_step(drnn(), seq_len=lv)
    pred = L.fc(last, size=2, act="softmax")
    loss = L.mean(L.cross_entropy(pred, yv))
    pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss]


def test_dynamic_rnn_text_classifier_trains_as_jax():
    rng = np.random.RandomState(2)
    feed = {"ids": rng.randint(0, 40, size=(8, 10)).astype(np.int64),
            "lens": rng.randint(1, 11, size=(8,)).astype(np.int64),
            "y": rng.randint(0, 2, size=(8, 1)).astype(np.int64)}
    want, got = run_programs_both(_text_classifier, feed, lambda o: o, steps=4,
                          seed=5)
    assert_steps_close(got, want, atol=0, rtol=2e-5)
    assert got[-1][0] < got[0][0]


# ----------------------------------------------------- IfElse, conditional


def _if_else(kind):
    def fn(pkg):
        L = pkg.layers
        x = L.data("x", shape=[2], dtype="float32")
        x.stop_gradient = False
        rows = 4
        cond = L.greater_than(L.reduce_sum(x, dim=[1], keep_dim=True),
                              L.fill_constant([rows, 1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            if kind == "log":
                ie.output(L.log(ie.input(x)))
            elif kind == "rank1":
                ie.output(L.reduce_sum(ie.input(x), dim=[1]))
            else:
                ie.output(L.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            if kind == "rank1":
                ie.output(L.reduce_sum(L.scale(ie.input(x), scale=-1.0),
                                       dim=[1]))
            else:
                ie.output(L.scale(ie.input(x), scale=-1.0))
        (out,) = ie()
        loss = L.reduce_sum(out)
        pkg.backward.append_backward(loss)
        return [out.name, "x@GRAD"]

    return fn


@pytest.mark.parametrize("kind", ["scale", "log", "rank1"])
def test_if_else_rows_pick_their_branch_as_jax(kind):
    x = np.array([[2.0, 1.0], [-3.0, 0.5], [0.5, 0.25], [-1.0, -2.0]],
                 np.float32)
    want, got = run_programs_both(_if_else(kind), {"x": x}, lambda o: o)
    assert np.isfinite(got[0][0]).all()
    assert_steps_close(got, want)
    pos = x.sum(1) > 0
    if kind == "rank1":
        assert got[0][0].shape == (4,)
        np.testing.assert_allclose(got[0][0], np.abs(x.sum(1)), rtol=1e-6)
    elif kind == "scale":
        np.testing.assert_allclose(
            got[0][0], np.where(pos[:, None], 2 * x, -x), rtol=1e-6)


def test_if_else_mismatched_outputs_raise():
    L = pt.layers
    x = L.data("x", shape=[4], dtype="float32")
    ie = L.IfElse(L.greater_than(L.reduce_sum(x, dim=[1], keep_dim=True),
                                 L.fill_constant([1, 1], "float32", 0.0)))
    with ie.true_block():
        ie.output(x)
    with pytest.raises(ValueError, match="outputs"):
        ie()


def _conditional(pkg):
    """A conditional_block appended by hand: out = tanh(x @ w) * 3 when
    the flag holds, else zeros."""
    L = pkg.layers
    main = pkg.default_main_program()
    x = L.data("x", shape=[3], dtype="float32")
    flag = L.data("flag", shape=[1], dtype="bool", append_batch_size=False)
    w = L.create_parameter(shape=[3, 3], dtype="float32", name="cb_w")
    parent = main.current_block()
    sub = main.create_block()
    y = L.scale(L.tanh(L.mul(x, w)), scale=3.0)
    main.rollback()
    out = parent.create_var(name="cb_out", shape=y.shape, dtype="float32")
    parent.append_op(type="conditional_block",
                     inputs={"X": [x, w], "Cond": [flag]},
                     outputs={"Out": [out]},
                     attrs={"sub_block": sub, "x_names": [x.name, w.name],
                            "out_names": [y.name]}, infer_shape=False)
    loss = L.reduce_sum(L.elementwise_mul(out, out))
    pkg.backward.append_backward(loss)
    return [out.name, loss.name, "cb_w@GRAD"]


@pytest.mark.parametrize("flag", [True, False])
def test_conditional_block_by_hand_as_jax(flag):
    x = np.random.RandomState(4).randn(2, 3).astype(np.float32)
    want, got = run_programs_both(_conditional,
                          {"x": x, "flag": np.array([flag])}, lambda o: o)
    assert_steps_close(got, want)
    assert bool(np.abs(got[0][0]).sum() > 0) == flag


def _guarded_conditional(pkg):
    """A hand-built conditional_block whose block is safe only when the
    flag holds: it gathers rows of w by `idx` and takes sqrt(s); the feed
    gives an out-of-range idx and a negative s with the flag off."""
    L = pkg.layers
    main = pkg.default_main_program()
    x = L.data("x", shape=[2, 3], dtype="float32", append_batch_size=False)
    idx = L.data("idx", shape=[2], dtype="int64", append_batch_size=False)
    sv = L.data("s", shape=[2, 1], dtype="float32", append_batch_size=False)
    flag = L.data("flag", shape=[1], dtype="bool", append_batch_size=False)
    w = L.create_parameter(shape=[3, 3], dtype="float32", name="cb_w")
    parent = main.current_block()
    sub = main.create_block()
    y = L.elementwise_add(L.tanh(L.mul(x, w)),
                          L.elementwise_mul(L.gather(w, idx), L.sqrt(sv)))
    main.rollback()
    out = parent.create_var(name="cb_out", shape=y.shape, dtype="float32")
    names = [x.name, idx.name, sv.name, w.name]
    parent.append_op(type="conditional_block",
                     inputs={"X": [x, idx, sv, w], "Cond": [flag]},
                     outputs={"Out": [out]},
                     attrs={"sub_block": sub, "x_names": names,
                            "out_names": [y.name]}, infer_shape=False)
    loss = L.reduce_sum(L.elementwise_mul(out, out))
    pkg.backward.append_backward(loss)
    return [out.name, loss.name, "cb_w@GRAD"]


@pytest.mark.parametrize("flag", [True, False])
def test_conditional_block_untaken_branch_is_guarded_as_jax(flag):
    """The block runs on every path: with the flag off it runs on zeros,
    so the gather stays in bounds, and the select on its inputs keeps
    sqrt's infinite derivative at 0 out of the grad, which is JAX's (0,
    finite) where lax.cond skips the branch."""
    rs = np.random.RandomState(5)
    feed = {"x": rs.randn(2, 3).astype(np.float32),
            "idx": np.array([2, 0] if flag else [7, -9], np.int64),
            "s": (rs.rand(2, 1) + 0.5).astype(np.float32)
            * (1 if flag else -1),
            "flag": np.array([flag])}
    want, got = run_programs_both(_guarded_conditional, feed, lambda o: o)
    assert_steps_close(got, want)
    assert np.isfinite(got[0][2]).all()
    assert bool(np.abs(got[0][0]).sum() > 0) == flag


# ------------------------------------------------------------ clone, IO


def test_clone_for_test_reaches_into_sub_blocks():
    def fn(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[S, D], dtype="float32")
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[H], batch_ref=xt)
            nh = L.fc(input=L.dropout(xt, dropout_prob=0.5), size=H,
                      act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        return rnn()

    (jm, _, _), (pm, _, _) = (build_program(pkg, g, fn) for pkg, g in BOTH)
    jt, pc = jm.clone(for_test=True), pm.clone(for_test=True)
    assert normalized_ints(pc) == normalized_ints(jt)
    drop = [op for op in pc.block(1).ops if op.type == "dropout"]
    assert drop and drop[0].attrs["is_test"]
    assert not [op for op in pm.block(1).ops
                if op.type == "dropout"][0].attrs.get("is_test")
    for blk in pc.blocks:
        for op in blk.ops:
            sub = op.attrs.get("sub_block")
            if sub is not None:
                assert sub is pc.block(sub.idx)


# ------------------------------------------- the captured forms on the CPU


@pytest.fixture
def as_captured(monkeypatch):
    """Run the control-flow ops in the form a CUDA graph capture takes
    (predicated trips, select against zeros) on CPU tensors."""
    monkeypatch.setattr(pcf, "capturing", lambda t: True)


def _gather_loop(max_steps):
    """A loop whose body reads table[i]: its counter runs to the table's
    end, so a trip past the last would read out of bounds."""

    def fn(pkg):
        L = pkg.layers
        table = L.data("table", shape=[3, 4], dtype="float32",
                       append_batch_size=False)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=3)
        s = L.fill_constant(shape=[1, 4], dtype="float32", value=0.0)
        s.stop_gradient = False
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond, max_steps=max_steps)
        with w.block():
            L.assign(L.elementwise_add(s, L.gather(table, i)), output=s)
            L.increment(i, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        return [s.name, i.name]

    return fn


def test_predicated_trips_equal_the_eager_loop(as_captured):
    """The captured form of a while whose trip count the program fixes:
    its 3 trips unrolled whatever max_steps says (here twice the count),
    so the gather never reads past the table; the training grads (their
    max_steps predicated steps) and a conditional_block's select equal
    the JAX package's."""
    table = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    want, got = run_programs_both(_gather_loop(6), {"table": table}, lambda o: o)
    assert_steps_close(got, want, atol=0)
    np.testing.assert_array_equal(got[0][0][0], table.sum(0))
    want, got = run_programs_both(_while_train("while"), _wg_feed(), lambda o: [o],
                          steps=3)
    assert_steps_close(got, want, atol=0, rtol=1e-5)
    for flag in (True, False):
        x = np.random.RandomState(4).randn(2, 3).astype(np.float32)
        want, got = run_programs_both(_conditional,
                              {"x": x, "flag": np.array([flag])}, lambda o: o)
        assert_steps_close(got, want)


def test_captured_forms_poison_an_outrun_bound_and_refuse_no_bound(
        as_captured):
    """A bound below the trip count poisons the grad and leaves the
    forward exact, as in the JAX package; a loop whose count the program
    does not fix refuses capture, a hand-set bound or none."""
    want, got = run_programs_both(_grad_program(3, max_steps=1), _wg_feed(),
                          lambda o: o)
    assert np.isnan(got[0][1]).all() and np.isnan(want[0][1]).all()
    assert np.isfinite(got[0][0]).all()
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-6)
    for max_steps in (None, 5):
        main, startup, fetch = build_program(
            pt, pt.unique_name.guard,
            _grad_program(3, bounded=False, max_steps=max_steps))
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(RuntimeError, match="does not fix"):
            exe.run(main, feed=_wg_feed(), fetch_list=fetch, scope=scope)


def test_bounded_grad_dead_steps_read_in_bounds_as_jax():
    """max_steps twice the trip count: the grad's dead steps replay the
    last live step's inputs, so table[i] never reads row 3 of 3."""

    def fn(pkg):
        L = pkg.layers
        table = L.create_parameter(shape=[3, 4], dtype="float32",
                                   name="gl_table")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=3)
        s = L.fill_constant(shape=[1, 4], dtype="float32", value=1.0)
        s.stop_gradient = False
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond, max_steps=6)
        with w.block():
            L.assign(L.elementwise_mul(s, L.gather(table, i)), output=s)
            L.increment(i, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        loss = L.reduce_sum(s)
        pkg.backward.append_backward(loss)
        return [loss.name, "gl_table@GRAD"]

    want, got = run_programs_both(fn, {}, lambda o: o)
    assert_steps_close(got, want)
    assert np.abs(got[0][1]).min() > 0


@pytest.mark.parametrize("case,trips", [
    ("canonical", 4), ("cmp_first", 5), ("empty", 0), ("float_step", None),
    ("cond_by_hand", None), ("limit_after_cond", None)])
def test_exact_trips_only_where_the_program_fixes_them(case, trips):
    """exact_trips: the counter pattern with integer constants and the
    condition entering as the same compare; None otherwise."""
    L = pt.layers
    with pt.program_guard(pt.Program(), pt.Program()):
        i = L.fill_constant(shape=[1], dtype="float32",
                            value=9.0 if case == "empty" else 1.0)
        limit = L.fill_constant(shape=[1], dtype="float32", value=8.0)
        cond = (L.fill_constant(shape=[1], dtype="bool", value=True)
                if case == "cond_by_hand" else L.less_than(x=i, y=limit))
        if case == "limit_after_cond":
            L.assign(L.fill_constant(shape=[1], dtype="float32",
                                     value=2.0), output=limit)
        w = L.While(cond=cond)
        with w.block():
            step = 0.5 if case == "float_step" else 2.0
            if case == "cmp_first":
                L.less_than(x=i, y=limit, cond=cond)
                L.increment(i, value=step)
            else:
                L.increment(i, value=step)
                L.less_than(x=i, y=limit, cond=cond)
        (wop,) = [op for op in pt.default_main_program().global_block().ops
                  if op.type == "while"]
    assert pcf.exact_trips(wop.attrs) == trips
    assert pcf.needs_host(wop) == (trips is None)
