"""The sparse tier against the JAX package: virgin rows, SelectedRows,
the in-process EmbeddingService and its saved layout
(paddle_tpu_torch/sparse/), the sigmoid_cross_entropy_with_logits op,
and CTR DeepFM trained through SparseTrainStep (models/ctr_deepfm.py,
sparse/api.py).

The service is numpy in both packages, so its rows, pushes and files are
held bitwise.  DeepFM is the JAX test's tiny config (4 fields, 1000 ids,
dim 8, mlp (16,), batch 16): the Program dicts are equal after
Adam.minimize, and from the JAX startup's weights and fresh services 4
sync steps give the JAX losses within rtol 1e-4 and the touched rows of
both services within 1e-6.
"""

import os
import re

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import ctr_deepfm as jctr
from paddle_tpu.sparse import api as japi
from paddle_tpu.sparse import embedding_service as jes
from paddle_tpu.sparse import selected_rows as jsr
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, testing
from paddle_tpu_torch.models import ctr_deepfm as pctr
from paddle_tpu_torch.sparse import api as papi
from paddle_tpu_torch.sparse import embedding_service as pes
from paddle_tpu_torch.sparse import selected_rows as psr

FIELDS, HEIGHT, DIM, DENSE, BATCH = 4, 1000, 8, 5, 16


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [1, 8, 16])
def test_virgin_rows_are_the_jax_packages_bitwise(dim):
    rng = np.random.RandomState(dim)
    ids = np.concatenate([np.arange(5000),
                          rng.randint(0, 2 ** 62, 5000, dtype=np.int64)])
    for seed, scale in ((0, 0.01), (7, 0.5)):
        with np.errstate(over="ignore"):
            want = jes.hash_init_rows(ids, dim, seed, scale)
            got = pes.hash_init_rows(ids, dim, seed, scale)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_selected_rows_merge_and_to_dense():
    rng = np.random.RandomState(3)
    parts = [(rng.randint(0, 20, 12), rng.randn(12, 4).astype(np.float32))
             for _ in range(3)]
    got = psr.SelectedRows.merge([psr.SelectedRows(r, v, 20)
                                  for r, v in parts])
    want = jsr.SelectedRows.merge([jsr.SelectedRows(r, v, 20)
                                   for r, v in parts])
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.value, want.value)
    assert got.shape == want.shape == (20, 4)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


def _push_pull(mod, optimizer, shards, seed=5, steps=4):
    svc = mod.EmbeddingService(HEIGHT, DIM, num_shards=shards,
                               optimizer=optimizer, learning_rate=0.1)
    rng = np.random.RandomState(seed)
    seen = []
    for _ in range(steps):
        ids = rng.randint(0, 60, 48)     # many duplicates
        seen.append(svc.prefetch(ids))
        grads = rng.uniform(-1, 1, (48, DIM)).astype(np.float32)
        sr = (psr if mod is pes else jsr).SelectedRows
        svc.push_sparse_grad(sr(ids, grads, HEIGHT))
    seen.append(svc.prefetch(np.arange(80)))
    return svc, seen


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("shards", [2, 3])
def test_service_prefetch_and_push_are_the_jax_packages(optimizer, shards):
    psvc, got = _push_pull(pes, optimizer, shards)
    jsvc, want = _push_pull(jes, optimizer, shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for ps, js in zip(psvc.shards, jsvc.shards):
        np.testing.assert_array_equal(ps._ids, js._ids)
        np.testing.assert_array_equal(ps._accum, js._accum)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_a_saved_service_loads_in_the_other_package(saver, tmp_path):
    mods = (pes, jes) if saver == "port" else (jes, pes)
    src, _ = _push_pull(mods[0], "adagrad", 3, seed=8)
    src.save(str(tmp_path))
    dst = mods[1].EmbeddingService(HEIGHT, DIM, num_shards=2,
                                   optimizer="adagrad", learning_rate=0.1,
                                   seed=123)
    dst.load(str(tmp_path))
    assert dst.num_shards == 3
    assert dst.routing.to_meta() == src.routing.to_meta()
    for a, b in zip(src.shards, dst.shards):
        sa, sb = a.snapshot(), b.snapshot()
        for k in ("ids", "vals", "accum"):
            np.testing.assert_array_equal(sa[k], sb[k])


# ---------------------------------------------------------------------------
# sigmoid_cross_entropy_with_logits
# ---------------------------------------------------------------------------


def _sigmoid_ce(pkg, x_np, label_np, cot_np):
    """Out and x@GRAD of reduce_sum(sigmoid_ce(x, label) * cot)."""
    main, startup = pkg.Program(), pkg.Program()
    guard = jun.guard() if pkg is fluid else pt.unique_name.guard()
    with pkg.program_guard(main, startup), guard:
        L = pkg.layers
        x = L.data("x", shape=[3], dtype="float32")
        x.stop_gradient = False
        label = L.data("label", shape=[3], dtype="float32")
        cot = L.data("cot", shape=[3], dtype="float32")
        out = L.sigmoid_cross_entropy_with_logits(x, label, ignore_index=-1)
        loss = L.reduce_sum(L.elementwise_mul(out, cot))
        pkg.backward.append_backward(loss)
    feed = {"x": x_np, "label": label_np, "cot": cot_np}
    if pkg is fluid:
        exe, scope = fluid.Executor(fluid.CPUPlace()), JScope()
    else:
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    got = exe.run(main, feed=feed, fetch_list=[out.name, "x@GRAD"],
                  scope=scope)
    return main, [np.asarray(g) for g in got]


def test_sigmoid_cross_entropy_with_logits_and_its_grad():
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 3) * 4).astype(np.float32)
    label = rng.randint(0, 2, (6, 3)).astype(np.float32)
    label[1, 2] = label[4, 0] = -1.0     # ignore_index hits
    cot = rng.randn(6, 3).astype(np.float32)
    pmain, got = _sigmoid_ce(pt, x, label, cot)
    jmain, want = _sigmoid_ce(fluid, x, label, cot)
    assert pmain.to_dict() == jmain.to_dict()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert got[0][1, 2] == got[0][4, 0] == 0.0
    assert got[1][1, 2] == got[1][4, 0] == 0.0


# ---------------------------------------------------------------------------
# CTR DeepFM through SparseTrainStep
# ---------------------------------------------------------------------------


def _deepfm(pkg):
    """-> (main, startup, loss, embeddings) of the tiny DeepFM."""
    main, startup = pkg.Program(), pkg.Program()
    guard = jun.guard() if pkg is fluid else pt.unique_name.guard()
    ctr = jctr if pkg is fluid else pctr
    with pkg.program_guard(main, startup), guard:
        loss, _prob, embs, _svc = ctr.build(
            num_fields=FIELDS, sparse_feature_dim=HEIGHT,
            embedding_size=DIM, dense_feature_dim=DENSE, mlp_dims=(16,))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, embs


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"sparse_emb@ids": rng.randint(0, HEIGHT, (BATCH, FIELDS)),
             "sparse_w1@ids": rng.randint(0, HEIGHT, (BATCH, FIELDS)),
             "dense_x": rng.rand(BATCH, DENSE).astype("float32"),
             "label": rng.randint(0, 2, (BATCH, 1)).astype("float32")}
            for _ in range(n)]


def _jax_start(jmain, jstartup):
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    start = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    return jscope, jexe, start


def _port_step(pmain, ploss, pembs, start, mode=None):
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), mode=mode)
    convert.load_params(scope, start, pt.CPUPlace(), [pmain])
    return papi.SparseTrainStep(exe, pmain, pembs, ploss), scope


def _loss(out):
    return float(np.asarray(out[0]).ravel()[0])


def test_deepfm_program_equals_the_jax_packages():
    pmain, pstart, _, pembs = _deepfm(pt)
    jmain, jstart, _, _ = _deepfm(fluid)
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    rows = pmain.global_block().var("sparse_emb@rows")
    assert rows.is_data and not rows.stop_gradient
    assert pmain.global_block().has_var("sparse_emb@rows@GRAD")
    assert [e.service.num_shards for e in pembs] == [2, 2]


def test_deepfm_sync_steps_match_the_jax_packages():
    pmain, _, ploss, pembs = _deepfm(pt)
    jmain, jstartup, jloss, jembs = _deepfm(fluid)
    jscope, jexe, start = _jax_start(jmain, jstartup)
    pstep, scope = _port_step(pmain, ploss, pembs, start)
    jstep = japi.SparseTrainStep(jexe, jmain, jembs, jloss)
    feeds = _feeds(4)
    got = [_loss(pstep.run(f, scope=scope)) for f in feeds]
    want = [_loss(jstep.run(f, scope=jscope)) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for pe, je in zip(pembs, jembs):
        ids = np.unique(np.concatenate(
            [f[pe.ids_feed_name].ravel() for f in feeds]))
        np.testing.assert_allclose(pe.service.prefetch(ids),
                                   je.service.prefetch(ids), rtol=0,
                                   atol=1e-6)


def test_deepfm_jit_equals_interpret():
    pmain, pstartup, ploss, pembs = _deepfm(pt)
    scope0 = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(pstartup, scope=scope0)
    start = {v.name: scope0.find_var(v.name).numpy()
             for v in pmain.list_vars()
             if v.persistable and scope0.find_var(v.name) is not None}
    feeds = _feeds(2, seed=4)
    runs = []
    for mode in ("jit", "interpret"):
        for e in pembs:   # fresh services: each run starts from virgin rows
            e.service.__init__(HEIGHT, e.service.dim, num_shards=2,
                               learning_rate=0.01)
        step, scope = _port_step(pmain, ploss, pembs, start, mode=mode)
        losses = [_loss(step.run(f, scope=scope)) for f in feeds]
        runs.append((losses, [e.service.prefetch(np.arange(HEIGHT))
                              for e in pembs]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_deepfm_pipelined_trains_and_barriers():
    """run_pipelined overlaps prefetch(i+1) and push(i) with the steps,
    yields one fetch per feed, and its exhaustion is the push barrier:
    every push has landed when the loop ends."""
    pmain, pstartup, ploss, pembs = _deepfm(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pstartup, scope=scope)
    step = papi.SparseTrainStep(exe, pmain, pembs, ploss)
    pushed = []
    for e in pembs:
        orig = e.service.push_sparse_grad

        def counted(rows, orig=orig):
            orig(rows)
            pushed.append(len(rows.rows))
        e.service.push_sparse_grad = counted
    feeds = _feeds(6, seed=1)
    losses = [_loss(f) for f in step.run_pipelined(iter(feeds),
                                                    scope=scope)]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert len(pushed) == 2 * 6
    assert sum(len(s._rows) for s in pembs[0].service.shards) > 0


def test_pipelined_push_error_does_not_mask_the_step_error():
    pmain, pstartup, ploss, pembs = _deepfm(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pstartup, scope=scope)
    step = papi.SparseTrainStep(exe, pmain, pembs, ploss)

    def boom_push(ids_per_emb, grads):
        raise RuntimeError("push boom")

    step._push_grads = boom_push
    with pytest.raises(RuntimeError, match="push boom"):
        list(step.run_pipelined(iter(_feeds(1)), scope=scope))

    def feeds_raise():
        yield from _feeds(2, seed=2)
        raise ValueError("step boom")

    with pytest.raises(ValueError, match="step boom") as exc_info:
        list(step.run_pipelined(feeds_raise(), scope=scope))
    ctx = exc_info.value.__context__
    assert isinstance(ctx, RuntimeError) and "push boom" in str(ctx)


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, nor chip_smoke.py, imports jax or
    paddle_tpu (the sparse tier keeps its own copies of the JAX package's
    numpy modules)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    pattern = re.compile(r"^\s*(import|from) (jax|paddle_tpu)(\.|\s|$)",
                         re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(root,
                                                   "paddle_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    bad = [f for f in files if pattern.search(open(f).read())]
    assert not bad, bad
