"""CheckpointManager (paddle_tpu_torch/checkpoint/) and the sharded half
of io.py, as tests/test_checkpoint_manager.py holds the JAX package's, on
a tiny MLP: the step directory's layout and manifest, quarantine of a
crash before the commit rename, fallback past a corrupt checkpoint, async
error surfacing, retention, the SIGTERM latch, a resume (dense, Adam's
moments and a sparse service) bitwise equal to an uninterrupted run, and
the warning on a changed trace-affecting flag.

Across packages: a port checkpoint passes tools/ckpt_fsck.py (loaded with
importlib; the tool is unchanged), and each package restores the other's
step directory with equal dense vars and sparse state.
"""

import importlib.util
import os
import shutil
import signal
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.sparse.embedding_service import EmbeddingService as JService
import paddle_tpu_torch as pt
from paddle_tpu_torch import checkpoint, convert, flags, io, testing
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.sparse import EmbeddingService, SelectedRows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = pt.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _build_small(pkg=pt, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    guard = jun.guard() if pkg is fluid else pt.unique_name.guard()
    with pkg.program_guard(main, startup), guard:
        L = pkg.layers
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        pred = L.fc(x, size=1, param_attr="w", bias_attr="b")
        loss = L.mean(L.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feed(step=0):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.randn(4, 4).astype(np.float32),
            "y": rng.randn(4, 1).astype(np.float32)}


def _trained(steps=2):
    """-> (main, loss, exe, scope) after `steps` Adam steps on the CPU."""
    main, startup, loss = _build_small()
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    for s in range(steps):
        exe.run(main, feed=_feed(s), fetch_list=[loss], scope=scope)
    return main, loss, exe, scope


def _np(scope, name):
    v = scope.find_var(name)
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fsck():
    spec = importlib.util.spec_from_file_location(
        "_ckpt_fsck", os.path.join(REPO, "tools", "ckpt_fsck.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_commit_layout_manifest_and_restore(tmp_path):
    main, _, _, scope = _trained()
    w = _np(scope, "w")
    mgr = CheckpointManager(str(tmp_path), keep_last_k=3, async_save=False)
    path = mgr.save(3, scope=scope, main_program=main, epoch=1,
                    extras={"in_epoch_step": 2})
    assert sorted(os.listdir(path)) == ["dense", "manifest.json",
                                        "train_state.json"]
    assert sorted(os.listdir(os.path.join(path, "dense"))) == [
        "shard_0.index.json", "shard_0.npz"]
    ok, problems = checkpoint.verify_checkpoint_dir(path)
    assert ok, problems
    man = checkpoint.load_manifest(path)
    assert man["step"] == 3 and man["file_count"] == len(man["files"])
    assert all(len(m["sha256"]) == 64 for m in man["files"].values())
    assert man["sharding"]["world"] == 1
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))
    s2 = pt.Scope()
    state = mgr.restore(scope=s2, main_program=main, place=CPU)
    assert state["step"] == 3 and state["epoch"] == 1
    assert state["extras"]["in_epoch_step"] == 2
    assert "w" in state["restored_vars"]
    assert any("moment" in n for n in state["restored_vars"])
    np.testing.assert_array_equal(_np(s2, "w"), w)
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        main_program=main) is None


def test_crash_between_tmp_write_and_rename_is_quarantined(tmp_path):
    main, loss, exe, scope = _trained()
    w1 = _np(scope, "w")
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep_last_k=5, async_save=False)
    mgr.save(1, scope=scope, main_program=main, epoch=0)
    exe.run(main, feed=_feed(9), fetch_list=[loss], scope=scope)
    mgr.save(2, scope=scope, main_program=main, epoch=0)
    shutil.move(os.path.join(root, "step_2"), os.path.join(root,
                                                           "step_2.tmp"))
    s2 = pt.Scope()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        state = CheckpointManager(root, async_save=False).restore(
            scope=s2, main_program=main, place=CPU)
    assert state["step"] == 1
    np.testing.assert_array_equal(_np(s2, "w"), w1)
    names = sorted(os.listdir(root))
    assert "step_2.tmp" not in names
    assert any(n.startswith("step_2.tmp.quarantine") for n in names), names


def test_corrupt_checkpoint_falls_back_and_explicit_step_raises(tmp_path):
    main, _, _, scope = _trained()
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep_last_k=5, async_save=False)
    for step in (1, 2, 3):
        mgr.save(step, scope=scope, main_program=main, epoch=0)
    with open(os.path.join(root, "step_3/dense/shard_0.npz"), "r+b") as f:
        f.seek(8)
        f.write(b"\xde\xad\xbe\xef")
    os.remove(os.path.join(root, "step_1/train_state.json"))
    with pytest.raises(IOError, match="failed verification"):
        mgr.restore(step=1, scope=pt.Scope(), main_program=main, place=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        state = CheckpointManager(root, async_save=False).restore(
            scope=pt.Scope(), main_program=main, place=CPU)
    assert state["step"] == 2
    assert any(n.startswith("step_3.quarantine") for n in os.listdir(root))


def test_async_overlap_and_injected_error_surfacing(tmp_path):
    main, loss, exe, scope = _trained()
    mgr = CheckpointManager(str(tmp_path), keep_last_k=5, async_save=True)
    fence, released = threading.Event(), threading.Event()

    def hold(step):
        released.set()
        assert fence.wait(timeout=30)

    mgr._before_write = hold
    w_saved = _np(scope, "w")
    path = mgr.save(1, scope=scope, main_program=main, epoch=0)
    assert released.wait(timeout=30)
    assert not os.path.exists(path)
    # the caller trains on while the writer holds a host copy
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
    assert not np.array_equal(_np(scope, "w"), w_saved)
    fence.set()
    mgr.wait()
    ok, problems = checkpoint.verify_checkpoint_dir(path)
    assert ok, problems
    got = np.load(os.path.join(path, "dense", "shard_0.npz"))["w"]
    np.testing.assert_array_equal(got, w_saved)

    def boom(step):
        raise RuntimeError("injected writer failure")

    mgr._before_write = boom
    mgr.save(2, scope=scope, main_program=main, epoch=0)
    with pytest.raises(RuntimeError, match="background writer"):
        mgr.wait()
    mgr.save(3, scope=scope, main_program=main, epoch=0)
    mgr._queue.join()
    with pytest.raises(RuntimeError, match="background writer"):
        mgr.save(4, scope=scope, main_program=main, epoch=0)
    assert mgr.steps() == [1]
    mgr._before_write = None
    mgr.save(5, scope=scope, main_program=main, epoch=0)
    with pytest.warns(RuntimeWarning, match="quarantined 'step_2.tmp'"):
        state = mgr.restore(scope=pt.Scope(), main_program=main, place=CPU)
    assert state is not None and state["step"] == 5


@pytest.mark.parametrize("keep,every,want", [(2, 4, [4, 5, 6]),
                                             (0, 0, [1, 2, 3, 4, 5, 6])])
def test_retention(tmp_path, keep, every, want):
    main, _, _, scope = _trained(steps=1)
    mgr = CheckpointManager(str(tmp_path), keep_last_k=keep,
                            keep_every_n=every, async_save=False)
    for step in range(1, 7):
        mgr.save(step, scope=scope, main_program=main, epoch=0)
    assert mgr.steps() == want


def test_sigterm_latches_preempted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert not mgr.preempted
    assert mgr.install_preemption_hook()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert mgr.preempted
    finally:
        mgr.uninstall_preemption_hook()


def test_changed_trace_flag_warns_on_restore(tmp_path):
    main, _, _, scope = _trained(steps=1)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, scope=scope, main_program=main)
    try:
        flags.set("op_remat", True)
        with pytest.warns(RuntimeWarning,
                          match="trace-affecting flag signature"):
            mgr.restore(scope=pt.Scope(), main_program=main, place=CPU)
    finally:
        flags.reset("op_remat")


def _run_mlp_with_service(root, total, ckpt_at=None, resume=False):
    """A tiny MLP whose input adds rows of a sparse service, Adam and a
    service push each step; -> {step: loss bytes}.  Both the dense and
    the sparse state must restore exactly for the losses to match."""
    main, startup, loss = _build_small(seed=3)
    svc = EmbeddingService(64, 4, num_shards=3)
    mgr = CheckpointManager(root, keep_last_k=3, async_save=True)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    start, losses = 0, {}
    if resume:
        state = mgr.restore(scope=scope, main_program=main,
                            services={"emb": svc}, place=CPU)
        start = int(state["step"])
        assert any("moment" in n for n in state["restored_vars"])
    for step in range(start, total):
        ids = ((np.arange(4) * 3 + step) % 64).astype(np.int64)
        feed = _feed(step)
        feed["x"] = feed["x"] + svc.prefetch(ids)
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses[step] = lv.reshape(-1)[0].tobytes()
        svc.push_sparse_grad(SelectedRows(
            ids, np.full((4, 4), 0.01, np.float32) * (step + 1), 64))
        if ckpt_at is not None and step + 1 == ckpt_at:
            mgr.save(step + 1, scope=scope, main_program=main,
                     services={"emb": svc}, epoch=0)
    mgr.wait()
    return losses, svc


def test_resume_is_bitwise_identical(tmp_path):
    k, total = 3, 6
    ref, ref_svc = _run_mlp_with_service(str(tmp_path / "ref"), total)
    first, _ = _run_mlp_with_service(str(tmp_path / "run"), k, ckpt_at=k)
    resumed, svc = _run_mlp_with_service(str(tmp_path / "run"), total,
                                         resume=True)
    assert sorted(resumed) == list(range(k, total))
    for step in range(total):
        assert (first if step < k else resumed)[step] == ref[step], step
    ids = np.arange(64)
    np.testing.assert_array_equal(svc.prefetch(ids), ref_svc.prefetch(ids))


def test_a_port_checkpoint_passes_ckpt_fsck(tmp_path, capsys):
    main, _, _, scope = _trained(steps=1)
    svc = EmbeddingService(32, 4, num_shards=2)
    svc.prefetch(np.array([1, 2, 3], np.int64))
    root = str(tmp_path)
    CheckpointManager(root, async_save=False).save(
        1, scope=scope, main_program=main, services={"emb": svc})
    fsck = _fsck()
    assert fsck.main([root]) == 0
    assert "RESTORABLE" in capsys.readouterr().out
    with open(os.path.join(root, "step_1/sparse_emb/shard_0.npz"),
              "r+b") as f:
        f.seek(4)
        f.write(b"\x00\x00")
    assert fsck.main([root]) == 1
    out = capsys.readouterr().out
    assert "NOT RESTORABLE" in out and "checksum mismatch" in out


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_each_package_restores_the_others_step_directory(tmp_path, saver):
    """The same MLP trained 2 steps from the JAX startup's weights in the
    saving package, with a 3-shard adagrad service; the other package
    restores the step directory: every dense var and every shard's rows
    and accumulators equal the saver's."""
    jmain, jstartup, jloss = _build_small(fluid)
    pmain, _, ploss = _build_small(pt)
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    root = str(tmp_path)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 64, 20)
    grads = rng.randn(20, 4).astype(np.float32)
    svc_cls = EmbeddingService if saver == "port" else JService
    svc = svc_cls(64, 4, num_shards=3)
    svc.push_sparse_grad(SelectedRows(ids, grads, 64))
    if saver == "jax":
        for s in range(2):
            jexe.run(jmain, feed=_feed(s), fetch_list=[jloss.name],
                     scope=jscope)
        names = [v.name for v in jmain.list_vars() if v.persistable]
        saved = {n: np.asarray(jscope.find_var(n)) for n in names}
        jckpt.CheckpointManager(root, async_save=False).save(
            2, scope=jscope, main_program=jmain, services={"emb": svc})
    else:
        start = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jmain.list_vars() if v.persistable}
        scope, exe = pt.Scope(), pt.Executor(CPU)
        convert.load_params(scope, start, CPU, [pmain])
        for s in range(2):
            exe.run(pmain, feed=_feed(s), fetch_list=[ploss], scope=scope)
        names = [v.name for v in pmain.list_vars() if v.persistable]
        saved = {n: _np(scope, n) for n in names}
        CheckpointManager(root, async_save=False).save(
            2, scope=scope, main_program=pmain, services={"emb": svc})
    other = (JService if saver == "port" else EmbeddingService)(
        64, 4, num_shards=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the flag signatures agree
        if saver == "jax":
            s2 = pt.Scope()
            state = CheckpointManager(root).restore(
                scope=s2, main_program=pmain, services={"emb": other},
                place=CPU)
            got = {n: _np(s2, n) for n in names}
        else:
            s2 = JScope()
            state = jckpt.CheckpointManager(root).restore(
                scope=s2, main_program=jmain, services={"emb": other})
            got = {n: np.asarray(s2.find_var(n)) for n in names}
    assert state["step"] == 2 and sorted(state["restored_vars"]) == \
        sorted(names)
    for n in names:
        np.testing.assert_array_equal(got[n], saved[n], err_msg=n)
    assert other.num_shards == 3
    for a, b in zip(svc.shards, other.shards):
        sa, sb = a.snapshot(), b.snapshot()
        for k in ("ids", "vals", "accum"):
            np.testing.assert_array_equal(sa[k], sb[k])


def test_what_needs_several_devices_or_bfloat16_raises(tmp_path):
    main, _, _, scope = _trained(steps=1)
    with pytest.raises(NotImplementedError, match="A item 7"):
        io.snapshot_sharded(scope, main, gather=True)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, scope=scope, main_program=main)
    with pytest.raises(NotImplementedError, match="A item 7"):
        mgr.restore(scope=pt.Scope(), main_program=main, mesh=object(),
                    place=CPU)
    scope.set_var("w", scope.find_var("w").to(torch.bfloat16))
    with pytest.raises(TypeError, match="C15"):
        io.save_sharded(str(tmp_path / "bf16"), scope, main)
