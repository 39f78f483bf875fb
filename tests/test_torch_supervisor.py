"""ShardSupervisor (paddle_tpu_torch/resilience/supervisor.py): detect ->
fail over -> restore -> replay, as tests/test_supervisor.py holds the
JAX package's.

One test runs shard-server processes (`python -m
paddle_tpu_torch.sparse.server`): kill -9 of shard 1 mid-training is
invisible to the loop, and the table afterwards equals an uninterrupted
in-process mirror bitwise.  The others run ShardServers on threads:
degraded lookups with buffered pushes, standby adoption with a restore,
journal truncation and retention, an unrecoverable shard, and a
committed shard checkpoint that tools/ckpt_fsck.py passes.

Every mirror is the JAX package's EmbeddingService (and its virgin rows
its hash_init_rows), fed the same ids and grads: a fault in the port's
Shard (its update, export/import or load) cannot hide on both sides.
"""

import importlib.util
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.sparse.embedding_service import (
    EmbeddingService as JEmbeddingService,
    hash_init_rows as j_hash_init_rows,
)
from paddle_tpu.sparse.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu_torch.resilience import (
    RpcPolicy,
    ShardDownError,
    ShardSupervisor,
)
from paddle_tpu_torch.sparse import RemoteEmbeddingService, SelectedRows
from paddle_tpu_torch.sparse.embedding_service import Shard
from paddle_tpu_torch.sparse.transport import ShardServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8
HEIGHT = 10000
LR = 0.05
# adagrad, so that the accumulators go through every checkpoint, restore
# and replay as the rows do
OPT = "adagrad"


def _fast_policy():
    return RpcPolicy(connect_timeout=1.0, call_timeout=2.0, max_attempts=2,
                     backoff_base=0.05, jitter=0.0)


def _fsck():
    spec = importlib.util.spec_from_file_location(
        "_ckpt_fsck", os.path.join(REPO, "tools", "ckpt_fsck.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spawn_server_proc(idx, num_shards, tmpdir, tag=""):
    """A shard-server process of the port; -> (proc, endpoint)."""
    ready = os.path.join(tmpdir, f"ep{idx}{tag}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.sparse.server",
         "--shard-index", str(idx), "--num-shards", str(num_shards),
         "--dim", str(DIM), "--port", "0", "--ready-file", ready,
         "--optimizer", OPT, "--learning-rate", str(LR)],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return proc, ready


def _wait_ready(proc, ready, timeout=60):
    deadline = time.time() + timeout
    while not os.path.exists(ready):
        if proc.poll() is not None:
            raise RuntimeError(f"shard server died: "
                               f"{proc.stderr.read().decode()}")
        if time.time() > deadline:
            proc.kill()
            raise TimeoutError("shard server never became ready")
        time.sleep(0.02)
    with open(ready) as f:
        return f.read().strip()


def _wait_status(sup, index, up, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if sup.status()[index]["up"] == up:
            return
        time.sleep(0.05)
    raise TimeoutError(f"shard {index} never became "
                       f"{'up' if up else 'down'}: {sup.status()}")


def test_kill9_of_a_server_process_recovers_bitwise(tmp_path):
    tmp = str(tmp_path)
    num_shards = 2
    procs = {}
    sup = svc = None
    try:
        started = [_spawn_server_proc(i, num_shards, tmp)
                   for i in range(num_shards)]
        endpoints = []
        for i, (proc, ready) in enumerate(started):
            procs[i] = proc
            endpoints.append(_wait_ready(proc, ready))
        svc = RemoteEmbeddingService(endpoints, HEIGHT, DIM,
                                     policy=_fast_policy())
        mirror = JEmbeddingService(HEIGHT, DIM, num_shards=num_shards,
                                  optimizer=OPT, learning_rate=LR)
        respawns = []

        def respawn(index):
            proc, ready = _spawn_server_proc(index, num_shards, tmp,
                                             tag=f".r{len(respawns)}")
            procs[index] = proc
            respawns.append(index)
            return _wait_ready(proc, ready)

        sup = ShardSupervisor(svc, checkpoint_root=os.path.join(tmp, "ck"),
                              spawn=respawn, ping_interval=0.1,
                              degraded_lookup=False,
                              recovery_timeout=60.0).start()
        rng = np.random.RandomState(1234)
        for step in range(10):
            ids = rng.permutation(200)[:12].astype(np.int64)
            grads = (rng.uniform(-1, 1, (12, DIM)).astype(np.float32)
                     * np.float32(0.1))
            np.testing.assert_array_equal(
                svc.prefetch(ids), mirror.prefetch(ids),
                err_msg=f"step {step} prefetch diverged")
            svc.push_sparse_grad(SelectedRows(ids, grads, HEIGHT))
            mirror.push_sparse_grad(JSelectedRows(ids, grads, HEIGHT))
            if step == 3:
                sup.checkpoint()
            if step == 6:
                os.kill(procs[1].pid, signal.SIGKILL)
                procs[1].wait()
        assert respawns == [1], sup.events
        kinds = [k for _, k, _i, _d in sup.events]
        for kind in ("shard_down", "shard_respawned", "checkpoint_restored",
                     "journal_replayed", "shard_recovered"):
            assert kind in kinds, kinds
        all_ids = np.arange(200, dtype=np.int64)
        np.testing.assert_array_equal(svc.prefetch(all_ids),
                                      mirror.prefetch(all_ids))
    finally:
        if sup is not None:
            sup.stop()
        if svc is not None:
            svc.close()
        for proc in procs.values():
            proc.kill()
            proc.wait()


def _serve(index, num_shards):
    srv = ShardServer(Shard(index, num_shards, DIM, optimizer=OPT,
                            learning_rate=LR))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_degraded_lookup_serves_virgin_rows_and_buffers_pushes():
    primary = _serve(0, 1)
    svc = RemoteEmbeddingService([primary.endpoint], HEIGHT, DIM,
                                 policy=_fast_policy())
    replacement = {}
    allow_recovery = threading.Event()

    def spawn(index):
        allow_recovery.wait(timeout=30)
        srv = _serve(index, 1)     # comes up empty: the journal rebuilds it
        replacement["srv"] = srv
        return srv.endpoint

    sup = ShardSupervisor(svc, spawn=spawn, ping_interval=0.1,
                          degraded_lookup=True, recovery_timeout=30.0).start()
    mirror = JEmbeddingService(HEIGHT, DIM, num_shards=1, optimizer=OPT,
                              learning_rate=LR)
    try:
        ids = np.arange(8, dtype=np.int64)
        g1 = np.full((8, DIM), 0.25, np.float32)
        svc.push_sparse_grad(SelectedRows(ids, g1, HEIGHT))
        mirror.push_sparse_grad(JSelectedRows(ids, g1, HEIGHT))
        primary.shutdown()
        primary.server_close()
        _wait_status(sup, 0, up=False)
        np.testing.assert_array_equal(
            svc.prefetch(ids),
            j_hash_init_rows(ids, DIM, seed=0, scale=0.01))
        g2 = np.full((8, DIM), -0.5, np.float32)
        svc.push_sparse_grad(SelectedRows(ids, g2, HEIGHT))
        mirror.push_sparse_grad(JSelectedRows(ids, g2, HEIGHT))
        assert sup.status()[0]["journal_len"] == 2
        allow_recovery.set()
        _wait_status(sup, 0, up=True)
        np.testing.assert_array_equal(svc.prefetch(ids), mirror.prefetch(ids))
        assert svc.shards[0].endpoint == replacement["srv"].endpoint
    finally:
        allow_recovery.set()
        sup.stop()
        svc.close()
        if "srv" in replacement:
            replacement["srv"].shutdown()


def test_standby_adoption_with_checkpoint_restore(tmp_path):
    primary, standby = _serve(0, 1), _serve(0, 1)
    svc = RemoteEmbeddingService([primary.endpoint], HEIGHT, DIM,
                                 policy=_fast_policy())
    sup = ShardSupervisor(svc, checkpoint_root=str(tmp_path / "ck"),
                          standby_resolver=lambda i: standby.endpoint,
                          ping_interval=0.1, recovery_timeout=30.0).start()
    mirror = JEmbeddingService(HEIGHT, DIM, num_shards=1, optimizer=OPT,
                              learning_rate=LR)
    try:
        ids = np.arange(10, dtype=np.int64)
        g1 = np.full((10, DIM), 0.125, np.float32)
        svc.push_sparse_grad(SelectedRows(ids, g1, HEIGHT))
        mirror.push_sparse_grad(JSelectedRows(ids, g1, HEIGHT))
        sup.checkpoint()
        g2 = np.full((10, DIM), 0.0625, np.float32)
        svc.push_sparse_grad(SelectedRows(ids, g2, HEIGHT))
        mirror.push_sparse_grad(JSelectedRows(ids, g2, HEIGHT))
        primary.shutdown()
        primary.server_close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = sup.status()[0]
            if st["up"] and st["endpoint"] == standby.endpoint:
                break
            time.sleep(0.05)
        assert svc.shards[0].endpoint == standby.endpoint
        kinds = [k for _, k, _i, _d in sup.events]
        assert "standby_adopted" in kinds and "checkpoint_restored" in kinds
        np.testing.assert_array_equal(svc.prefetch(ids), mirror.prefetch(ids))
    finally:
        sup.stop()
        svc.close()
        standby.shutdown()


def test_checkpoint_truncates_journal_retains_k_and_passes_fsck(tmp_path):
    srv = _serve(0, 1)
    root = str(tmp_path / "ck")
    svc = RemoteEmbeddingService([srv.endpoint], HEIGHT, DIM,
                                 policy=_fast_policy())
    sup = ShardSupervisor(svc, checkpoint_root=root, ping_interval=5.0,
                          keep_checkpoints=2).start()
    try:
        ids = np.arange(4, dtype=np.int64)
        g = np.ones((4, DIM), np.float32)
        dirs = []
        for _ in range(3):
            svc.push_sparse_grad(SelectedRows(ids, g, HEIGHT))
            assert sup.status()[0]["journal_len"] == 1
            dirs.append(sup.checkpoint())
            assert sup.status()[0]["journal_len"] == 0
        assert sup.newest_committed() == dirs[-1]
        assert not os.path.exists(dirs[0])
        assert os.path.exists(dirs[1]) and os.path.exists(dirs[2])
        sup2 = ShardSupervisor(svc, checkpoint_root=root, ping_interval=5.0)
        assert sup2._scan_committed() == dirs[1:]
        ok, problems = _fsck().fsck_one(dirs[-1], deep=True)
        assert ok, problems
    finally:
        sup.stop()
        svc.close()
        srv.shutdown()


def test_unrecoverable_shard_raises_shard_down_error():
    srv = _serve(0, 1)
    svc = RemoteEmbeddingService([srv.endpoint], HEIGHT, DIM,
                                 policy=_fast_policy())
    sup = ShardSupervisor(svc, ping_interval=0.1,
                          recovery_timeout=1.0).start()
    try:
        srv.shutdown()
        srv.server_close()
        svc.shards[0].inner._chan.invalidate()
        deadline = time.monotonic() + 15
        with pytest.raises(ShardDownError):
            while time.monotonic() < deadline:
                svc.prefetch(np.arange(4, dtype=np.int64))
                time.sleep(0.1)
    finally:
        sup.stop()
        svc.close()
