"""The shard transport (paddle_tpu_torch/sparse/transport.py) against the
JAX package, on in-process ShardServers (threads):

  * the wire is the JAX package's: the port's RemoteEmbeddingService
    against JAX ShardServers and the JAX client against the port's
    servers, lookups and pushes bitwise equal to the JAX package's
    in-process service, the PING meta and the STATUS reply alike;
  * the resilience cases of tests/test_transport_resilience.py: an
    OP_ERROR reply is raised once with one request on the wire and leaves
    the stream usable, a timed-out lookup cannot poison later calls, a
    fan-out failure names every dead endpoint, a single one is raised
    verbatim;
  * resharding (tests/test_resharding.py:81, :128, :198): in process up
    and down, bitwise with the adagrad accumulators; a live 2 -> 4 under
    a ShardSupervisor while a trainer thread pushes; a stale client that
    refreshes instead of failing.  Every oracle there is the JAX
    package's EmbeddingService, fed the same ids and grads.
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from paddle_tpu.sparse import transport as jtp
from paddle_tpu.sparse.embedding_service import (
    EmbeddingService as JEmbeddingService,
)
from paddle_tpu.sparse.embedding_service import Shard as JShard
from paddle_tpu.sparse.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu_torch.resilience import (
    ChannelError,
    RemoteOpError,
    RpcPolicy,
    ShardSupervisor,
)
from paddle_tpu_torch.sparse import (
    EmbeddingService,
    MultiShardError,
    RemoteEmbeddingService,
    RemoteShard,
    SelectedRows,
    Shard,
    ShardServer,
)
from paddle_tpu_torch.sparse import transport as ptp
from paddle_tpu_torch.sparse.routing import RoutingTable

DIM = 4
HEIGHT = 10000
LR = 0.05


def _fast_policy(**kw):
    kw.setdefault("connect_timeout", 2.0)
    kw.setdefault("call_timeout", 1.0)
    kw.setdefault("max_attempts", 4)
    kw.setdefault("backoff_base", 0.02)
    kw.setdefault("jitter", 0.0)
    return RpcPolicy(**kw)


def _serve(server_cls, shard):
    srv = server_cls(shard)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(servers):
    for s in servers:
        s.shutdown()
        s.server_close()


# ---------------------------------------------------------------------------
# the wire across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("client", ["port", "jax"])
def test_each_packages_client_is_served_by_the_others_servers(client):
    if client == "port":
        servers = [_serve(jtp.ShardServer, JShard(i, 2, DIM,
                                                  learning_rate=LR))
                   for i in range(2)]
        svc_cls = RemoteEmbeddingService
    else:
        servers = [_serve(ShardServer, Shard(i, 2, DIM, learning_rate=LR))
                   for i in range(2)]
        svc_cls = jtp.RemoteEmbeddingService
    svc = svc_cls([s.endpoint for s in servers], HEIGHT, DIM)
    mirror = JEmbeddingService(HEIGHT, DIM, num_shards=2, learning_rate=LR)
    try:
        rng = np.random.RandomState(2)
        for _ in range(4):
            ids = rng.randint(0, 300, 64).astype(np.int64)
            np.testing.assert_array_equal(svc.prefetch(ids),
                                          mirror.prefetch(ids))
            grads = rng.uniform(-1, 1, (64, DIM)).astype(np.float32)
            svc.push_sparse_grad(SelectedRows(ids, grads, HEIGHT))
            mirror.push_sparse_grad(JSelectedRows(ids, grads, HEIGHT))
        audit = np.arange(400, dtype=np.int64)
        np.testing.assert_array_equal(svc.prefetch(audit),
                                      mirror.prefetch(audit))
        for i, sh in enumerate(svc.shards):
            meta = sh.ping()
            assert meta == {"index": i, "num_shards": 2, "dim": DIM,
                            "seed": 0, "init_scale": 0.01, "epoch": 0}
            ids, rows = sh.state()
            want_ids, want_rows = mirror.shards[i].state()
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_array_equal(rows, want_rows)
            assert set(sh.status()) == {"metrics", "spans"}
    finally:
        svc.close()
        _stop(servers)


def test_the_header_and_the_packing_are_the_jax_packages():
    assert ptp._HDR.format == jtp._HDR.format and ptp._HDR.size == 29
    for name in dir(jtp):
        if name.startswith("OP_") or name == "EPOCH_NONE":
            assert getattr(ptp, name) == getattr(jtp, name), name
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1 << 40, 7)
    vals = rng.randn(7, DIM).astype(np.float32)
    acc = rng.rand(7).astype(np.float32)
    assert ptp._pack_rows(ids, vals, acc, DIM) == jtp._pack_rows(
        ids, vals, acc, DIM)
    assert ptp._pack_slots([3, 9, 800], 840) == jtp._pack_slots(
        [3, 9, 800], 840)


# ---------------------------------------------------------------------------
# resilience (tests/test_transport_resilience.py)
# ---------------------------------------------------------------------------


class _AlwaysErrorServer:
    """Frame server that answers PING honestly and every other op with
    OP_ERROR, counting the requests."""

    def __init__(self):
        self.requests = {"error_replies": 0}
        self.lock = threading.Lock()
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self._stop = threading.Event()
        threading.Thread(target=self._loop, daemon=True).start()

    @property
    def endpoint(self):
        h, p = self._listener.getsockname()[:2]
        return f"{h}:{p}"

    def _ping(self, conn):
        ptp._send_frame(conn, ptp.OP_PING, json.dumps(
            {"index": 0, "num_shards": 1, "dim": DIM, "seed": 0,
             "init_scale": 0.01}).encode())

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                while True:
                    op, _payload = ptp._recv_frame(conn)
                    if op == ptp.OP_PING:
                        self._ping(conn)
                    else:
                        with self.lock:
                            self.requests["error_replies"] += 1
                        ptp._send_frame(conn, ptp.OP_ERROR,
                                        b"Traceback: injected handler failure")
            except (ConnectionError, OSError):
                continue

    def stop(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


def test_op_error_raised_once_single_request_on_the_wire():
    srv = _AlwaysErrorServer()
    try:
        sh = RemoteShard(srv.endpoint, DIM,
                         policy=_fast_policy(max_attempts=4))
        with pytest.raises(RemoteOpError) as ei:
            sh.lookup(np.array([1], dtype=np.int64))
        assert "injected handler failure" in str(ei.value)
        with srv.lock:
            assert srv.requests["error_replies"] == 1
        sh.close()
    finally:
        srv.stop()


def test_stream_usable_after_op_error():
    srv = _AlwaysErrorServer()
    try:
        sh = RemoteShard(srv.endpoint, DIM, policy=_fast_policy())
        with pytest.raises(RemoteOpError):
            sh.lookup(np.array([1], dtype=np.int64))
        assert sh._chan.connected
        assert sh.ping()["dim"] == DIM
        assert sh._chan.reconnects == 0
        sh.close()
    finally:
        srv.stop()


def test_timed_out_lookup_cannot_poison_later_calls():
    """A LOOKUP whose reply arrives after the deadline must not leave that
    frame where the next call would read it."""
    stall_once = threading.Event()
    stall_once.set()

    class _StallingServer(_AlwaysErrorServer):
        shard = Shard(0, 1, DIM, optimizer="sgd")

        def _loop(self):
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    return
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()

        def _serve_conn(self, conn):
            try:
                while True:
                    op, payload = ptp._recv_frame(conn)
                    if op == ptp.OP_PING:
                        self._ping(conn)
                        continue
                    (n,) = struct.unpack_from("<I", payload)
                    ids = np.frombuffer(payload, np.int64, n, offset=4)
                    rows = self.shard.lookup(ids).astype(np.float32)
                    if stall_once.is_set():
                        stall_once.clear()
                        time.sleep(0.6)     # the reply lands late
                    ptp._send_frame(conn, op, rows.tobytes())
            except (ConnectionError, OSError):
                return

    srv = _StallingServer()
    try:
        sh = RemoteShard(srv.endpoint, DIM, policy=_fast_policy(
            call_timeout=0.2, max_attempts=2))
        a = np.array([3], dtype=np.int64)
        b = np.array([9], dtype=np.int64)
        got_a = sh.lookup(a)
        got_b = sh.lookup(b)
        assert sh._chan.reconnects >= 1
        ref = Shard(0, 1, DIM, optimizer="sgd")
        np.testing.assert_array_equal(got_a, ref.lookup(a))
        np.testing.assert_array_equal(got_b, ref.lookup(b))
        sh.close()
    finally:
        srv.stop()


def _two_servers():
    return [_serve(ShardServer, Shard(i, 2, DIM, optimizer="sgd"))
            for i in range(2)]


def test_every_dead_endpoint_named():
    servers = _two_servers()
    endpoints = [s.endpoint for s in servers]
    svc = RemoteEmbeddingService(
        endpoints, height=1000, dim=DIM,
        policy=_fast_policy(call_timeout=0.3, max_attempts=1,
                            connect_timeout=0.3))
    ids = np.array([1, 2, 3, 4], dtype=np.int64)
    assert svc.prefetch(ids).shape == (4, DIM)
    _stop(servers)
    for sh in svc.shards:
        sh._chan.invalidate()
    with pytest.raises(MultiShardError) as ei:
        svc.prefetch(ids)
    msg = str(ei.value)
    assert all(ep in msg for ep in endpoints), msg
    assert len(ei.value.failures) == 2
    assert all(isinstance(e, (ChannelError, ConnectionError, OSError))
               for _ep, _m, e in ei.value.failures)
    svc.close()


def test_single_failure_raised_verbatim():
    servers = _two_servers()
    svc = RemoteEmbeddingService(
        [s.endpoint for s in servers], height=1000, dim=DIM,
        policy=_fast_policy(call_timeout=0.3, max_attempts=1,
                            connect_timeout=0.3))
    _stop(servers[1:])
    svc.shards[1]._chan.invalidate()
    with pytest.raises(ChannelError) as ei:
        svc.prefetch(np.array([0, 1, 2, 3], dtype=np.int64))
    assert servers[1].endpoint in str(ei.value)
    svc.close()
    _stop(servers[:1])


# ---------------------------------------------------------------------------
# resharding (tests/test_resharding.py)
# ---------------------------------------------------------------------------

RDIM = 8
# the shard servers of the live reshard run adagrad, so that the
# accumulators migrate with the rows
ROPT = "adagrad"


def _train(svc, oracle, rng, steps):
    for _ in range(steps):
        ids = rng.randint(0, HEIGHT, 64).astype(np.int64)
        grads = rng.uniform(-1, 1, (64, RDIM)).astype(np.float32)
        svc.prefetch(ids)
        svc.push_sparse_grad(SelectedRows(ids, grads, HEIGHT))
        oracle.push_sparse_grad(JSelectedRows(ids, grads, HEIGHT))


def _audit_equal(svc, oracle, seed=5, n=2048):
    audit = np.random.RandomState(seed).randint(
        0, HEIGHT, n).astype(np.int64)
    return bool(np.array_equal(svc.prefetch(audit), oracle.prefetch(audit)))


def _by_id(svc):
    """A service's resident (ids, rows, accumulators), every shard's
    together, sorted by id."""
    shards = svc.state_dict()["shards"].values()
    ids, vals, accum = (np.concatenate([s[k] for s in shards])
                        for k in ("ids", "vals", "accum"))
    order = np.argsort(ids, kind="stable")
    return ids[order], vals[order], accum[order]


def _same_state(a, b):
    """Two services' states are equal bitwise, shard by shard."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["meta"] == sb["meta"]
    assert sorted(sa["shards"]) == sorted(sb["shards"])
    for i, snap in sa["shards"].items():
        for k in ("ids", "vals", "accum"):
            np.testing.assert_array_equal(snap[k], sb["shards"][i][k],
                                          err_msg=f"shard {i} {k}")


def test_reshard_up_down_bitwise_with_adagrad_accumulators():
    """The port's service resharded 2 -> 4 -> 2 while it trains: shard
    for shard bitwise the JAX service put through the same schedule, and
    id for id (rows and adagrad accumulators) a never-resharded JAX
    service's."""
    svc = EmbeddingService(HEIGHT, RDIM, num_shards=2, optimizer="adagrad",
                           learning_rate=0.1)
    twin = JEmbeddingService(HEIGHT, RDIM, num_shards=2, optimizer="adagrad",
                             learning_rate=0.1)
    oracle = JEmbeddingService(HEIGHT, RDIM, num_shards=1,
                               optimizer="adagrad", learning_rate=0.1)

    def train(steps):
        for _ in range(steps):
            ids = rng.randint(0, HEIGHT, 64).astype(np.int64)
            grads = rng.uniform(-1, 1, (64, RDIM)).astype(np.float32)
            svc.push_sparse_grad(SelectedRows(ids, grads, HEIGHT))
            for ref in (twin, oracle):
                ref.push_sparse_grad(JSelectedRows(ids, grads, HEIGHT))

    def audit():
        """Every service looks the same ids up (which makes them
        resident on each alike)."""
        assert _audit_equal(svc, oracle)
        assert _audit_equal(twin, oracle)

    rng = np.random.RandomState(7)
    train(5)
    svc.reshard(4)
    twin.reshard(4)
    assert svc.num_shards == 4 and svc.routing.epoch > 0
    _same_state(svc, twin)
    train(5)
    audit()
    svc.reshard(2)
    twin.reshard(2)
    _same_state(svc, twin)
    train(5)
    assert svc.num_shards == 2
    audit()
    assert svc.routing.same_placement(RoutingTable.modulo(2))
    _same_state(svc, twin)
    for got, want in zip(_by_id(svc), _by_id(oracle)):
        np.testing.assert_array_equal(got, want)


class _InProcessFleet:
    """Shard servers on threads; `spawn(i)` starts shard i of a 4-shard
    layout, as a supervisor's spawn hook."""

    def __init__(self, n):
        self.servers = []
        self.endpoints = [self._start(i, n) for i in range(n)]

    def _start(self, i, n):
        srv = _serve(ShardServer, Shard(i, n, RDIM, optimizer=ROPT,
                                        learning_rate=LR))
        self.servers.append(srv)
        return srv.endpoint

    def spawn(self, i):
        return self._start(i, 4)

    def close(self):
        _stop(self.servers)


def _reshard_policy():
    return RpcPolicy(connect_timeout=1.0, call_timeout=2.0, max_attempts=2,
                     backoff_base=0.05, jitter=0.0)


def test_online_2_to_4_mid_training_bitwise(tmp_path):
    """A live 2 -> 4 reshard under a trainer thread: the trainer never
    pauses, and lookups after the cutover equal a never-resharded
    oracle's bitwise."""
    fleet = _InProcessFleet(2)
    svc = RemoteEmbeddingService(fleet.endpoints, HEIGHT, RDIM,
                                 policy=_reshard_policy())
    oracle = JEmbeddingService(HEIGHT, RDIM, num_shards=1, optimizer=ROPT,
                               learning_rate=LR)
    sup = ShardSupervisor(svc, checkpoint_root=str(tmp_path / "ckpts"),
                          spawn=fleet.spawn, ping_interval=0.1,
                          degraded_lookup=False,
                          recovery_timeout=60.0).start()
    stop = threading.Event()
    errors, stepped = [], {"n": 0}

    def trainer():
        r = np.random.RandomState(3)
        try:
            while not stop.is_set():
                _train(svc, oracle, r, 1)
                stepped["n"] += 1
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    th = threading.Thread(target=trainer, daemon=True)
    try:
        th.start()
        while stepped["n"] < 5:
            time.sleep(0.01)
        table = sup.reshard(4)
        during = stepped["n"]
        deadline = time.monotonic() + 10
        while stepped["n"] <= during and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        th.join(timeout=30)
        assert not errors, errors
        assert stepped["n"] > during, "trainer paused at cutover"
        assert table.num_shards == 4
        assert svc.routing.epoch == table.epoch
        assert _audit_equal(svc, oracle)
        assert svc.routing.same_placement(RoutingTable.modulo(4))
    finally:
        stop.set()
        sup.stop()
        svc.close()
        fleet.close()


def test_stale_client_refreshes_never_remote_op_error(tmp_path):
    fleet = _InProcessFleet(2)
    svc = RemoteEmbeddingService(fleet.endpoints, HEIGHT, RDIM,
                                 policy=_reshard_policy())
    stale = RemoteEmbeddingService(fleet.endpoints, HEIGHT, RDIM,
                                   policy=_reshard_policy())
    oracle = JEmbeddingService(HEIGHT, RDIM, num_shards=1, optimizer=ROPT,
                               learning_rate=LR)
    sup = None
    try:
        rng = np.random.RandomState(11)
        _train(svc, oracle, rng, 3)
        sup = ShardSupervisor(svc, checkpoint_root=str(tmp_path / "ckpts"),
                              spawn=fleet.spawn, ping_interval=0.1,
                              recovery_timeout=60.0).start()
        sup.reshard(4)
        assert stale.routing.epoch == 0
        try:
            _train(stale, oracle, rng, 3)
        except RemoteOpError as e:
            pytest.fail(f"stale client surfaced RemoteOpError: {e}")
        assert stale.routing.epoch == svc.routing.epoch
        assert stale.num_shards == 4
        assert _audit_equal(stale, oracle)
    finally:
        if sup is not None:
            sup.stop()
        svc.close()
        stale.close()
        fleet.close()
