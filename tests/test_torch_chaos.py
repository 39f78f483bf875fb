"""The port's ChaosProxy (paddle_tpu_torch/resilience/chaos.py): the twins
of the 8 tests of tests/test_chaos_proxy.py, and its seeded schedule
against the JAX package's.

The JAX tests drive a sparse shard server through the proxy; the port has
no sparse tier yet (ROADMAP.md A item 8), so the twins drive a stand-in
with the same shape: a framed lookup server (the serving wire's frame
header, `serving.rpc._send_frame`) that answers an id vector with rows
that are a pure function of the ids, and a client on the port's
`ResilientChannel`.  Each scripted fault maps onto the client-visible
failure it must produce and, where the channel retries, survive with the
same rows.
"""

import json
import socketserver
import threading

import numpy as np
import pytest

from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch.resilience import (
    ChannelError,
    ChaosProxy,
    RemoteOpError,
    ResilientChannel,
    RpcPolicy,
)
from paddle_tpu_torch.serving import rpc as prpc

DIM = 4
OP_LOOKUP, OP_PING = 1, 5


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            while True:
                op, payload = prpc._recv_frame(self.request)
                if op == OP_LOOKUP:
                    ids = np.frombuffer(payload, np.int64)
                    rows = (ids[:, None] * DIM
                            + np.arange(DIM)).astype(np.float32) / 7.0
                    prpc._send_frame(self.request, op, rows.tobytes())
                elif op == OP_PING:
                    prpc._send_frame(self.request, op,
                                     json.dumps({"index": 0}).encode())
                else:
                    prpc._send_frame(self.request, prpc.OP_ERROR,
                                     f"bad op {op}".encode())
        except (ConnectionError, OSError):
            return


class _LookupServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Handler)
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def endpoint(self):
        h, p = self.server_address[:2]
        return f"{h}:{p}"


class _Lookup:
    """The shard client's shape: lookup(ids) -> [n, DIM] rows, ping()."""

    def __init__(self, endpoint, policy):
        self.chan = ResilientChannel(endpoint, policy, name="lookup")

    def _call(self, op, payload=b""):
        def transact(sock):
            prpc._send_frame(sock, op, payload)
            got, data = prpc._recv_frame(sock)
            if got == prpc.OP_ERROR:
                raise RemoteOpError(data.decode())
            if got != op:
                raise ConnectionError(f"reply op {got} to {op}")
            return data

        return self.chan.call(transact)

    def lookup(self, ids):
        data = self._call(OP_LOOKUP, np.asarray(ids, np.int64).tobytes())
        return np.frombuffer(data, np.float32).reshape(-1, DIM)

    def ping(self):
        return json.loads(self._call(OP_PING).decode())

    def close(self):
        self.chan.close()


def _fast_policy(**kw):
    kw.setdefault("connect_timeout", 2.0)
    kw.setdefault("call_timeout", 0.5)
    kw.setdefault("max_attempts", 3)
    kw.setdefault("backoff_base", 0.02)
    kw.setdefault("jitter", 0.0)
    return RpcPolicy(**kw)


@pytest.fixture
def server():
    srv = _LookupServer()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def proxy(server):
    px = ChaosProxy(server.endpoint).start()
    yield px
    px.stop()


def test_clean_passthrough_is_transparent(server, proxy):
    direct = _Lookup(server.endpoint, _fast_policy())
    proxied = _Lookup(proxy.endpoint, _fast_policy())
    try:
        ids = np.array([1, 5, 9], dtype=np.int64)
        np.testing.assert_array_equal(proxied.lookup(ids), direct.lookup(ids))
        assert proxied.ping()["index"] == 0
        assert proxy.counters["conns"] >= 1
        assert proxy.counters["dropped_conns"] == 0
    finally:
        direct.close()
        proxied.close()


def test_drop_next_closes_connection_client_retries(proxy):
    sh = _Lookup(proxy.endpoint, _fast_policy())
    try:
        ids = np.array([2], dtype=np.int64)
        want = sh.lookup(ids)
        proxy.drop_next(1)
        # dropped once, retried through, identical
        np.testing.assert_array_equal(sh.lookup(ids), want)
        assert proxy.counters["dropped_conns"] == 1
        assert sh.chan.reconnects == 1
    finally:
        sh.close()


def test_stall_makes_reply_late_channel_stays_in_sync(proxy):
    """A stalled reply times the request out; the retry (and every later
    call) gets the right answer — never the stale frame."""
    sh = _Lookup(proxy.endpoint, _fast_policy(call_timeout=0.3,
                                              max_attempts=2))
    try:
        a = np.array([3], dtype=np.int64)
        b = np.array([8], dtype=np.int64)
        want_a, want_b = sh.lookup(a), sh.lookup(b)
        proxy.stall_next(1, seconds=1.0)
        np.testing.assert_array_equal(sh.lookup(a), want_a)
        # the late frame died with its socket; b still resolves to b
        np.testing.assert_array_equal(sh.lookup(b), want_b)
        assert proxy.counters["stalled_chunks"] == 1
    finally:
        sh.close()


def test_blackhole_times_out_every_attempt(proxy):
    proxy.set_fault(blackhole=True)
    sh = _Lookup(proxy.endpoint, _fast_policy(call_timeout=0.2,
                                              max_attempts=2))
    try:
        with pytest.raises(ChannelError):
            sh.lookup(np.array([1], dtype=np.int64))
        assert proxy.counters["blackholed_chunks"] >= 1
        proxy.set_fault(blackhole=False)
        rows = sh.lookup(np.array([1], dtype=np.int64))   # heals
        assert rows.shape == (1, DIM)
    finally:
        sh.close()


def test_refuse_rejects_connections(proxy):
    proxy.set_fault(refuse=True)
    sh = _Lookup(proxy.endpoint, _fast_policy(call_timeout=0.3,
                                              max_attempts=2))
    try:
        with pytest.raises((ChannelError, ConnectionError)):
            sh.lookup(np.array([0], dtype=np.int64))
        assert proxy.counters["refused"] >= 1
    finally:
        sh.close()


def test_kill_connections_resets_live_streams(proxy):
    sh = _Lookup(proxy.endpoint, _fast_policy())
    try:
        ids = np.array([7], dtype=np.int64)
        want = sh.lookup(ids)
        proxy.kill_connections()
        np.testing.assert_array_equal(sh.lookup(ids), want)   # reconnects
        assert proxy.counters["killed_conns"] >= 1
    finally:
        sh.close()


def test_seeded_fault_schedule_is_deterministic():
    """The same seed replays the same schedule, and it is the JAX
    package's schedule draw for draw (one random.Random, one draw a
    chunk, the same cumulative thresholds)."""
    draws = []
    for make in (ChaosProxy, ChaosProxy, jchaos.ChaosProxy):
        px = make("127.0.0.1:1", seed=42, drop_rate=0.3, truncate_rate=0.1,
                  delay_rate=0.3, delay_s=0.0)
        px.stall_next(2, seconds=0.0)
        draws.append([px._decide(d)[0] for d in ("up", "down") * 24])
        px.stop()
    assert draws[0] == draws[1] == draws[2]
    assert {"drop", "truncate", "delay", "forward", "stall"} \
        <= set(draws[0])


def test_set_fault_rejects_unknown_knob():
    px = ChaosProxy("127.0.0.1:1")
    try:
        with pytest.raises(ValueError):
            px.set_fault(explode_rate=1.0)
        px.set_fault(drop_rate=0.5, blackhole=True)
        assert px.drop_rate == 0.5 and px.blackhole
    finally:
        px.stop()
