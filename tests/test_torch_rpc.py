"""The port's RPC front end (paddle_tpu_torch/serving/rpc.py) and resilient
channel (paddle_tpu_torch/resilience/channel.py), on loopback, on the CPU.

  * the port's own server: round trip, per-token streaming, a client that
    disconnects mid-stream cancels its request, a deadline_ms=0 SUBMIT is
    refused at the wire before the Scheduler counts it, drain and
    undrain, QUIESCE, STATS, PING, and STATUS (the registry snapshot and
    one stitched trace a request: client span -> channel attempt ->
    "serving.submit" -> "serving.request");
  * an idempotent resubmit: a proxy cuts the first connection after 3
    TOKEN frames, the client resubmits on a fresh one under the same
    request_id, the replayed prefix is checked bitwise and `on_token`
    fires once a token;
  * the channel: RetryBudget and RpcPolicy.backoff against the JAX
    package's, reconnects against a flaky echo server, the timeout's
    socket invalidation (no desync), retries exhausted, a RemoteOpError
    never retried, a spent retry budget failing fast;
  * across packages: a JAX ServingClient against the port's server and
    the port's client against a JAX server give the tokens of each
    package's sequential Generator, so the frames are the same bytes.

The model is the JAX tests' tiny transformer (one layer), its weights
carried from the JAX startup.  Every wait is bounded: clients use a
policy with a 5 s call timeout, `result(timeout=)`, and servers are shut
down in `finally`.
"""

import json
import socket
import socketserver
import threading
import time

import numpy as np
import pytest

from paddle_tpu import decode as jdecode
from paddle_tpu import resilience as jres
from paddle_tpu import serving as jserving
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, decode as pdecode, flags as pflags
from paddle_tpu_torch import resilience as pres
from paddle_tpu_torch import serving, telemetry as ptelem, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.serving import rpc as prpc

CPU = pt.CPUPlace()
S, P, MAXLEN, V = 8, 7, 28, 40
MNT = 10


def _policy(mod=pres, **kw):
    kw.setdefault("connect_timeout", 2.0)
    kw.setdefault("call_timeout", 5.0)
    kw.setdefault("max_attempts", 3)
    kw.setdefault("backoff_base", 0.01)
    return mod.RpcPolicy(**kw)


@pytest.fixture(autouse=True)
def _fresh_state():
    ptelem.disable()
    ptelem.reset_metrics()
    ptelem.reset_spans()
    with testing.fresh_programs():
        yield
    ptelem.disable()
    ptelem.reset_metrics()
    ptelem.reset_spans()


def _cfg(T):
    cfg = T.tiny(vocab=V, max_length=16)
    cfg.n_layer = 1
    return cfg


def _mk_feed(seed):
    r = np.random.default_rng(seed)
    return {
        "src_ids": r.integers(2, V, size=(1, S)).astype(np.int64),
        "src_lens": np.array([int(r.integers(S // 2, S + 1))], np.int64),
        "trg_ids": r.integers(2, V, size=(1, P)).astype(np.int64),
        "prefix_lens": np.array([int(r.integers(1, P + 1))], np.int64),
    }


class _World:
    def __init__(self):
        with junique.guard():
            self.jspec = JT.build_decode(_cfg(JT), src_len=S, prefix_len=P,
                                         max_len=MAXLEN)
        self.jscope = JScope()
        self.jgen = jdecode.Generator(self.jspec, scope=self.jscope)
        self.spec = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                                    max_len=MAXLEN)
        progs = [self.spec.prefill_program, self.spec.step_program]
        declared = {v.name for p in progs for v in p.list_vars()
                    if v.persistable}
        self.scope = pt.Scope()
        convert.load_params(self.scope, {
            n: np.asarray(self.jscope.find_var(n))
            for n in self.jscope.local_var_names() if n in declared},
            CPU, progs)
        self.gen = pdecode.Generator(self.spec, scope=self.scope, place=CPU)

    def refs(self, feeds, mnt=MNT, eos=1):
        """(the port's, the JAX package's) sequential tokens."""
        mine = [self.gen.generate(f, mnt, eos_id=eos)[0].tolist()
                for f in feeds]
        theirs = [np.asarray(self.jgen.generate(f, mnt, eos_id=eos))[0]
                  .tolist() for f in feeds]
        return mine, theirs


@pytest.fixture(scope="module")
def world():
    with testing.fresh_programs():
        return _World()


def _serve(world, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 64)
    return serving.serve(world.spec, world.scope, place=CPU, **kw)


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_round_trip_streaming_and_disconnect_cancels(world):
    feeds = [_mk_feed(30 + i) for i in range(3)]
    refs, jrefs = world.refs(feeds)
    assert refs == jrefs
    srv, sched = _serve(world)
    cli = serving.ServingClient(srv.endpoint, _policy())
    try:
        pong = cli.ping()
        assert pong["ok"] and pong["max_batch"] == 4 and not pong["draining"]
        streamed = []
        toks, status = cli.generate(feeds[0], MNT, eos_id=1,
                                    on_token=streamed.append)
        assert status == "done" and toks.dtype == np.int64
        assert toks.tolist() == refs[0] == streamed
        for f, ref in zip(feeds[1:], refs[1:]):
            toks, status = cli.generate(f, MNT, eos_id=1)
            assert status == "done" and toks.tolist() == ref
        assert cli.stats()["completed"] == 3

        # a client gone after 2 tokens: its request is cancelled and its
        # blocks come back at the next step boundary (each iteration slowed
        # down, so that the request outlives the handler's failed write)
        step = sched._step_impl
        sched._step_impl = lambda: (time.sleep(0.02), step())[1]
        raw = socket.create_connection(srv.server_address[:2], 5.0)
        raw.settimeout(5.0)
        prpc._send_frame(raw, prpc.OP_SUBMIT, prpc._pack_submit(
            _mk_feed(44), {"max_new_tokens": 20, "eos_id": -1}))
        for _ in range(2):
            op, _ = prpc._recv_frame(raw)
            assert op == prpc.OP_TOKEN
        raw.close()
        assert _wait(lambda: sched.stats()["cancelled"] >= 1
                     and sched.stats()["active"] == 0)
        q = cli.quiesce(timeout_s=5.0)
        assert q["ok"] and q["used_blocks"] == 0
    finally:
        cli.close()
        srv.shutdown()
        sched.close()


def test_expired_deadline_refused_before_the_scheduler(world):
    srv, sched = _serve(world)
    host, port = srv.endpoint.rsplit(":", 1)
    cli = serving.ServingClient(srv.endpoint, _policy())
    try:
        with socket.create_connection((host, int(port)), 5.0) as s:
            s.settimeout(5.0)
            meta = {"max_new_tokens": 4, "deadline_ms": 0,
                    "eos_id": 1, "request_id": "raw-expired"}
            prpc._send_frame(s, prpc.OP_SUBMIT,
                             prpc._pack_submit(_mk_feed(1), meta))
            op, payload = prpc._recv_frame(s)
        assert op == prpc.OP_REJECT
        info = json.loads(payload.decode("utf-8"))
        assert info["reason"] == "expired" and info["retry_after_ms"] is None
        # the client refuses a spent budget without a frame
        with pytest.raises(serving.AdmissionRejected) as ei:
            cli.generate(_mk_feed(1), 4, deadline_ms=-5.0, eos_id=1,
                         retryable=False)
        assert ei.value.reason == "expired"
        assert sched.counters["submitted"] == 0
        sched.pool.assert_quiesced()
    finally:
        cli.close()
        srv.shutdown()
        sched.close()


def test_drain_quiesce_status_and_one_trace(world):
    feed = _mk_feed(5)
    (ref,), _ = world.refs([feed], 6)
    srv, sched = _serve(world, version="v-port")
    cli = serving.ServingClient(srv.endpoint, _policy())
    try:
        assert cli.drain(True) == {"ok": True, "draining": True}
        assert cli.ping()["draining"] and cli.ping()["version"] == "v-port"
        with pytest.raises(serving.ReplicaDraining):
            cli.generate(feed, 6, eos_id=1)
        assert cli.drain(False)["draining"] is False

        ptelem.enable()
        with ptelem.span("client.call") as client:
            toks, status = cli.generate(feed, 6, eos_id=1)
        assert status == "done" and toks.tolist() == ref
        trace = client.context.trace_id
        # the handler closes "serving.submit" after it has sent the last
        # TOKEN frame, so generate() may return before that span is in the
        # ring: wait for every span read below before reading the ring or
        # draining it with status()
        read = {"rpc.serving.attempt", "serving.submit", "serving.request"}
        assert _wait(lambda: read <= {r["name"] for r in ptelem.spans()},
                     10.0)
        by = {r["name"]: r for r in ptelem.spans()}
        attempt, submit = by["rpc.serving.attempt"], by["serving.submit"]
        request = by["serving.request"]
        for rec in (attempt, submit, request):
            assert rec["trace"] == trace
        assert attempt["parent"] == client.context.span_id
        assert submit["parent"] == attempt["span"]
        assert request["parent"] == submit["span"]
        assert request["attrs"]["tokens"] == len(ref)

        st = cli.status()
        counters = st["metrics"]["counters"]
        assert counters["serving.submitted"] == 1
        assert counters["rpc.attempts"] >= 1
        assert any(s["name"] == "serving.request" for s in st["spans"])
        assert st["metrics"]["histograms"]["serving.ttft_ms"]["count"] == 1
        assert all(r["name"] == "rpc.serving.attempt"
                   for r in ptelem.spans())   # the ring was drained
        stats = cli.stats()
        assert stats["completed"] == 1 and stats["overload"] is None
        q = cli.quiesce(timeout_s=5.0)
        assert q == {"ok": True, "idle": True, "used_blocks": 0}
    finally:
        cli.close()
        srv.shutdown()
        sched.close()


class _CutProxy(socketserver.ThreadingTCPServer):
    """Forwards to `upstream`; the first connection is cut (both sides
    closed) once `cut_after` bytes went back to the client."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, upstream, cut_after):
        self.upstream = upstream
        self.cut_after = cut_after
        self.connections = 0
        super().__init__(("127.0.0.1", 0), _CutHandler)
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def endpoint(self):
        h, p = self.server_address[:2]
        return f"{h}:{p}"


class _CutHandler(socketserver.BaseRequestHandler):
    def handle(self):
        self.server.connections += 1
        cut = self.server.cut_after if self.server.connections == 1 \
            else None
        host, port = self.server.upstream.rsplit(":", 1)
        up = socket.create_connection((host, int(port)), 5.0)
        down = self.request
        for s in (up, down):
            s.settimeout(10.0)

        def pump_up():
            try:
                while True:
                    data = down.recv(65536)
                    if not data:
                        break
                    up.sendall(data)
            except OSError:
                pass

        threading.Thread(target=pump_up, daemon=True).start()
        sent = 0
        try:
            while True:
                data = up.recv(65536 if cut is None else cut - sent)
                if not data:
                    break
                down.sendall(data)
                sent += len(data)
                if cut is not None and sent >= cut:
                    break
        except OSError:
            pass
        finally:
            for s in (up, down):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                s.close()


def test_idempotent_resubmit_replays_a_bitwise_prefix(world):
    feed = _mk_feed(7)
    (ref,), _ = world.refs([feed], MNT, eos=-1)
    srv, sched = _serve(world)
    frame = prpc._HDR.size + 8
    proxy = _CutProxy(srv.endpoint, cut_after=3 * frame)
    cli = serving.ServingClient(proxy.endpoint, _policy())
    try:
        seen = []
        toks, status = cli.generate(feed, MNT, eos_id=-1,
                                    request_id="rid-cut",
                                    on_token=seen.append)
        assert proxy.connections == 2   # cut once, resubmitted once
        assert status == "done" and toks.tolist() == ref == seen
        st = sched.stats()
        assert st["dedup_hits"] + st["imported"] >= 1
        # the same request_id again attaches to the finished generation
        again, status = cli.generate(feed, MNT, eos_id=-1,
                                     request_id="rid-cut")
        assert status == "done" and again.tolist() == ref
        assert sched.stats()["dedup_hits"] >= 1
        assert cli.quiesce(timeout_s=5.0)["used_blocks"] == 0
    finally:
        cli.close()
        proxy.shutdown()
        srv.shutdown()
        sched.close()


# ---------------------------------------------------------------------------
# the channel
# ---------------------------------------------------------------------------


def test_retry_budget_and_backoff_match_jax():
    for ratio, cap in ((10, 2.0), (25, 3.0), (0, 1.0)):
        jb, pb = jres.RetryBudget(ratio, cap), pres.RetryBudget(ratio, cap)
        ops = np.random.RandomState(ratio).rand(200) < 0.6
        for call in ops:
            if call:
                jb.on_call()
                pb.on_call()
            else:
                assert pb.try_retry() == jb.try_retry()
            assert pb.tokens() == jb.tokens()
        assert pb.exhausted == jb.exhausted
    for kw in (dict(backoff_base=0.1, backoff_max=0.4, jitter=0.0),
               dict(backoff_base=0.05, jitter=0.5, seed=7), dict(seed=3)):
        jp, pp = jres.RpcPolicy(**kw), pres.RpcPolicy(**kw)
        assert [pp.backoff(k) for k in range(8)] == \
            [jp.backoff(k) for k in range(8)]
        assert (pp.max_attempts, pp.call_timeout, pp.backoff_base) == \
            (jp.max_attempts, jp.call_timeout, jp.backoff_base)
    p = pres.RpcPolicy()
    assert p.max_attempts == pflags.get("rpc_max_attempts") == 4
    assert p.call_timeout == pflags.get("rpc_call_timeout_ms") / 1e3
    assert pres.RetryBudget().ratio == pflags.get("retry_budget_ratio") / 100
    for exc, retry in ((ConnectionRefusedError(), True),
                       (ConnectionResetError(), True),
                       (socket.timeout(), True), (EOFError(), True),
                       (pres.RemoteOpError("x"), False),
                       (serving.AdmissionRejected("expired"), False),
                       (ValueError("x"), False)):
        assert p.is_retryable(exc) is retry
    mine = pres.RetryBudget(ratio=10, cap=3.0)
    try:
        pres.reset_retry_budget(mine)
        assert pres.retry_budget() is mine
    finally:
        pres.reset_retry_budget()


class _Echo(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                return
            with self.server.lock:
                self.server.requests += 1
                if self.server.close_next > 0:
                    self.server.close_next -= 1
                    return
                delay = self.server.stalls.pop(0) if self.server.stalls \
                    else 0.0
            if delay:
                time.sleep(delay)
            try:
                self.wfile.write(b"echo:" + line)
                self.wfile.flush()
            except OSError:
                return


class _EchoServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Echo)
        self.lock = threading.Lock()
        self.requests = 0
        self.stalls = []
        self.close_next = 0
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def endpoint(self):
        h, p = self.server_address[:2]
        return f"{h}:{p}"


def _chan(endpoint, **kw):
    kw.setdefault("call_timeout", 0.5)
    kw.setdefault("jitter", 0.0)
    return pres.ResilientChannel(endpoint, _policy(**kw),
                                 wrap=lambda s: s.makefile("rwb"),
                                 name="test")


def _ask(chan, msg):
    data = (msg + "\n").encode()

    def transact(f):
        f.write(data)
        f.flush()
        line = f.readline()
        if not line:
            raise ConnectionError("server closed")
        return line.decode().strip()

    return chan.call(transact)


def _dead_endpoint():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return f"127.0.0.1:{port}"


def test_channel_reconnects_and_never_desyncs():
    ptelem.enable()
    srv = _EchoServer()
    chan = _chan(srv.endpoint)
    try:
        assert _ask(chan, "a") == "echo:a" and chan.reconnects == 0
        with srv.lock:
            srv.close_next = 1   # the server drops the next call
        assert _ask(chan, "b") == "echo:b"
        assert chan.reconnects == 1 and srv.requests == 3
        # a timed-out call closes its socket: the late reply is never read
        # as the next call's
        one = _chan(srv.endpoint, call_timeout=0.3, max_attempts=1)
        srv.stalls.append(1.0)
        with pytest.raises(pres.ChannelError) as ei:
            _ask(one, "one")
        assert isinstance(ei.value.__cause__, OSError)
        assert not one.connected
        time.sleep(0.9)
        assert _ask(one, "two") == "echo:two" and one.reconnects == 1
        one.close()

        def failing(f):
            f.write(b"x\n")
            f.flush()
            f.readline()
            raise pres.RemoteOpError("handler raised")

        before = srv.requests
        with pytest.raises(pres.RemoteOpError):
            chan.call(failing)
        assert chan.connected and srv.requests == before + 1
        snap = ptelem.snapshot()["counters"]
        assert snap["rpc.reconnects"] == 2 and snap["rpc.retries"] >= 1
        attempts = [r for r in ptelem.spans()
                    if r["name"] == "rpc.test.attempt"]
        assert {r["attrs"]["attempt"] for r in attempts} == {0, 1}
    finally:
        chan.close()
        srv.shutdown()


def test_channel_gives_up_and_spends_its_budget():
    ep = _dead_endpoint()
    chan = _chan(ep, max_attempts=3)
    with pytest.raises(pres.ChannelError) as ei:
        _ask(chan, "x")
    assert "3 attempt(s)" in str(ei.value)
    with pytest.raises(pres.ChannelError) as ei:
        chan.call(lambda c: c, retryable=False)
    assert "1 attempt(s)" in str(ei.value)
    budget = pres.RetryBudget(ratio=10, cap=1.0)
    fast = pres.ResilientChannel(
        ep, _policy(connect_timeout=0.2, call_timeout=0.2, max_attempts=8,
                    backoff_base=0.001, backoff_max=0.002, seed=0),
        budget=budget)
    t0 = time.monotonic()
    with pytest.raises(pres.ChannelError) as ei:
        fast.call(lambda s: s.recv(1))
    assert "retry budget exhausted" in str(ei.value)
    assert budget.exhausted == 1 and time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# across packages: the same frames
# ---------------------------------------------------------------------------


def test_jax_client_against_the_port_server(world):
    feeds = [_mk_feed(60 + i) for i in range(3)]
    refs, jrefs = world.refs(feeds)
    assert refs == jrefs
    srv, sched = _serve(world)
    cli = jserving.ServingClient(srv.endpoint, _policy(jres))
    try:
        assert cli.ping()["ok"]
        got = []
        for f in feeds:
            toks, status = cli.generate(f, MNT, eos_id=1)
            assert status == "done"
            got.append(np.asarray(toks).tolist())
        assert got == refs
        # the JAX package's frames of an expired SUBMIT, refused by the port
        host, port = srv.endpoint.rsplit(":", 1)
        with socket.create_connection((host, int(port)), 5.0) as s:
            s.settimeout(5.0)
            jserving.rpc._send_frame(s, jserving.rpc.OP_SUBMIT,
                                     jserving.rpc._pack_submit(
                                         feeds[0], {"max_new_tokens": 4,
                                                    "deadline_ms": 0}))
            op, data = jserving.rpc._recv_frame(s)
        assert op == jserving.rpc.OP_REJECT
        assert json.loads(data.decode("utf-8"))["reason"] == "expired"
        assert cli.stats()["completed"] == 3
        assert cli.quiesce(timeout_s=5.0)["used_blocks"] == 0
    finally:
        cli.close()
        srv.shutdown()
        sched.close()


def test_port_client_against_a_jax_server(world):
    feeds = [_mk_feed(70 + i) for i in range(3)]
    refs, jrefs = world.refs(feeds)
    srv, sched = jserving.serve(world.jspec, world.jscope, max_batch=4,
                                block_size=8, num_blocks=64)
    cli = serving.ServingClient(srv.endpoint, _policy())
    try:
        assert cli.ping()["max_batch"] == 4
        streamed = []
        got = []
        for f in feeds:
            toks, status = cli.generate(f, MNT, eos_id=1,
                                        on_token=streamed.append)
            assert status == "done"
            got.append(toks.tolist())
        assert got == jrefs == refs
        assert streamed == [t for r in refs for t in r]
        assert cli.drain(True)["draining"]
        with pytest.raises(serving.ReplicaDraining):
            cli.generate(feeds[0], MNT, eos_id=1)
        assert not cli.drain(False)["draining"]
        assert cli.stats()["completed"] == 3
        assert cli.quiesce(timeout_s=5.0)["used_blocks"] == 0
    finally:
        cli.close()
        srv.shutdown()
        sched.close()


def _handoff_record():
    r = np.random.default_rng(5)
    return {
        "request_id": "r1", "feed": {"x": [1, 2]}, "max_new_tokens": 4,
        "tokens": [7], "eos_id": 1, "bos_id": None, "deadline_ms": None,
        "priority": "interactive", "cursor": 5, "last_tok": 7,
        "n_tokens": 1,
        "kv": {"cache_k_0": r.standard_normal((5, 16)).astype(np.float32),
               "cache_v_0": r.standard_normal((5, 16)).astype(np.float32)},
        "states": {"enc_out": r.standard_normal((8, 16)).astype(np.float32),
                   "src_lens": np.array([6], np.int64)},
    }


def test_handoff_record_round_trips_bitwise():
    import torch

    rec = _handoff_record()
    payload = prpc._pack_handoff(rec)
    # float32 records: the same bytes as the JAX package's frames
    assert payload == jserving.rpc._pack_handoff(rec)
    for back in (prpc._unpack_handoff(payload),
                 jserving.rpc._unpack_handoff(payload)):
        assert {k: v for k, v in back.items() if k not in ("kv", "states")} \
            == {k: v for k, v in rec.items() if k not in ("kv", "states")}
        for part in ("kv", "states"):
            assert sorted(back[part]) == sorted(rec[part])
            for name, v in rec[part].items():
                got = np.asarray(back[part][name])
                assert got.dtype == v.dtype
                np.testing.assert_array_equal(got, v)
    # a bfloat16 array moves as its int16 bits under "__bf16__<name>"
    bits = torch.randn(5, 16, generator=torch.Generator().manual_seed(3)) \
        .to(torch.bfloat16)
    rec["kv"]["cache_k_0"] = bits
    rec["states"]["enc_out"] = bits[:4]
    back = prpc._unpack_handoff(prpc._pack_handoff(rec))
    for got, want in ((back["kv"]["cache_k_0"], bits),
                      (back["states"]["enc_out"], bits[:4])):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    np.testing.assert_array_equal(back["kv"]["cache_v_0"],
                                  rec["kv"]["cache_v_0"])


@pytest.mark.parametrize("tiers", [("port", "port"), ("port", "jax"),
                                   ("jax", "port")])
def test_prefill_handoff_across_servers(world, tiers):
    """prefill() on a prefill-tier server, then generate(handoff=record) on
    a decode-tier server of either package (different block sizes, so the
    rows are re-blocked): the tokens of the sequential Generator, and the
    decode tier adopts the rows instead of replaying the prompt."""
    feeds = [_mk_feed(80 + i) for i in range(2)]
    refs, jrefs = world.refs(feeds, eos=-1)
    assert refs == jrefs

    def server(kind, block_size):
        kw = dict(max_batch=4, block_size=block_size, num_blocks=64)
        if kind == "port":
            return (serving, _policy()) + _serve(world, **kw)
        return (jserving, _policy(jres)) + jserving.serve(
            world.jspec, world.jscope, **kw)

    pre_mod, pre_pol, pre_srv, pre_sched = server(tiers[0], 4)
    dec_mod, dec_pol, dec_srv, dec_sched = server(tiers[1], 8)
    pcli = pre_mod.ServingClient(pre_srv.endpoint, pre_pol)
    dcli = dec_mod.ServingClient(dec_srv.endpoint, dec_pol)
    try:
        for f, ref in zip(feeds, refs):
            first, status, rec = pcli.prefill(f, MNT, eos_id=-1)
            assert status == "prefilled" and rec is not None
            assert np.asarray(first).tolist() == ref[:1] == rec["tokens"]
            assert rec["cursor"] > 0 and rec["kv"] and rec["states"]
            toks, status = dcli.generate(None, MNT, eos_id=-1, handoff=rec)
            assert status == "done" and np.asarray(toks).tolist() == ref
        assert pre_sched.stats()["handoffs"] == len(feeds)
        assert dec_sched.stats()["adopted"] == len(feeds)
        assert dcli.quiesce(timeout_s=5.0)["used_blocks"] == 0
    finally:
        for c in (pcli, dcli):
            c.close()
        for srv, sched in ((pre_srv, pre_sched), (dec_srv, dec_sched)):
            srv.shutdown()
            sched.close()
