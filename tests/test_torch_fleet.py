"""The port's serving fleet (paddle_tpu_torch/fleet): prefix-affine routing
over N replicas, idempotent resubmit, mid-stream failover, the two-tier
prefill/decode detour and zero-drop rolling deploys, on the CPU.

  * twins of the 11 tests of tests/test_fleet.py, at its tiny size (one
    layer, head_dim 16), every replica a port Scheduler + ServingServer
    on `CPUPlace()` with a PRIVATE scope: cross-replica parity rides the
    port's deterministic startup (a torch generator reseeded from the
    program's seed and a run counter), never shared weights.  The spill
    twin holds replica 0's queue with a Scheduler whose loop is not
    running until the spill is asserted, so nothing can drain the queue
    before the scrape (the JAX test races its holders against a
    0.1 s-delayed scrape);
  * the two-tier fleet twin of tests/test_disagg.py:387 (a prefill
    replica with chunked prefill, two decode replicas, the handoff over
    the wire, then the prefill replica's death and the fallback);
  * across packages: the routing table and the router's affine index are
    the JAX package's; the port's router serves a JAX replica's tokens
    and the JAX router a port replica's (float32, ROADMAP C15);
  * real processes: two `spawn_replica({"place": "cpu"})` replicas answer
    PING, give equal tokens, equal to an in-process Generator's, and a
    `kill -9` of one fails over to the other bitwise.

Every recovered stream is held with equality against the sequential
`Generator.generate()` on the same weights, never allclose.  Every wait
is bounded: clients carry a policy with a call timeout, handles
`result(timeout=)`, and servers are shut down in `finally`.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

from paddle_tpu import decode as jdecode
from paddle_tpu import flags as jflags
from paddle_tpu import fleet as jfleet
from paddle_tpu import serving as jserving
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.serving import rpc as jrpc
from paddle_tpu.sparse import routing as jrouting
import paddle_tpu_torch as pt
from paddle_tpu_torch import decode as pdecode
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import fleet, serving, telemetry as ptelem, testing
from paddle_tpu_torch.fleet import replica as preplica
from paddle_tpu_torch.resilience import ChaosProxy, RpcPolicy
from paddle_tpu_torch.serving import ServingClient, ServingServer
from paddle_tpu_torch.sparse import RoutingTable

CPU = pt.CPUPlace()
S, P, MAXLEN, V = 8, 3, 28, 40
CFG = dict(preplica.DEFAULT_CONFIG, place="cpu")
WAIT = 120   # seconds: the bound on every result() and join()


@pytest.fixture(autouse=True)
def _fresh_state():
    ptelem.disable()
    with testing.fresh_programs():
        yield
    ptelem.disable()


def _policy(**kw):
    kw.setdefault("connect_timeout", 2.0)
    kw.setdefault("call_timeout", 10.0)
    return RpcPolicy(**kw)


def _client(endpoint, **kw):
    return ServingClient(endpoint, policy=_policy(**kw))


_SPEC = None
_GEN = None


def _spec():
    """One spec module-wide, made by the replica process's own
    `build_spec_scope` (the same bucket plan and var names everywhere)."""
    global _SPEC
    if _SPEC is None:
        _SPEC, _ = preplica.build_spec_scope(CFG)
    return _SPEC


def _refs(feeds, mnt):
    """The sequential Generator's tokens, on a private scope."""
    global _GEN
    if _GEN is None:
        _GEN = pdecode.Generator(_spec(), scope=pt.Scope(), place=CPU)
    return [_GEN.generate(f, mnt, eos_id=1)[0].tolist() for f in feeds]


def _mk_feed(seed):
    r = np.random.default_rng(seed)
    return {
        "src_ids": r.integers(2, V, size=(1, S)).astype(np.int64),
        "src_lens": np.array([int(r.integers(S // 2, S + 1))], np.int64),
        "trg_ids": r.integers(2, V, size=(1, P)).astype(np.int64),
        "prefix_lens": np.array([int(r.integers(1, P + 1))], np.int64),
    }


def _scheduler(max_batch=4, num_blocks=64, **kw):
    return serving.Scheduler(_spec(), scope=pt.Scope(), place=CPU,
                             max_batch=max_batch, block_size=4,
                             num_blocks=num_blocks, **kw)


def _mk_replica(version="v1", max_batch=4, num_blocks=64, start=True):
    sched = _scheduler(max_batch, num_blocks)
    if start:
        sched.start()
    srv = ServingServer(sched, host="127.0.0.1", port=0,
                        version=version).start()
    return srv, sched


def _close(*pairs):
    for srv, sched in pairs:
        try:
            srv.shutdown()
        except Exception:
            pass
        sched.close()


def _feed_affine_to(router, index, lo=3000):
    """A feed whose prefix key lands on `index` under the CURRENT table
    (deterministic scan over seeds)."""
    for seed in range(lo, lo + 512):
        feed = _mk_feed(seed)
        if router.affine_index(feed, 1, None) == index:
            return feed
    raise AssertionError(f"no seed in range maps to replica {index}")


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------------------
# routing math — no sockets, no programs run
# ---------------------------------------------------------------------------


def test_prompt_key_stable_and_input_sensitive():
    f = _mk_feed(7)
    k = serving.prompt_key(f, 1, None)
    # dict order must not matter (the router unpacks the wire, the
    # scheduler gets the caller's dict)
    assert serving.prompt_key(dict(reversed(list(f.items()))), 1, None) == k
    assert serving.prompt_key({n: v.copy() for n, v in f.items()},
                              1, None) == k
    g = {n: v.copy() for n, v in f.items()}
    g["src_ids"][0, 0] += 1
    assert serving.prompt_key(g, 1, None) != k
    assert serving.prompt_key(f, 2, None) != k
    assert serving.prompt_key(
        {n: v.astype(np.int32) for n, v in f.items()}, 1, None) != k


def test_redistributed_deals_dead_slots_to_survivors():
    t = RoutingTable.modulo(4)
    t2 = t.redistributed(2)
    assert t2.epoch == t.epoch + 1
    assert 2 not in set(int(s) for s in t2.slots)
    # survivors keep every slot they already owned
    for slot, owner in enumerate(t.slots):
        if int(owner) != 2:
            assert int(t2.slots[slot]) == int(owner)
    # the dead owner's slots deal (near-)evenly
    per = {s: 0 for s in (0, 1, 3)}
    for slot, owner in enumerate(t.slots):
        if int(owner) == 2:
            per[int(t2.slots[slot])] += 1
    assert max(per.values()) - min(per.values()) <= 1
    with pytest.raises(ValueError):
        RoutingTable.modulo(1).redistributed(0)


def test_pick_affine_spill_reroute_and_exhaustion():
    r = fleet.FleetRouter(["h0:1", "h1:2", "h2:3"], spill_threshold=2)
    feed = _mk_feed(11)
    aff = r.affine_index(feed, 1, None)
    assert r.pick(feed, 1, None) == (aff, "affine")
    # a deep queue on the affine replica spills to the least-loaded
    r.replicas[aff].queue_depth = 5.0
    idx, verdict = r.pick(feed, 1, None)
    assert verdict == "spilled" and idx != aff
    r.replicas[aff].queue_depth = 0.0
    # ejection reroutes (epoch bump, slots redistributed)
    e0 = r.table.epoch
    assert r.eject(aff, reason="test")
    assert not r.eject(aff, reason="test")  # idempotent
    assert r.table.epoch == e0 + 1
    # the rebuilt table re-points the key at a survivor (still "affine":
    # the table IS the affinity); "rerouted" is the relay-retry path
    # where the new owner is excluded too
    idx, verdict = r.pick(feed, 1, None)
    assert verdict == "affine" and idx != aff
    assert aff not in set(int(s) for s in r.table.slots)
    idx2, verdict2 = r.pick(feed, 1, None, exclude=(idx,))
    assert verdict2 == "rerouted" and idx2 not in (aff, idx)
    # readmit restores canonical ownership
    r.readmit(aff)
    assert r.pick(feed, 1, None) == (aff, "affine")
    for i in range(3):
        r.eject(i, reason="test")
    with pytest.raises(fleet.NoReplicaAvailable):
        r.pick(feed, 1, None)


def test_affinity_spreads_prompts_across_replicas():
    r = fleet.FleetRouter(["h0:1", "h1:2", "h2:3"])
    owners = {r.affine_index(_mk_feed(s), 1, None) for s in range(40)}
    assert owners == {0, 1, 2}


# ---------------------------------------------------------------------------
# the same routing in both packages
# ---------------------------------------------------------------------------


def test_routing_table_equals_the_jax_packages():
    ids = np.random.default_rng(0).integers(0, 1 << 40, size=4096)
    for n in (1, 2, 3, 4, 5, 8):
        mine, theirs = RoutingTable.modulo(n), jrouting.RoutingTable.modulo(n)
        np.testing.assert_array_equal(mine.slot_of(ids), theirs.slot_of(ids))
        np.testing.assert_array_equal(mine.owner_of(ids),
                                      theirs.owner_of(ids))
        assert mine.to_json() == theirs.to_json()
        if n > 1:
            for dead in range(n):
                assert (mine.redistributed(dead).to_json()
                        == theirs.redistributed(dead).to_json())
    # moves, resizes and plans, and a table read back from the other's JSON
    mine = RoutingTable.modulo(3, endpoints=["a", "b", "c"])
    theirs = jrouting.RoutingTable.modulo(3, endpoints=["a", "b", "c"])
    assert mine.moved([1, 5, 9], 0, num_shards=4).to_json() \
        == theirs.moved([1, 5, 9], 0, num_shards=4).to_json()
    assert mine.resized(5).to_json() == theirs.resized(5).to_json()
    assert mine.plan_moves(4) == theirs.plan_moves(4)
    assert mine.rebalanced(2).to_json() == theirs.rebalanced(2).to_json()
    assert RoutingTable.from_json(theirs.to_json()).same_placement(mine)


def test_affine_index_equals_the_jax_packages():
    # the key hashes the plan identity, so the two packages' trace-affecting
    # flags must be the same set at the same values (ROADMAP C16)
    assert pflags.trace_signature() == jflags.trace_signature()
    eps = ["h0:1", "h1:2", "h2:3"]
    mine, theirs = fleet.FleetRouter(eps), jfleet.FleetRouter(eps)
    rng = np.random.default_rng(64)
    for _ in range(64):
        feed = _mk_feed(int(rng.integers(1 << 30)))
        assert serving.prompt_key(feed, 1, None) \
            == jserving.prompt_key(feed, 1, None)
        assert mine.affine_index(feed, 1, None) \
            == theirs.affine_index(feed, 1, None)
    # after an ejection the survivors' tables agree too
    mine.eject(1, reason="test")
    theirs.eject(1, reason="test")
    assert mine.table.to_json() == theirs.table.to_json()


def test_port_router_serves_a_jax_replicas_tokens():
    with junique.guard():
        jspec = JT.build_decode(_jax_cfg(), src_len=S, prefix_len=P,
                                max_len=MAXLEN)
    jsched = jserving.Scheduler(jspec, scope=JScope(), max_batch=4,
                                block_size=4, num_blocks=64).start()
    jsrv = jrpc.ServingServer(jsched, host="127.0.0.1", port=0)
    jsrv.start()
    router = fleet.FleetRouter([jsrv.endpoint]).start()
    cli = _client(router.endpoint)
    try:
        feeds = [_mk_feed(60 + i) for i in range(3)]
        jgen = jdecode.Generator(jspec, scope=JScope())
        want = [np.asarray(jgen.generate(f, max_new_tokens=8, eos_id=1))[0]
                .tolist() for f in feeds]
        for f, ref in zip(feeds, want):
            toks, status = cli.generate(f, 8, eos_id=1)
            assert status == "done" and toks.tolist() == ref
        assert router.counters["routed"] == 3
    finally:
        cli.close()
        router.shutdown()
        jsrv.shutdown()
        jsched.close()


def test_jax_router_serves_a_port_replicas_tokens():
    srv, sched = _mk_replica()
    router = jfleet.FleetRouter([srv.endpoint]).start()
    cli = jserving.ServingClient(router.endpoint)
    try:
        feeds = [_mk_feed(70 + i) for i in range(3)]
        for f, ref in zip(feeds, _refs(feeds, 8)):
            toks, status = cli.generate(f, 8, eos_id=1)
            assert status == "done" and np.asarray(toks).tolist() == ref
        assert router.counters["routed"] == 3
        assert sched.counters["completed"] == 3
    finally:
        cli.close()
        router.shutdown()
        _close((srv, sched))


def _jax_cfg():
    cfg = JT.tiny(vocab=V, max_length=16)
    cfg.n_layer = 1
    return cfg


# ---------------------------------------------------------------------------
# scheduler-level: idempotent resubmit + export/import replay
# ---------------------------------------------------------------------------


def test_duplicate_request_id_attaches_live_and_terminal():
    sched = _scheduler().start()
    try:
        feed = _mk_feed(21)
        (ref,) = _refs([feed], 10)
        r1 = sched.submit(feed, 10, eos_id=1, request_id="rid-1")
        r_live = sched.submit(feed, 10, eos_id=1, request_id="rid-1")
        assert r_live is r1   # duplicate while live: same generation
        assert list(r1.result(timeout=WAIT)) == ref
        # duplicate after terminal: the retained record answers
        r_done = sched.submit(feed, 10, eos_id=1, request_id="rid-1")
        assert r_done is r1
        assert sched.counters["dedup_hits"] == 2
        # a CANCELLED prior replays bitwise from its recorded tokens
        got_two = threading.Event()
        seen = []

        def on_tok(t):
            seen.append(int(t))
            if len(seen) >= 2:
                got_two.set()

        r2 = sched.submit(_mk_feed(22), 12, eos_id=1, on_token=on_tok,
                          request_id="rid-2")
        assert got_two.wait(timeout=WAIT)
        r2.cancel()
        r2.result(timeout=WAIT)
        assert r2.status == "cancelled" and len(r2.tokens) >= 2
        r3 = sched.submit(_mk_feed(22), 12, eos_id=1, request_id="rid-2")
        assert r3 is not r2
        (ref2,) = _refs([_mk_feed(22)], 12)
        assert list(r3.result(timeout=WAIT)) == ref2
    finally:
        sched.close()


def test_export_import_moves_inflight_bitwise():
    """Drain + export on scheduler A, import on B (private scope): the
    moved generations finish on B bitwise — the primitive both failover
    and force-drain deploys ride."""
    a, b = _scheduler().start(), _scheduler().start()
    try:
        feeds = [_mk_feed(31 + i) for i in range(3)]
        refs = _refs(feeds, 14)
        got = threading.Event()
        n_tok = [0]

        def on_tok(_t):
            n_tok[0] += 1
            if n_tok[0] >= 4:
                got.set()

        reqs = [a.submit(f, 14, eos_id=1, on_token=on_tok,
                         request_id=f"mv-{i}") for i, f in enumerate(feeds)]
        assert got.wait(timeout=WAIT)
        a.drain()
        with pytest.raises(serving.SchedulerDraining):
            a.submit(feeds[0], 4, eos_id=1)
        recs = a.export_requests(cancel=True)
        assert {r["request_id"] for r in recs} <= {"mv-0", "mv-1", "mv-2"}
        assert a.counters["exported"] == len(recs)
        by_rid = {r.request_id: r for r in b.import_requests(recs)}
        for i, (req, ref) in enumerate(zip(reqs, refs)):
            req.result(timeout=WAIT)
            if req.status == "done":   # finished before the export
                toks = req.tokens
            else:
                assert req.status == "cancelled"
                toks = by_rid[f"mv-{i}"].result(timeout=WAIT)
            assert list(toks) == ref, f"moved request {i} diverged"
        assert b.counters["imported"] == len(recs)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# fleet end-to-end (in-process replicas behind the wire router)
# ---------------------------------------------------------------------------


def _run_workload(endpoint, refs):
    cli = _client(endpoint)
    try:
        for _ in range(4):
            for g in range(4):   # 4 prompt groups x 4 rounds
                toks, status = cli.generate(_mk_feed(500 + g), 8, eos_id=1)
                assert status == "done" and toks.tolist() == refs[g]
    finally:
        cli.close()


def _hit_rate(pool_stats):
    seen = pool_stats["prefix_hits"] + pool_stats["prefix_misses"]
    return pool_stats["prefix_hits"] / max(1, seen), seen


def test_prefix_affinity_preserves_hit_rate_across_replicas():
    """Shared-prompt traffic through a 3-replica fleet: affinity pins
    each prompt group to one replica, so the POOLED prefix hit rate
    matches the single-replica run (and every replica that served stays
    within 10% of it)."""
    refs = _refs([_mk_feed(500 + g) for g in range(4)], 8)
    single = _mk_replica()
    try:
        _run_workload(single[0].endpoint, refs)
        single_rate, _ = _hit_rate(single[1].stats()["pool"])
    finally:
        _close(single)
    assert single_rate >= 0.5   # the workload really shares prompts

    replicas = [_mk_replica() for _ in range(3)]
    router = fleet.FleetRouter([s.endpoint for s, _ in replicas]).start()
    try:
        _run_workload(router.endpoint, refs)
        hits = misses = 0
        for _, sched in replicas:
            p = sched.stats()["pool"]
            hits += p["prefix_hits"]
            misses += p["prefix_misses"]
            rate, seen = _hit_rate(p)
            if seen:
                assert rate >= 0.9 * single_rate, (rate, single_rate, p)
        pooled = hits / max(1, hits + misses)
        assert pooled >= 0.9 * single_rate, (pooled, single_rate)
        assert router.counters["spilled"] == 0   # a pure affinity run
    finally:
        router.shutdown()
        _close(*replicas)


def test_queue_imbalance_spills_away_from_stalled_replica():
    """Replica 0 stalled behind a ChaosProxy (every chunk delayed) with
    three requests in its queue: after a scrape, an affine-to-0 request
    diverts to the idle replica instead of queueing behind it.  Replica
    0's loop starts only after the spill is asserted, so its queue cannot
    drain before the scrape, however slow the scrape is."""
    r0, sched0 = _mk_replica(max_batch=2, start=False)
    r1, sched1 = _mk_replica()
    chaos = ChaosProxy(r0.endpoint, delay_rate=1.0, delay_s=0.1).start()
    router = fleet.FleetRouter([chaos.endpoint, r1.endpoint],
                               spill_threshold=1).start()
    try:
        feed = _feed_affine_to(router, 0)
        (ref,) = _refs([feed], 8)
        holders = [sched0.submit(_mk_feed(700 + i), MAXLEN - P - 1,
                                 eos_id=-1) for i in range(3)]
        router.scrape_all()
        assert router.replicas[0].queue_depth == 3
        cli = _client(router.endpoint)
        try:
            toks, status = cli.generate(feed, 8, eos_id=1)
        finally:
            cli.close()
        assert status == "done" and toks.tolist() == ref
        assert router.counters["spilled"] >= 1
        assert sched1.counters["submitted"] == 1   # it went to r1
        assert sched0.counters["admitted"] == 0
        for h in holders:
            h.cancel()
        sched0.start()
        for h in holders:
            h.result(timeout=WAIT)
            assert h.status == "cancelled"
    finally:
        router.shutdown()
        chaos.stop()
        _close((r0, sched0), (r1, sched1))


def test_client_resubmit_after_dropped_stream_is_bitwise():
    """A transport fault mid-stream (the ChaosProxy hard-closes the
    connection): the client resubmits with the SAME request id, the
    server dedupes or replays, and the delivered tokens are bitwise the
    uninterrupted generation with no duplicates."""
    srv, sched = _mk_replica()
    chaos = ChaosProxy(srv.endpoint).start()
    # a tight call timeout: the dropped stream is detected by the read
    # deadline, so the default 30 s would be dead time
    cli = _client(chaos.endpoint, call_timeout=3.0, backoff_base=0.02,
                  seed=0)
    try:
        feed = _mk_feed(41)
        (ref,) = _refs([feed], 12)
        seen = []

        def on_tok(t):
            seen.append(int(t))
            if len(seen) == 2:   # cut the stream mid-generation
                chaos.drop_next(1)

        toks, status = cli.generate(feed, 12, eos_id=1, on_token=on_tok)
        assert status == "done" and toks.tolist() == ref
        assert seen == ref   # on_token fired exactly once a token
        assert chaos.counters["dropped_conns"] >= 1
        # the resubmit either attached to the live prior (dedupe) or
        # replayed a cancelled one (a fresh submit) — one MUST have hit
        assert sched.counters["dedup_hits"] >= 1 \
            or sched.counters["submitted"] >= 2
    finally:
        cli.close()
        chaos.stop()
        _close((srv, sched))


def test_failover_killed_replica_midstream_resumes_bitwise():
    """A replica dies mid-stream (connections reset, then blackholed):
    the router ejects it, resubmits with the recorded tokens on the
    survivor, and the client sees ONE uninterrupted bitwise stream.
    Afterwards the survivor quiesces (no leaked blocks)."""
    r0, sched0 = _mk_replica()
    r1, sched1 = _mk_replica()
    chaos = ChaosProxy(r0.endpoint).start()
    router = fleet.FleetRouter(
        [chaos.endpoint, r1.endpoint],
        policy=_policy(call_timeout=3.0, backoff_base=0.02, seed=0)).start()
    cli = _client(router.endpoint)
    try:
        feed = _feed_affine_to(router, 0, lo=4000)
        (ref,) = _refs([feed], 14)
        seen = []

        def on_tok(t):
            seen.append(int(t))
            if len(seen) == 3:   # kill the replica mid-stream
                chaos.set_fault(blackhole=True)
                chaos.kill_connections()

        toks, status = cli.generate(feed, 14, eos_id=1, on_token=on_tok)
        assert status == "done" and toks.tolist() == ref
        assert seen == ref
        assert router.replicas[0].state == "down"
        assert router.counters["ejections"] >= 1
        assert router.counters["resubmitted"] >= 1
        assert sched1.counters["imported"] >= 1   # the recorded-token path
        assert _wait(sched1.idle)
        sched1.pool.assert_quiesced()
    finally:
        cli.close()
        router.shutdown()
        chaos.stop()
        _close((r0, sched0), (r1, sched1))


def test_rolling_deploy_zero_drop_under_load():
    """A rolling v1 -> v2 deploy while clients stream: every request
    completes bitwise (drained or force-moved, never dropped), and both
    replicas come back as v2 behind a bumped epoch."""
    live = [list(_mk_replica("v1")) for _ in range(2)]
    router = fleet.FleetRouter([s.endpoint for s, _ in live]).start()
    n_cli, per, mnt = 3, 3, 12
    feeds = [[_mk_feed(900 + 10 * c + i) for i in range(per)]
             for c in range(n_cli)]
    refs = {(c, i): r for c in range(n_cli)
            for i, r in enumerate(_refs(feeds[c], mnt))}
    results, errors = {}, []

    def client(c):
        cli = _client(router.endpoint)
        try:
            for i in range(per):
                results[(c, i)] = cli.generate(feeds[c][i], mnt, eos_id=1)
        except Exception as e:   # surfaced after join
            errors.append((c, repr(e)))
        finally:
            cli.close()

    def swap(index, old_ep):
        srv, sched = live[index]
        srv.shutdown()
        sched.close()
        live[index][:] = _mk_replica("v2")
        return live[index][0].endpoint

    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_cli)]
        for t in threads:
            t.start()
        e0 = router.table.epoch
        rec = fleet.RollingDeploy(router, swap, drain_grace_s=0.5,
                                  expect_version="v2").run()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive(), "client stuck through deploy"
        assert not errors, errors
        assert len(results) == n_cli * per   # ZERO dropped
        for (c, i), (toks, status) in results.items():
            assert status == "done", (c, i, status)
            assert toks.tolist() == refs[(c, i)], \
                f"client {c} request {i} diverged in deploy"
        assert [r["new_version"] for r in rec["replicas"]] == ["v2", "v2"]
        assert all(r.version == "v2" for r in router.replicas)
        assert all(r.state == "up" for r in router.replicas)
        # ANNOUNCE + readmit per replica: >= 4 epoch bumps
        assert router.table.epoch >= e0 + 4
        assert rec["max_mttr_ms"] > 0
        assert {"cutover_ms", "forced_moves"} <= set(rec["replicas"][0])
    finally:
        router.shutdown()
        _close(*[tuple(x) for x in live])


# ---------------------------------------------------------------------------
# the two-tier fleet (tests/test_disagg.py:387)
# ---------------------------------------------------------------------------

P2, CHUNK = 7, 3


def _mk_feed2(seed):
    r = np.random.default_rng(seed)
    return {
        "src_ids": r.integers(2, V, size=(1, S)).astype(np.int64),
        "src_lens": np.array([int(r.integers(S // 2, S + 1))], np.int64),
        "trg_ids": r.integers(2, V, size=(1, P2)).astype(np.int64),
        "prefix_lens": np.array([int(r.integers(1, P2 + 1))], np.int64),
    }


def test_two_tier_fleet_handoff_and_prefill_death_fallback():
    """A FleetRouter with a prefill tier: long prompts detour through the
    prefill replica (chunked), hand off KV over the wire and decode
    prefix-affine — bitwise the sequential Generator.  Killing the
    prefill replica degrades to single-tier (the fallback counter),
    still bitwise, zero drops."""
    spec, _ = preplica.build_spec_scope(dict(CFG, prefix_len=P2,
                                             chunk_len=CHUNK))
    feeds = [_mk_feed2(800 + i) for i in range(5)]
    gen = pdecode.Generator(spec, scope=pt.Scope(), place=CPU)
    refs = [gen.generate(f, 8, eos_id=1)[0].tolist() for f in feeds]

    def server(**kw):
        sc = serving.Scheduler(spec, scope=pt.Scope(), place=CPU,
                               max_batch=4, num_blocks=96, paged_kv=True,
                               **kw).start()
        return ServingServer(sc, host="127.0.0.1", port=0).start(), sc

    pre = server(block_size=4, prefill_chunk=CHUNK)
    dec = [server(block_size=8) for _ in range(2)]
    # the prefill replica's death is a process's: its live connections
    # reset and new ones refused (a shut-down in-process server would keep
    # serving the router's open connection from a closed Scheduler)
    chaos = ChaosProxy(pre[0].endpoint).start()
    router = rcli = None
    try:
        # direct RPC: prefill() -> handoff record -> generate(handoff=)
        pcli, dcli = _client(pre[0].endpoint), _client(dec[0][0].endpoint)
        toks0, st0, rec0 = pcli.prefill(feeds[0], 8, eos_id=1)
        assert st0 in ("prefilled", "done")
        if st0 == "prefilled":
            toks, st = dcli.generate(None, 8, eos_id=1, handoff=rec0)
            assert st == "done" and toks.tolist() == refs[0]
        pcli.close()
        dcli.close()

        router = fleet.FleetRouter([srv.endpoint for srv, _ in dec],
                                   prefill_endpoints=[chaos.endpoint],
                                   prefill_min_tokens=5).start()
        rcli = _client(router.endpoint)
        for i, f in enumerate(feeds):
            toks, st = rcli.generate(f, 8, eos_id=1)
            assert st == "done" and toks.tolist() == refs[i], i
        fv = router.fleet_view()
        assert fv["counters"]["prefill_routed"] >= 1
        assert fv["counters"]["handoffs"] >= 1
        assert pre[1].counters["chunked"] >= 1   # the prompts chunked

        # the prefill tier dies: single-tier fallback, still bitwise
        chaos.set_fault(refuse=True)
        chaos.kill_connections()
        _close(pre)
        for i, f in enumerate(feeds[:2]):
            toks, st = rcli.generate(f, 8, eos_id=1)
            assert st == "done" and toks.tolist() == refs[i], i
        fv = router.fleet_view()
        assert fv["prefill_replicas"][0]["state"] == "down"
        assert fv["counters"]["prefill_fallbacks"] >= 1
    finally:
        if rcli is not None:
            rcli.close()
        if router is not None:
            router.shutdown()
        chaos.stop()
        _close(pre, *dec)


# ---------------------------------------------------------------------------
# replica processes
# ---------------------------------------------------------------------------


def test_replica_processes_agree_and_fail_over_after_kill9():
    """Two `python -m paddle_tpu_torch.fleet.replica` processes on the
    CPU: both READY lines arrive and PING answers; each gives the same
    tokens for 3 feeds, equal to an in-process Generator's (the weights
    agree across processes without a checkpoint); after `kill -9` of the
    replica serving a stream, the router finishes it on the other,
    bitwise."""
    spawned, errors = [None, None], []

    def launch(i):
        try:
            spawned[i] = preplica.spawn_replica(
                {"place": "cpu", "version": f"p{i}"}, timeout_s=WAIT)
        except Exception as e:   # surfaced after join
            errors.append(repr(e))

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT + 10)
    procs = [s[0] for s in spawned if s is not None]
    router = cli = None
    try:
        assert not errors, errors
        eps = [ep for _, ep in spawned]
        for i, (proc, ep) in enumerate(spawned):
            pong = fleet.probe(ep, timeout=5.0)
            assert pong["ok"] and pong["pid"] == proc.pid
            assert pong["version"] == f"p{i}"
            assert os.path.exists(proc.log_path)
        feeds = [_mk_feed(1200 + i) for i in range(3)]
        refs = _refs(feeds, 10)
        for ep in eps:
            c = _client(ep)
            try:
                for f, ref in zip(feeds, refs):
                    toks, st = c.generate(f, 10, eos_id=1)
                    assert st == "done" and toks.tolist() == ref
            finally:
                c.close()

        router = fleet.FleetRouter(
            eps, policy=_policy(call_timeout=5.0)).start()
        cli = _client(router.endpoint)
        feed = _feed_affine_to(router, 0, lo=5000)
        (ref,) = _refs([feed], 14)
        seen = []

        def on_tok(t):
            seen.append(int(t))
            if len(seen) == 2:
                os.kill(spawned[0][0].pid, signal.SIGKILL)

        toks, st = cli.generate(feed, 14, eos_id=1, on_token=on_tok)
        assert st == "done" and toks.tolist() == ref and seen == ref
        assert spawned[0][0].wait(timeout=10) == -signal.SIGKILL
        assert router.replicas[0].state == "down"
        assert router.counters["resubmitted"] >= 1
    finally:
        if cli is not None:
            cli.close()
        if router is not None:
            router.shutdown()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)


def test_spawn_replica_reports_a_death_before_ready():
    """A replica that dies before READY raises with its stderr's path
    and last lines (here: an unknown model key)."""
    with pytest.raises(RuntimeError) as ei:
        preplica.spawn_replica({"place": "cpu", "model": "huge"},
                               timeout_s=WAIT)
    msg = str(ei.value)
    assert "before READY" in msg and "replica model 'huge'" in msg
    path = msg.split("stderr in ", 1)[1].split(")", 1)[0]
    assert os.path.exists(path)
