"""The port's telemetry (paddle_tpu_torch/telemetry) against the JAX
package's (paddle_tpu/telemetry), on the same calls.

  * registry: one sequence of counter, gauge and histogram calls through
    both registries gives equal snapshots (timestamps and pids aside),
    with equal percentiles; an 8-thread hammer keeps exact totals; the
    disabled mode records nothing;
  * spans: nesting, error status, a span ended on another thread,
    `attach` and `wire_context`, the same records in both packages (ids
    and times aside); the ring's bound and drain;
  * export: the port's chrome trace of a set of span records and host
    spans equals the JAX package's, and a span JSONL file written by one
    package reads back equal in the other;
  * a served run: the head_dim-64 config of tests/test_torch_serving.py
    (weights carried from the JAX startup with convert.load_params),
    the same traffic through the JAX Scheduler and the port's, stepped
    in the same order: the registries hold the same serving/kv/rpc metric
    names, equal counter and gauge values and equal histogram counts.

Both registries are process-wide: every test starts and ends with both
dark and empty.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu import decode as jdecode
from paddle_tpu import flags as jflags
from paddle_tpu import serving as jserving
from paddle_tpu import telemetry as jtelem
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.telemetry import tracing as jtracing
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, flags as pflags
from paddle_tpu_torch import serving, telemetry as ptelem, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.telemetry import tracing as ptracing

PACKAGES = (jtelem, ptelem)
NAMESPACES = ("serving.", "kv.", "rpc.", "channel.")


def _dark():
    for t in PACKAGES:
        t.disable()
        t.reset_metrics()
        t.reset_spans()


@pytest.fixture(autouse=True)
def _fresh_state():
    _dark()
    with testing.fresh_programs():
        yield
    _dark()


def _plain(snap):
    """A snapshot without its time and process fields."""
    return {k: v for k, v in snap.items() if k not in ("ts", "pid")}


def _drive_registry(t):
    """One fixed sequence of instrument calls through package `t`."""
    t.enable()
    c = t.counter("t.port.count")
    c.inc()
    c.inc(4)
    g = t.gauge("t.port.gauge")
    g.set(2.5)
    g.add(-1.0)
    h = t.histogram("t.port.hist")
    rng = np.random.RandomState(7)
    for v in np.concatenate([rng.lognormal(1.0, 2.0, 500), [1e-4, 3e5, 0.0]]):
        h.observe(float(v))
    fill = t.histogram("t.port.fill", bounds=tuple(i / 16
                                                   for i in range(1, 17)))
    for n in (1, 3, 5, 8, 8, 2):
        fill.observe(n / 8)
    return h, fill


def test_registry_snapshots_and_percentiles_equal_jax():
    jh, jfill = _drive_registry(jtelem)
    ph, pfill = _drive_registry(ptelem)
    jsnap, psnap = _plain(jtelem.snapshot()), _plain(ptelem.snapshot())
    mine = ("t.port.count", "t.port.gauge", "t.port.hist", "t.port.fill")
    for kind in ("counters", "gauges", "histograms"):
        j = {n: v for n, v in jsnap[kind].items() if n in mine}
        p = {n: v for n, v in psnap[kind].items() if n in mine}
        assert j and j == p, kind
    assert ph.bounds == jh.bounds
    for p in (0, 1, 10, 25, 50, 75, 90, 99, 99.9, 100):
        assert ph.percentile(p) == jh.percentile(p), p
        assert pfill.percentile(p) == jfill.percentile(p), p
    for v in (0.0, 1e-3, 0.5, 1.0, 1.3, 99.9, 1e5, 2e5):
        assert ph._bucket_of(v) == jh._bucket_of(v)


def test_snapshot_files_equal_jax(tmp_path):
    for t in PACKAGES:
        _drive_registry(t)
    lines = {}
    for name, t in (("jax", jtelem), ("port", ptelem)):
        snap = _plain(t.snapshot())
        snap["counters"] = {n: v for n, v in snap["counters"].items()
                            if n.startswith("t.port.")}
        snap["gauges"] = {n: v for n, v in snap["gauges"].items()
                          if n.startswith("t.port.")}
        snap["histograms"] = {n: v for n, v in snap["histograms"].items()
                              if n.startswith("t.port.")}
        t.write_snapshot(str(tmp_path / f"{name}.json"), snap)
        t.write_snapshot_jsonl(str(tmp_path / f"{name}.jsonl"), snap,
                               bench="unit")
        lines[name] = (tmp_path / f"{name}.jsonl").read_text()
    assert (tmp_path / "jax.json").read_text() == \
        (tmp_path / "port.json").read_text()
    assert lines["jax"] == lines["port"] and lines["port"].count("\n") == 4


def test_eight_thread_hammer_totals_exact():
    ptelem.enable()
    c = ptelem.counter("t.hammer.count")
    g = ptelem.gauge("t.hammer.gauge")
    h = ptelem.histogram("t.hammer.hist")
    n_threads, per_thread = 8, 2000

    def worker(tid):
        for _ in range(per_thread):
            c.inc()
            g.add(1.0)
            h.observe(float(tid + 1))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * per_thread
    assert c.value == total and g.value == float(total)
    s = h.summary()
    assert s["count"] == total
    assert s["sum"] == per_thread * sum(range(1, n_threads + 1))


def test_disabled_mode_is_inert():
    c = ptelem.counter("t.dark.count")
    g = ptelem.gauge("t.dark.gauge")
    h = ptelem.histogram("t.dark.hist")
    c.inc()
    g.set(5)
    h.observe(1.0)
    assert c.value == 0 and g.value == 0.0 and h.count == 0
    assert ptelem.span("x") is ptelem.span("y")
    assert ptelem.start_span("z") is ptelem.span("x")
    assert ptracing.wire_context() == ptracing.NO_TRACE
    with ptracing.attach(0x1234, 0x99):
        assert ptracing.current_context() is None
    assert ptelem.spans() == []
    snap = ptelem.snapshot()
    assert snap["enabled"] is False and snap["counters"]["t.dark.count"] == 0


def _drive_spans(t, tr):
    """Nesting, an error, a span ended on another thread, an attached
    remote context and wire_context, through package (t, tr)."""
    t.enable()
    wires = [tr.wire_context()]
    with t.span("parent", k=1):
        wires.append(tr.wire_context())
        with t.span("child"):
            pass
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            raise RuntimeError("injected")
    s = t.start_span("lifecycle", rid=3)
    assert tr.current_context() is None
    th = threading.Thread(target=lambda: s.end(tokens=3))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    with tr.attach(0x1234, 0x99):
        wires.append(tr.wire_context())
        with t.span("server.op"):
            pass
    wires.append(tr.wire_context())
    return wires


def _shape(recs):
    """Span records as (name, parent's name or the raw remote id, status,
    attrs), in order; the trace each belongs to, by first appearance."""
    by_id = {r["span"]: r["name"] for r in recs}
    traces = {}
    out = []
    for r in recs:
        parent = r["parent"]
        out.append((r["name"], by_id.get(parent, parent), r["status"],
                    r.get("attrs"), traces.setdefault(r["trace"],
                                                      len(traces))))
    return out


def test_spans_match_jax():
    jw = _drive_spans(jtelem, jtracing)
    pw = _drive_spans(ptelem, ptracing)
    jrecs, precs = jtelem.spans(), ptelem.spans()
    assert _shape(precs) == _shape(jrecs)
    assert [(w == (0, 0)) for w in pw] == [(w == (0, 0)) for w in jw]
    assert pw[2] == jw[2] == (0x1234, 0x99)
    by = {r["name"]: r for r in precs}
    assert by["child"]["parent"] == by["parent"]["span"]
    assert by["parent"]["parent"] is None
    assert by["boom"]["status"] == "error"
    assert "injected" in by["boom"]["attrs"]["error"]
    assert by["lifecycle"]["attrs"] == {"rid": 3, "tokens": 3}
    assert by["server.op"]["trace"] == 0x1234
    assert by["server.op"]["parent"] == 0x99
    assert pw[1] == (by["parent"]["trace"], by["parent"]["span"])
    assert set(precs[0]) == set(jrecs[0])


def test_span_ring_is_bounded_and_drains(monkeypatch):
    ptelem.enable()
    monkeypatch.setattr(ptracing, "_SPANS", collections.deque(maxlen=5))
    for i in range(12):
        with ptelem.span(f"s{i}"):
            pass
    assert [r["name"] for r in ptelem.spans()] == [f"s{i}"
                                                   for i in range(7, 12)]
    drained = ptracing.take_spans()
    assert len(drained) == 5 and ptelem.spans() == []
    assert ptracing._default_max_spans() == pflags.get(
        "telemetry_max_spans") == jflags.get("telemetry_max_spans")


def test_chrome_trace_and_jsonl_round_trip_match_jax(tmp_path):
    _drive_spans(ptelem, ptracing)
    recs = ptelem.spans()
    host = [("matmul", time.perf_counter() - 0.010, 0.004, 1),
            ("add", time.perf_counter() - 0.005, 0.001, 2)]
    kw = dict(host_spans=host, clock_offset=1.7e9, pid=42)
    doc = ptelem.chrome_trace(recs, **kw)
    assert doc == jtelem.chrome_trace(recs, **kw)
    assert {e["cat"] for e in doc["traceEvents"]} == {"span", "op"}
    n = ptelem.write_chrome_trace(str(tmp_path / "trace.json"), recs, **kw)
    assert n == len(recs) + 2
    assert json.loads((tmp_path / "trace.json").read_text()) == doc

    ptelem.write_spans_jsonl(str(tmp_path / "p.jsonl"))
    assert jtelem.read_spans_jsonl(str(tmp_path / "p.jsonl")) == recs
    assert ptelem.read_spans_jsonl(str(tmp_path / "p.jsonl")) == recs
    jtelem.write_spans_jsonl(str(tmp_path / "j.jsonl"), recs)
    assert (tmp_path / "j.jsonl").read_text() == \
        (tmp_path / "p.jsonl").read_text()


# ---------------------------------------------------------------------------
# a served run through both Schedulers
# ---------------------------------------------------------------------------

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
S, WINDOW, MAX_LEN, MNT, EOS = 128, 128, 256, 8, 1
GATE = (("flash_attention", "interpret"), ("attn_decode_min_keys", 200))


def _feeds(n, seed):
    rng = np.random.RandomState(seed)
    return [{
        "src_ids": rng.randint(2, 64, size=(1, S)).astype(np.int64),
        "src_lens": np.asarray([rng.randint(S // 2, S + 1)], np.int64),
        "trg_ids": rng.randint(2, 64, size=(1, WINDOW)).astype(np.int64),
        "prefix_lens": np.asarray([rng.randint(WINDOW - 40, WINDOW + 1)],
                                  np.int64),
    } for _ in range(n)]


@pytest.fixture(scope="module")
def world():
    """The JAX spec and scope (startup weights x3, as in
    tests/test_torch_serving.py) and the port's spec over the same
    weights."""
    for name, value in GATE:
        jflags.set(name, value)
    try:
        with junique.guard():
            jspec = JT.build_decode(JT.TransformerConfig(**SMALL), src_len=S,
                                    prefix_len=WINDOW, max_len=MAX_LEN)
        jscope = JScope()
        jdecode.Generator(jspec, scope=jscope)
        import jax.numpy as jnp

        for n in jscope.local_var_names():
            if n.endswith(".w_0") or n == "src_word_emb":
                jscope.set_var(n, jnp.asarray(jscope.find_var(n)) * 3.0)
    finally:
        for name, _ in GATE:
            jflags.reset(name)
    with testing.fresh_programs():
        spec = PT.build_decode(PT.TransformerConfig(**SMALL), src_len=S,
                               prefix_len=WINDOW, max_len=MAX_LEN)
    progs = [spec.prefill_program, spec.step_program]
    declared = {v.name for p in progs for v in p.list_vars()
                if v.persistable}
    scope = pt.Scope()
    convert.load_params(scope, {
        n: np.asarray(jscope.find_var(n))
        for n in jscope.local_var_names() if n in declared},
        pt.CPUPlace(), progs)
    return jspec, jscope, spec, scope


def _serve(sched):
    """The run: 4 requests at once, a second wave of 2 (one of them feed
    0 again: a prefix-cache hit) after the 3rd decode step, stepped to
    the end.  Returns the requests' tokens."""
    feeds = _feeds(5, 11)
    reqs = [sched.submit(f, MNT, eos_id=EOS) for f in feeds[:4]]
    for _ in range(4):
        sched.step()
    reqs += [sched.submit(f, MNT, eos_id=EOS) for f in (feeds[4], feeds[0])]
    sched.run_until_idle(max_steps=500)
    sched.pool.assert_quiesced()
    return [list(map(int, r.tokens)) for r in reqs]


def _ours(snap):
    return {kind: {n: v for n, v in snap[kind].items()
                   if n.startswith(NAMESPACES)}
            for kind in ("counters", "gauges", "histograms")}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_served_run_fills_both_registries_alike(world, paged):
    jspec, jscope, spec, scope = world
    kw = dict(max_batch=4, block_size=16, num_blocks=96, paged_kv=paged,
              flush_deadline_ms=0)
    for name, value in GATE:
        jflags.set(name, value)
        pflags.set(name, value)
    try:
        jtelem.enable()
        jtok = _serve(jserving.Scheduler(jspec, jscope, **kw))
        jtelem.disable()
        ptelem.enable()
        ptok = _serve(serving.Scheduler(spec, scope=scope,
                                        place=pt.CPUPlace(), **kw))
        ptelem.disable()
    finally:
        for name, _ in GATE:
            jflags.reset(name)
            pflags.reset(name)
    assert ptok == jtok
    j, p = _ours(jtelem.snapshot()), _ours(ptelem.snapshot())
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(p[kind]) == sorted(j[kind]), kind
    assert p["counters"] == j["counters"]
    assert p["gauges"] == j["gauges"]
    assert {n: h["count"] for n, h in p["histograms"].items()} == \
        {n: h["count"] for n, h in j["histograms"].items()}
    for n in ("serving.bucket_fill", "serving.queue_depth_per_step"):
        assert p["histograms"][n] == j["histograms"][n], n
    c = p["counters"]
    assert c["serving.submitted"] == 6 and c["serving.admissions"] == 6
    assert c["kv.prefix_hits"] == 1
    assert (c["kv.h2d_bytes"] > 0) and p["histograms"]["serving.ttft_ms"][
        "count"] == 6
    spans = [r for r in ptelem.spans() if r["name"] == "serving.request"]
    assert len(spans) == 6 and all(r["status"] == "ok" for r in spans)
