"""The port's overload control plane (paddle_tpu_torch/serving/overload.py
and the Scheduler's admission hooks) against the JAX package's.

  * `OverloadControl` and `CircuitBreaker`: both packages are driven by
    one scripted sequence of observe_*, admit, acquire and record_* calls,
    with each module's `time.monotonic` replaced by one fake clock: equal
    decisions (the clamped token budget, or the reject's reason and
    retry_after_ms), levels, counters, transitions and instruments;
  * the Scheduler, on the CPU (the JAX tests' tiny transformer, one
    layer, weights carried from the JAX startup): a reject never touches
    the block pool; accepted requests' tokens equal the JAX package's
    sequential Generator's with doomed arrivals interleaved; batch work
    is evicted before interactive; priority survives export and import;
    the brownout ladder sheds or clamps batch work under a flood and
    walks back to normal when it drains (the Scheduler-side subjects of
    tests/test_overload.py).
"""

import types

import numpy as np
import pytest

from paddle_tpu import decode as jdecode
from paddle_tpu import telemetry as jtelem
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.serving import overload as joverload
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, serving, testing
from paddle_tpu_torch import telemetry as ptelem
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.serving import overload as poverload

CPU = pt.CPUPlace()
S, P, MAXLEN, V = 8, 7, 28, 40
OVERLOAD_METRICS = ("serving.admission_rejects", "serving.shed_batch",
                    "serving.brownout_transitions")


@pytest.fixture(autouse=True)
def _fresh_state():
    for t in (jtelem, ptelem):
        t.disable()
        t.reset_metrics()
    with testing.fresh_programs():
        yield
    for t in (jtelem, ptelem):
        t.disable()
        t.reset_metrics()
        t.reset_spans()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock read by both overload modules."""
    c = _Clock()
    for mod in (joverload, poverload):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=c))
    return c


def _decide(fn):
    try:
        return ("ok", fn())
    except (joverload.AdmissionRejected, poverload.AdmissionRejected) as e:
        return ("rejected", e.reason, e.retry_after_ms, str(e))


def _script(seed, n):
    """A seeded mix of observations and admissions: bursts of queue depth
    that climb the ladder and lulls that walk it back down."""
    rng = np.random.RandomState(seed)
    ops = []
    for i in range(n):
        phase = (i // 60) % 3  # calm, storm, drain
        r = rng.rand()
        dt = float(rng.choice([0.0, 0.01, 0.05, 0.3]))
        if r < 0.25:
            ops.append(("step", dt, float(rng.uniform(0.5, 40.0))))
        elif r < 0.35:
            ops.append(("prefill", dt, float(rng.uniform(1.0, 300.0)),
                        int(rng.randint(1, 2049))))
        elif r < 0.65:
            depth = int(rng.randint(0, 6)) if phase != 1 \
                else int(rng.randint(8, 40))
            ops.append(("queue", dt, depth))
        else:
            deadline = [None, 0.0, -3.0, float(rng.uniform(1, 5000))][
                int(rng.randint(0, 4))]
            ops.append(("admit", dt,
                        ("interactive", "batch")[int(rng.randint(0, 2))],
                        int(rng.randint(1, 64)), deadline,
                        int(rng.randint(0, 500)), int(rng.randint(1, 2049)),
                        bool(rng.rand() < 0.2)))
    return ops


def _run(oc, op, clock):
    clock.t += op[1]
    kind = op[0]
    if kind == "step":
        oc.observe_step(op[2])
        return None
    if kind == "prefill":
        oc.observe_prefill(op[2], tokens=op[3])
        return None
    if kind == "queue":
        return oc.observe_queue(op[2])
    _, _, prio, mnt, deadline, backlog, ptok, cached = op
    return _decide(lambda: oc.admit(prio, mnt, deadline, backlog,
                                    prompt_tokens=ptok, cached=cached))


@pytest.mark.parametrize("seed,kw", [
    (0, dict(queue_high=6, up_after=2, down_after=3, clamp_tokens=4,
             slo_tighten_pct=50, min_dwell_s=0.1)),
    (1, dict(min_dwell_s=0.0)),   # the flags' defaults otherwise
    (2, dict(queue_high=3, queue_low=1, up_after=1, down_after=2,
             clamp_tokens=2, slo_tighten_pct=80, min_dwell_s=0.2)),
])
def test_overload_control_decides_as_jax(clock, seed, kw):
    for t in (jtelem, ptelem):
        t.enable()
    joc = joverload.OverloadControl(6, **kw)
    poc = poverload.OverloadControl(6, **kw)
    levels = set()
    for op in _script(seed, 600):
        got = _run(poc, op, clock)
        clock.t -= op[1]
        want = _run(joc, op, clock)
        assert got == want, op
        assert poc.level == joc.level and poc._hot == joc._hot \
            and poc._calm == joc._calm
        levels.add(poc.level)
        for probe in ((12, 0), (12, 300)):
            assert poc.estimate_ms(*probe) == joc.estimate_ms(*probe)
        assert poc.retry_after_ms(100) == joc.retry_after_ms(100)
    assert poc.view() == joc.view()
    assert poc.transitions == joc.transitions
    assert poc.counters == joc.counters
    assert len(levels) >= 3, levels   # the script walks the ladder
    assert all(v > 0 for v in poc.counters.values()), poc.counters
    jsnap, psnap = jtelem.snapshot(), ptelem.snapshot()
    for n in OVERLOAD_METRICS:
        assert psnap["counters"][n] == jsnap["counters"][n] > 0, n
    assert psnap["gauges"]["serving.brownout_state"] == \
        jsnap["gauges"]["serving.brownout_state"]
    brown = [r for r in ptelem.spans() if r["name"] == "serving.brownout"]
    assert len(brown) == poc.counters["transitions"]


def test_circuit_breaker_as_jax(clock):
    opened = {"jax": 0, "port": 0}

    def hook(k):
        def on_open():
            opened[k] += 1
        return on_open

    jb = joverload.CircuitBreaker(open_after=3, cooldown_s=0.5,
                                  on_open=hook("jax"))
    pb = poverload.CircuitBreaker(open_after=3, cooldown_s=0.5,
                                  on_open=hook("port"))
    rng = np.random.RandomState(5)
    states = set()
    for _ in range(400):
        clock.t += float(rng.choice([0.0, 0.05, 0.2, 0.6]))
        op = ("acquire", "available", "ok", "fail", "fail",
              "reset")[int(rng.randint(0, 6)) if rng.rand() > 0.02 else 5]
        res = []
        for b in (jb, pb):
            if op == "acquire":
                res.append(b.acquire())
            elif op == "available":
                res.append(b.available())
            elif op == "ok":
                res.append(b.record_success())
            elif op == "fail":
                res.append(b.record_failure())
            else:
                res.append(b.reset())
        assert res[0] == res[1], op
        assert (pb.state, pb.failures, pb.opened, pb._probing) == \
            (jb.state, jb.failures, jb.opened, jb._probing)
        states.add(pb.state)
    assert opened["port"] == opened["jax"] == pb.opened > 0
    assert states == {"closed", "open", "half_open"}


# ---------------------------------------------------------------------------
# the Scheduler's admission hooks, on the CPU
# ---------------------------------------------------------------------------


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
        jscope = JScope()
        self.jgen = jdecode.Generator(self.jspec, scope=jscope)
        self.spec = PT.build_decode(_cfg(PT), src_len=S, prefix_len=P,
                                    max_len=MAXLEN)
        progs = [self.spec.prefill_program, self.spec.step_program]
        declared = {v.name for p in progs for v in p.list_vars()
                    if v.persistable}
        self.scope = pt.Scope()
        convert.load_params(self.scope, {
            n: np.asarray(jscope.find_var(n))
            for n in jscope.local_var_names() if n in declared}, CPU, progs)

    def jax_refs(self, feeds, mnt, eos=1):
        return [np.asarray(self.jgen.generate(f, mnt, eos_id=eos))[0]
                .tolist() for f in feeds]


@pytest.fixture(scope="module")
def world():
    with testing.fresh_programs():
        return _World()


def _sched(world, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("admission", True)
    return serving.Scheduler(world.spec, scope=world.scope, place=CPU, **kw)


def test_reject_never_touches_block_pool(world):
    sched = _sched(world)
    h = sched.submit(_mk_feed(1), 4, eos_id=1)
    sched.run_until_idle(max_steps=500)
    assert h.status == "done" and sched._overload.step_ms() is not None
    ptelem.enable()
    blocks = ptelem.gauge("kv.blocks_in_use")
    before_gauge, before_used = blocks.value, sched.pool.used_blocks()
    with pytest.raises(serving.AdmissionRejected) as ei:
        sched.submit(_mk_feed(2), 16, deadline_ms=1.0, eos_id=1)
    assert ei.value.reason == "infeasible" and ei.value.retry_after_ms > 0
    with pytest.raises(serving.AdmissionRejected) as ei:
        sched.submit(_mk_feed(3), 4, deadline_ms=0.0, eos_id=1)
    assert ei.value.reason == "expired" and ei.value.retry_after_ms is None
    assert sched.pool.used_blocks() == before_used
    assert blocks.value == before_gauge
    snap = ptelem.snapshot()
    assert snap["counters"]["serving.admission_rejects"] == 2
    assert snap["counters"]["serving.submitted"] == 0
    assert sched.counters["rejected"] == 2
    assert sched.counters["submitted"] == 1
    assert sched.stats()["overload"]["counters"]["rejected_infeasible"] == 1
    sched.pool.assert_quiesced()


def test_accepted_requests_equal_jax_tokens(world):
    feeds = [_mk_feed(300 + i) for i in range(6)]
    refs = world.jax_refs(feeds, 10)
    sched = _sched(world)
    h = sched.submit(_mk_feed(0), 4, eos_id=1)
    sched.run_until_idle(max_steps=500)
    assert h.status == "done"
    accepted, kept, doomed = [], [], 0
    for i, (f, ref) in enumerate(zip(feeds, refs)):
        accepted.append(sched.submit(f, 10, deadline_ms=60_000.0, eos_id=1))
        kept.append(ref)
        with pytest.raises(serving.AdmissionRejected):
            sched.submit(_mk_feed(900 + i), 16, deadline_ms=0.5, eos_id=1)
        doomed += 1
        sched.step()
    sched.run_until_idle(max_steps=2000)
    for r, ref in zip(accepted, kept, strict=True):
        assert r.status == "done", (r.status, r.error)
        assert r.tokens == ref
    assert sched.counters["rejected"] == doomed
    sched.pool.assert_quiesced()


def test_batch_evicted_before_interactive(world):
    import time

    sched = _sched(world, admission=False)
    batch = sched.submit(_mk_feed(10), 8, eos_id=-1, priority="batch")
    inter = sched.submit(_mk_feed(11), 8, eos_id=-1, priority="interactive")
    for _ in range(3):
        sched.step()
    assert batch.status == "running" and inter.status == "running"
    assert sched._pick_victim() is batch
    inter.deadline = time.monotonic() - 1.0  # expired outranks batch
    assert sched._pick_victim() is inter
    with pytest.raises(ValueError):
        sched.submit(_mk_feed(0), 4, priority="urgent")
    sched.close()


def test_priority_survives_export_import(world):
    sched = _sched(world, admission=False)
    sched.submit(_mk_feed(20), 8, eos_id=1, priority="batch",
                 request_id="r-batch")
    recs = sched.export_requests(cancel=True)
    assert recs[0]["priority"] == "batch"
    sched2 = _sched(world, admission=True)
    # a continuation bypasses the gate, even with a spent deadline
    recs[0]["deadline_ms"] = None
    (h,) = sched2.import_requests(recs)
    assert h.priority == "batch"
    sched2.run_until_idle(max_steps=1000)
    assert h.status == "done"
    assert h.tokens == world.jax_refs([_mk_feed(20)], 8)[0]
    sched.close()
    sched2.close()


def test_brownout_ladder_drives_shedding(world):
    sched = _sched(world)
    sched._overload = poverload.OverloadControl(
        sched.max_batch, queue_high=3, up_after=2, down_after=4,
        clamp_tokens=2, min_dwell_s=0.0)
    feeds = [_mk_feed(40 + i) for i in range(10)]
    reqs = [sched.submit(f, 6, eos_id=1) for f in feeds]
    for _ in range(4):
        sched.step()  # the queue stays deep: pressured observations
    # two rungs: each needs up_after pressured observations in a row
    assert sched._overload.level == poverload.SHED_BATCH
    with pytest.raises(serving.AdmissionRejected) as ei:
        sched.submit(_mk_feed(99), 6, eos_id=1, priority="batch")
    assert ei.value.reason == "shed_batch"
    assert ei.value.retry_after_ms is not None
    sched.run_until_idle(max_steps=2000)
    for _ in range(20):
        sched.step()  # idle, calm observations: recovery
    view = sched.stats()["overload"]
    ups = sum(1 for _, a, b in sched._overload.transitions if b > a)
    assert view["state"] == "normal" and ups >= 2
    assert view["counters"]["transitions"] == 2 * ups
    assert view["counters"]["shed_batch"] == 1
    refs = world.jax_refs(feeds, 6)
    assert [r.tokens for r in reqs] == refs

    # one rung up only: batch work is clamped to a prefix of its tokens
    sched._overload = poverload.OverloadControl(
        sched.max_batch, queue_high=3, up_after=2, down_after=4,
        clamp_tokens=2, min_dwell_s=60.0)
    more = [sched.submit(f, 6, eos_id=-1) for f in feeds[:8]]
    for _ in range(3):
        sched.step()
    assert sched._overload.level == poverload.CLAMP_BATCH
    h = sched.submit(feeds[9], 6, eos_id=1, priority="batch")
    assert h.max_new_tokens == 2
    sched.run_until_idle(max_steps=2000)
    full = world.jax_refs([feeds[9]], 6)[0]
    assert h.status == "done" and h.tokens == full[:2]
    assert all(r.status == "done" for r in more)
    sched.pool.assert_quiesced()
