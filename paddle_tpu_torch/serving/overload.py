"""Overload control plane for the serving tier — admission, brownout,
and circuit breaking (counterpart of paddle_tpu/serving/overload.py:
the same decisions, levels, counters and instruments).

Without it every arrival is admitted no matter how doomed, and p99
collapses past saturation.  This module is the flow control, three
cooperating mechanisms:

* `OverloadControl.admit` — a feasibility gate at `Scheduler.submit`:
  given the EWMA per-step decode time, the EWMA PER-TOKEN prefill
  time, and the token backlog already queued/active, estimate this
  request's completion time

      est_ms = prefill_tok * prompt_tokens      (0 on a prefix hit)
               + step * (backlog_tokens / max_batch + max_new_tokens)

  The prefill estimator is per-token so chunked passes, whole-prompt
  prefills, and grouped prefills all feed one EWMA, and so a cold
  S=2048 prompt is priced ~16x a cold S=128 one instead of at the
  average of whatever mix came before.

  and reject (`AdmissionRejected`, with a `retry_after_ms` hint sized
  to drain the backlog) any request whose deadline the estimate cannot
  meet.  The gate runs BEFORE a `ServedRequest` exists, so a rejected
  request never touches the BlockPool — rejection costs one EWMA
  multiply, not an alloc/evict cycle.  Cold start admits everything
  (the estimate needs one observed step to mean anything).

* Brownout — a stepped degradation ladder driven by the same queue
  depth the `serving.queue_depth` gauge publishes, observed once per
  scheduler step:

      NORMAL -> CLAMP_BATCH  (batch max_new_tokens clamped)
             -> SHED_BATCH   (batch admissions rejected outright)
             -> TIGHTEN_SLO  (interactive admissions must fit a
                              tightened effective deadline)

  Escalation needs `up_after` consecutive pressured observations,
  recovery `down_after` consecutive calm ones, and any transition
  waits out a minimum dwell — hysteresis both ways, so a load spike
  ratchets degradation in deliberate steps and a lull doesn't flap it
  back.  Each transition bumps `serving.brownout_transitions`, moves
  the `serving.brownout_state` gauge, and emits a telemetry span event.

* `CircuitBreaker` — per-replica client-side protection a router wraps
  around each backend: `open_after` consecutive failures (transport
  faults or admission rejects) trip CLOSED -> OPEN, traffic stops
  immediately, and after `cooldown_ms` exactly one probe request flows
  (HALF_OPEN); its outcome closes or re-opens the breaker.

On the card the estimators see host wall time around a step or a
prefill; the Scheduler ends each such window on a read-back of the
card's result, so the window covers the card's work (see
serving/scheduler.py).  A program's first calls at a new signature (its
eager warm-up and its CUDA-graph capture) take far longer than a
replay: warm every signature before taking traffic and reset the EWMAs
(`_step_ms`, `_prefill_ms`), as chip_smoke.py's serving legs do.

Parity contract: admission is outcome-invisible.  A rejected request
produced no tokens; an accepted one decodes bitwise-identically to
sequential `Generator.generate()` (clamping only shortens
max_new_tokens, which by the prefix property of greedy decode yields a
prefix of the unclamped generation).  tests/test_torch_overload.py pins
this against the JAX package.
"""

from __future__ import annotations

import threading
import time

from ..resilience.channel import RemoteOpError
from ..telemetry import registry as _telem
from ..telemetry import tracing as _tracing

__all__ = ["AdmissionRejected", "OverloadControl", "CircuitBreaker",
           "BROWNOUT_LEVELS", "NORMAL", "CLAMP_BATCH", "SHED_BATCH",
           "TIGHTEN_SLO", "PRIORITIES"]

_C_REJECTS = _telem.counter("serving.admission_rejects")
_C_SHED = _telem.counter("serving.shed_batch")
_C_TRANSITIONS = _telem.counter("serving.brownout_transitions")
_G_BROWNOUT = _telem.gauge("serving.brownout_state")

# brownout ladder (gauge value = index)
NORMAL, CLAMP_BATCH, SHED_BATCH, TIGHTEN_SLO = 0, 1, 2, 3
BROWNOUT_LEVELS = ("normal", "clamp_batch", "shed_batch", "tighten_slo")

PRIORITIES = ("interactive", "batch")

# EWMA smoothing for the step/prefill estimators: ~the last 20
# observations dominate — fast enough to track a bucket change, slow
# enough that one compile blip doesn't reject a burst
_EWMA_ALPHA = 0.1


class AdmissionRejected(RemoteOpError):
    """Submit refused by the overload control plane — a complete,
    deterministic answer, not a fault: subclassing RemoteOpError gives
    it the never-retried-by-the-channel discipline for free (the wire
    carries it as OP_REJECT, the stream stays in sync).

    reason: "infeasible" (deadline cannot be met given the backlog),
    "shed_batch" (brownout is shedding batch-class work), or "expired"
    (the deadline was already spent on arrival).  retry_after_ms hints
    when the backlog should have drained enough to try again (None =
    don't bother, e.g. expired)."""

    def __init__(self, reason, retry_after_ms=None, detail=""):
        msg = f"admission rejected ({reason})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class OverloadControl:
    """Admission gate + brownout ladder for one Scheduler.

    The scheduler owns one instance and calls three hooks:
    `observe_step` / `observe_prefill` with measured wall times (the
    estimators), `observe_queue` once per step (what moves the brownout
    ladder), and `admit` from submit().  All state is internal — the
    estimators run whether or not the telemetry registry is enabled,
    mirroring what the `serving.step_ms` histogram would see."""

    def __init__(self, max_batch, queue_high=None, up_after=None,
                 down_after=None, clamp_tokens=None,
                 slo_tighten_pct=None, min_dwell_s=0.2, queue_low=None):
        from .. import flags

        self.max_batch = max(1, int(max_batch))
        self.queue_high = int(flags.get("brownout_queue_high")
                              if queue_high is None else queue_high)
        # de-escalation threshold sits BELOW the escalation one: the
        # dead zone (queue_low, queue_high] counts toward neither
        # streak, so a queue hovering near queue_high can't limit-cycle
        # shed -> drain -> de-escalate -> flood -> shed
        self.queue_low = (max(0, self.queue_high // 2)
                          if queue_low is None
                          else max(0, min(int(queue_low), self.queue_high)))
        self.up_after = max(1, int(flags.get("brownout_up_after")
                                   if up_after is None else up_after))
        self.down_after = max(1, int(flags.get("brownout_down_after")
                                     if down_after is None
                                     else down_after))
        self.clamp_tokens = max(1, int(
            flags.get("brownout_clamp_tokens")
            if clamp_tokens is None else clamp_tokens))
        self.slo_tighten_pct = min(95, max(0, int(
            flags.get("brownout_slo_tighten_pct")
            if slo_tighten_pct is None else slo_tighten_pct)))
        self.min_dwell_s = float(min_dwell_s)
        self._lock = threading.Lock()
        self.level = NORMAL
        self._hot = 0            # consecutive pressured observations
        self._calm = 0           # consecutive calm observations
        self._last_change = 0.0  # monotonic ts of the last transition
        self._step_ms = None     # EWMA decode-step wall time
        self._prefill_ms = None  # EWMA prefill wall time PER PROMPT TOKEN
        self.counters = {"rejected_infeasible": 0, "rejected_expired": 0,
                         "shed_batch": 0, "clamped": 0, "transitions": 0}
        self.transitions = []    # (monotonic_ts, from_level, to_level)
        _G_BROWNOUT.set(NORMAL)

    # -- estimators (fed by the scheduler's step/prefill timers) ----------

    def observe_step(self, ms):
        with self._lock:
            self._step_ms = ms if self._step_ms is None else \
                (1 - _EWMA_ALPHA) * self._step_ms + _EWMA_ALPHA * ms

    def observe_prefill(self, ms, tokens=1):
        """One prefill observation, normalized PER PROMPT TOKEN so
        chunked passes (C tokens each), whole-prompt prefills (S
        tokens), and grouped prefills (sum of prompt lengths) all feed
        the same estimator.  Callers must NOT observe prefix-cache hits
        (a hit does zero prefill work; observing its ~0ms would
        collapse the per-token estimate and misprice the next cold
        long prompt)."""
        obs = ms / max(1, tokens)
        with self._lock:
            self._prefill_ms = obs if self._prefill_ms is None else \
                (1 - _EWMA_ALPHA) * self._prefill_ms + _EWMA_ALPHA * obs

    def step_ms(self):
        with self._lock:
            return self._step_ms

    # -- brownout ladder ---------------------------------------------------

    def observe_queue(self, depth):
        """One brownout observation (call once per scheduler step, busy
        or idle — recovery depends on calm observations while the queue
        stays short)."""
        pressured = depth > self.queue_high
        calm = depth <= self.queue_low
        now = time.monotonic()
        with self._lock:
            if pressured:
                self._calm = 0
                self._hot += 1
                if (self._hot >= self.up_after
                        and self.level < TIGHTEN_SLO
                        and now - self._last_change >= self.min_dwell_s):
                    self._transition(self.level + 1, now)
            elif calm:
                self._hot = 0
                self._calm += 1
                if (self._calm >= self.down_after
                        and self.level > NORMAL
                        and now - self._last_change >= self.min_dwell_s):
                    self._transition(self.level - 1, now)
            else:
                # dead zone: not hot enough to climb, not drained enough
                # to step down — reset both streaks and hold the level
                self._hot = 0
                self._calm = 0
        return self.level

    def _transition(self, to_level, now):
        # lock held.  One ladder rung per transition — a sustained storm
        # climbs NORMAL -> TIGHTEN_SLO in three observed escalations,
        # each a visible event, never a silent jump.
        frm = self.level
        self.level = to_level
        self._hot = 0
        self._calm = 0
        self._last_change = now
        self.counters["transitions"] += 1
        self.transitions.append((now, frm, to_level))
        _G_BROWNOUT.set(to_level)
        _C_TRANSITIONS.inc()
        if _telem._ENABLED:
            # zero-duration span = the transition event in the trace
            _tracing.start_span(
                "serving.brownout",
                frm=BROWNOUT_LEVELS[frm],
                to=BROWNOUT_LEVELS[to_level]).end(BROWNOUT_LEVELS[to_level])

    # -- admission ---------------------------------------------------------

    def estimate_ms(self, max_new_tokens, backlog_tokens,
                    prompt_tokens=1, cached=False):
        """Completion-time estimate for a new request: its own prefill
        (per-token EWMA x prompt length — zero when the prompt is a
        known prefix-cache hit), plus its decode steps, plus its share
        of draining the tokens already ahead of it (the whole backlog
        interleaves through max_batch-wide steps).  None until the
        estimators warm up."""
        with self._lock:
            step = self._step_ms
            per_tok = self._prefill_ms
        if step is None:
            return None
        if cached:
            prefill = 0.0
        elif per_tok is None:
            prefill = 4.0 * step
        else:
            prefill = per_tok * max(1, prompt_tokens)
        return prefill + step * (backlog_tokens / self.max_batch
                                 + max_new_tokens)

    def retry_after_ms(self, backlog_tokens):
        """How long until the current backlog has roughly drained — the
        OP_REJECT hint a well-behaved client waits out before retrying
        (storm damping: rejected clients come back staggered by load,
        not in lockstep)."""
        with self._lock:
            step = self._step_ms
        if step is None:
            return 50.0
        return max(1.0, step * backlog_tokens / self.max_batch)

    def admit(self, priority, max_new_tokens, deadline_ms,
              backlog_tokens, prompt_tokens=1, cached=False):
        """The gate: returns the (possibly clamped) max_new_tokens or
        raises AdmissionRejected.  Pure arithmetic on scheduler-reported
        backlog — never touches pool or queues itself."""
        level = self.level
        if priority == "batch":
            if level >= SHED_BATCH:
                with self._lock:
                    self.counters["shed_batch"] += 1
                _C_SHED.inc()
                _C_REJECTS.inc()
                raise AdmissionRejected(
                    "shed_batch", self.retry_after_ms(backlog_tokens),
                    f"brownout level {BROWNOUT_LEVELS[level]}")
            if level >= CLAMP_BATCH and max_new_tokens > self.clamp_tokens:
                with self._lock:
                    self.counters["clamped"] += 1
                max_new_tokens = self.clamp_tokens
        if deadline_ms is not None:
            if deadline_ms <= 0:
                with self._lock:
                    self.counters["rejected_expired"] += 1
                _C_REJECTS.inc()
                raise AdmissionRejected(
                    "expired", None, "deadline spent before arrival")
            budget = float(deadline_ms)
            if priority == "interactive" and level >= TIGHTEN_SLO:
                budget *= (100 - self.slo_tighten_pct) / 100.0
            est = self.estimate_ms(max_new_tokens, backlog_tokens,
                                   prompt_tokens=prompt_tokens,
                                   cached=cached)
            if est is not None and est > budget:
                with self._lock:
                    self.counters["rejected_infeasible"] += 1
                _C_REJECTS.inc()
                raise AdmissionRejected(
                    "infeasible", self.retry_after_ms(backlog_tokens),
                    f"estimated {est:.1f}ms > budget {budget:.1f}ms "
                    f"(backlog {backlog_tokens} tok)")
        return max_new_tokens

    def view(self):
        with self._lock:
            return {
                "state": BROWNOUT_LEVELS[self.level],
                "level": self.level,
                "step_ms_ewma": self._step_ms,
                "prefill_tok_ms_ewma": self._prefill_ms,
                "queue_high": self.queue_high,
                "queue_low": self.queue_low,
                "counters": dict(self.counters),
                "transitions": len(self.transitions),
            }


class CircuitBreaker:
    """Per-target breaker: CLOSED (traffic flows) -> OPEN after
    `open_after` consecutive failures (nothing flows) -> HALF_OPEN after
    `cooldown_s` (exactly one probe flows) -> CLOSED on probe success,
    back to OPEN on probe failure.

    `acquire()` is the traffic gate (consumes the half-open probe
    slot); `available()` is the non-consuming membership filter a
    router's pick loop uses.  `on_open` fires once per CLOSED/HALF_OPEN
    -> OPEN trip (a router's event-log and counter hook)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, open_after=3, cooldown_s=1.0, on_open=None):
        self.open_after = max(1, int(open_after))
        self.cooldown_s = float(cooldown_s)
        self.on_open = on_open
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.failures = 0
        self.opened = 0          # lifetime trips
        self._opened_t = 0.0
        self._probing = False

    def available(self):
        """Would acquire() grant a request right now?  (No state
        change — safe to call while filtering candidates.)"""
        with self._lock:
            return self._available_locked()

    def _available_locked(self):
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            return time.monotonic() - self._opened_t >= self.cooldown_s
        return not self._probing  # HALF_OPEN: one probe at a time

    def acquire(self):
        """Gate one request.  True = proceed (and if the breaker was
        cooling down, this request IS the half-open probe); False =
        shed at the caller."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if not self._available_locked():
                return False
            self.state = self.HALF_OPEN
            self._probing = True
            return True

    def record_success(self):
        with self._lock:
            self.failures = 0
            self._probing = False
            self.state = self.CLOSED

    def record_failure(self):
        with self._lock:
            self.failures += 1
            probe_failed = self.state == self.HALF_OPEN
            self._probing = False
            if probe_failed or (self.state == self.CLOSED
                                and self.failures >= self.open_after):
                tripped = self.state != self.OPEN
                self.state = self.OPEN
                self._opened_t = time.monotonic()
                if tripped:
                    self.opened += 1
                    cb = self.on_open
                else:
                    cb = None
            else:
                cb = None
        if cb is not None:
            cb()

    def reset(self):
        """Back to a fresh CLOSED breaker (replica readmitted — the new
        process inherits no grudges)."""
        with self._lock:
            self.state = self.CLOSED
            self.failures = 0
            self._probing = False
