"""Process-wide metrics registry: counters, gauges, bucketed histograms
(counterpart of paddle_tpu/telemetry/registry.py: the same names, bounds,
percentiles and snapshot layout).

Design constraints, in priority order:

  1. DISABLED COSTS (ALMOST) NOTHING.  Instrument methods check one
     module-level bool and return — no lock, no allocation, no time
     read.  Call sites hold instrument objects created at import/init
     time (``_C_STEPS = registry.counter("serving.steps")``), so the
     fast path is one attribute load + one bool test.
  2. Thread-safe when enabled.  One registry lock guards every mutation
     (the hammering parties are scheduler loops and RPC handler threads
     — contention is modest and correctness beats sharding the lock).
  3. Snapshot without stopping the world: `snapshot()` takes the lock
     briefly and returns plain dicts, so a STATUS RPC or a soak's final
     dump never blocks the hot path for long.

Histograms are fixed-bucket (geometric bounds spanning 1e-3..1e5 by
default — microseconds to minutes when observations are milliseconds)
with exact count/sum/min/max; p50/p90/p99 are interpolated within the
winning bucket, which is accurate to bucket resolution (~1.33x spacing)
— the right trade for an always-on registry (no per-sample storage).
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["counter", "gauge", "histogram", "snapshot", "write_snapshot",
           "write_snapshot_jsonl", "reset_metrics", "enable", "disable",
           "enabled", "Counter", "Gauge", "Histogram",
           "DEFAULT_HISTOGRAM_BOUNDS"]

_LOCK = threading.Lock()
_COUNTERS: dict = {}
_GAUGES: dict = {}
_HISTOGRAMS: dict = {}

# the one gate every instrument checks first (module global: one LOAD_GLOBAL
# + truth test on the disabled path).  tracing.py reads it too.
_ENABLED = False


def _init_from_flag():
    """Initial state from the `telemetry` flag (env PADDLE_TPU_TELEMETRY).
    Runtime toggling goes through enable()/disable() — flags.set alone
    does not flip the fast-path bool, by design (the bool IS the gate)."""
    global _ENABLED
    try:
        from .. import flags

        _ENABLED = bool(flags.get("telemetry"))
    except Exception:  # flag not registered yet (import-order tolerant)
        _ENABLED = os.environ.get("PADDLE_TPU_TELEMETRY", "") not in (
            "", "0", "false", "False", "off")


def enabled():
    return _ENABLED


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


# geometric ladder, ~1.33x per bucket: 10**(k/8) for k in -24..40 spans
# 1e-3 .. 1e5 (sub-ms to ~100s when the unit is ms) in 65 buckets.
DEFAULT_HISTOGRAM_BOUNDS = tuple(
    round(10.0 ** (k / 8.0), 6) for k in range(-24, 41))


class Counter:
    """Monotonic counter.  `inc(n)` under the registry lock; reads are
    unlocked (a torn read of an int is impossible in CPython)."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        if not _ENABLED:
            return
        with _LOCK:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value (e.g. ``kv.blocks_in_use``)."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0.0

    def set(self, v):
        if not _ENABLED:
            return
        with _LOCK:
            self.value = v

    def add(self, d):
        if not _ENABLED:
            return
        with _LOCK:
            self.value += d


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and
    interpolated percentiles (p50/p90/p99 in `summary()`)."""

    __slots__ = ("name", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")

    def __init__(self, name, bounds=None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None \
            else DEFAULT_HISTOGRAM_BOUNDS
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v):
        if not _ENABLED:
            return
        v = float(v)
        with _LOCK:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self.bucket_counts[self._bucket_of(v)] += 1

    def _bucket_of(self, v):
        # binary search over the bounds ladder (65 entries -> 7 probes)
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def percentile(self, p):
        """Interpolated percentile in [0, 100]; None when empty.
        Clamped to the exact min/max so p0/p100 are never extrapolated
        past observed values."""
        if self.count == 0:
            return None
        target = (p / 100.0) * self.count
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else \
                    (self.max if self.max is not None else lo)
                frac = (target - seen) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.min, min(self.max, est))
            seen += c
        return self.max

    def summary(self):
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                    "max": None, "p50": None, "p90": None, "p99": None}
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6),
            "min": round(self.min, 6),
            "max": round(self.max, 6),
            "p50": round(self.percentile(50), 6),
            "p90": round(self.percentile(90), 6),
            "p99": round(self.percentile(99), 6),
        }


def _get_or_create(table, name, factory, kind):
    with _LOCK:
        inst = table.get(name)
        if inst is None:
            for other_kind, other in (("counter", _COUNTERS),
                                      ("gauge", _GAUGES),
                                      ("histogram", _HISTOGRAMS)):
                if other is not table and name in other:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{other_kind}, cannot re-register as {kind}")
            inst = table[name] = factory()
        return inst


def counter(name):
    """Get-or-create the counter `name` (idempotent — call sites may
    each hold their own reference to the same instrument)."""
    return _get_or_create(_COUNTERS, name, lambda: Counter(name), "counter")


def gauge(name):
    return _get_or_create(_GAUGES, name, lambda: Gauge(name), "gauge")


def histogram(name, bounds=None):
    return _get_or_create(
        _HISTOGRAMS, name, lambda: Histogram(name, bounds), "histogram")


def snapshot():
    """Plain-dict view of every instrument — what the STATUS RPCs return
    and the soaks persist next to their metrics JSONL."""
    with _LOCK:
        return {
            "ts": time.time(),
            "pid": os.getpid(),
            "enabled": _ENABLED,
            "counters": {n: c.value for n, c in sorted(_COUNTERS.items())},
            "gauges": {n: g.value for n, g in sorted(_GAUGES.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(_HISTOGRAMS.items())},
        }


def write_snapshot(path, snap=None):
    """Persist a snapshot as one JSON document (atomic rename)."""
    snap = snapshot() if snap is None else snap
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return snap


def write_snapshot_jsonl(path, snap=None, bench="telemetry"):
    """Bench-style JSONL (one {"metric", "value", ...} per line — the
    format tools/bench_diff.py parses): counters and gauges one line
    each, histograms one line per summary stat that has a direction
    (mean/p50/p99)."""
    snap = snapshot() if snap is None else snap
    lines = []
    for name, v in snap["counters"].items():
        lines.append({"bench": bench, "metric": name, "kind": "counter",
                      "value": v})
    for name, v in snap["gauges"].items():
        lines.append({"bench": bench, "metric": name, "kind": "gauge",
                      "value": v})
    for name, s in snap["histograms"].items():
        rec = {"bench": bench, "metric": name, "kind": "histogram",
               "value": s["mean"], "count": s["count"]}
        for k in ("p50", "p99", "min", "max"):
            rec[k] = s[k]
        lines.append(rec)
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    return len(lines)


def reset_metrics():
    """Zero every instrument IN PLACE (references held by call sites stay
    valid — a reset must not orphan the instruments hot paths captured)."""
    with _LOCK:
        for c in _COUNTERS.values():
            c.value = 0
        for g in _GAUGES.values():
            g.value = 0.0
        for h in _HISTOGRAMS.values():
            h.bucket_counts = [0] * (len(h.bounds) + 1)
            h.count = 0
            h.sum = 0.0
            h.min = None
            h.max = None


_init_from_flag()
