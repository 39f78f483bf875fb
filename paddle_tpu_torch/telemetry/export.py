"""Chrome-trace export: one timeline for telemetry spans AND host op
spans (counterpart of paddle_tpu/telemetry/export.py).

The two sources run on different clocks — telemetry spans stamp wall
epoch seconds at start (so spans from different processes line up),
while host op spans are plain ``(name, t0_perf, dur_s, tid)`` records
on the ``time.perf_counter()`` clock (what the JAX package's profiler
records; the port has no profiler module yet, so a caller passes its
own list).  `chrome_trace` converts them with the offset
``time.time() - time.perf_counter()`` sampled at export time, which is
exact for same-process spans, so a single merged file opens in
chrome://tracing / Perfetto with op spans and system spans on one axis.

Span JSONL round-trip (`write_spans_jsonl`/`read_spans_jsonl`) is the
multi-process path: each worker drains its ring to a file (or serves it
over the STATUS op), the collector reads them all and passes the union
to `chrome_trace` — epoch timestamps make the merge a concatenation.
"""

from __future__ import annotations

import json
import os
import time

from . import tracing

__all__ = ["chrome_trace", "write_chrome_trace", "write_spans_jsonl",
           "read_spans_jsonl", "host_clock_offset"]


def host_clock_offset():
    """Seconds to add to a perf_counter timestamp from THIS process to
    place it on the epoch axis telemetry spans use."""
    return time.time() - time.perf_counter()


def _span_event(rec):
    args = {
        "trace": f"{rec.get('trace', 0):x}",
        "span": f"{rec.get('span', 0):x}",
        "status": rec.get("status", "ok"),
    }
    parent = rec.get("parent")
    if parent:
        args["parent"] = f"{parent:x}"
    attrs = rec.get("attrs")
    if attrs:
        args.update(attrs)
    return {
        "name": rec["name"],
        "ph": "X",
        "ts": rec["ts"] * 1e6,
        "dur": rec["dur"] * 1e6,
        "pid": rec.get("pid", 0),
        "tid": rec.get("tid", 0),
        "cat": "span",
        "args": args,
    }


def _host_event(span, offset, pid):
    name, t0, dur, tid = span
    return {
        "name": name,
        "ph": "X",
        "ts": (t0 + offset) * 1e6,
        "dur": dur * 1e6,
        "pid": pid,
        "tid": tid,
        "cat": "op",
    }


def chrome_trace(telemetry_spans=None, host_spans=None, clock_offset=None,
                 pid=None):
    """Build a chrome://tracing document (dict, JSON-serialisable).

    telemetry_spans: span record dicts (default: this process's buffer,
    `tracing.spans()`); pass a merged list for multi-process traces.
    host_spans: host op span tuples ``(name, t0_perf, dur_s, tid)``
    on the perf_counter clock — converted via `clock_offset` (default:
    sampled now, correct for same-process spans).
    """
    if telemetry_spans is None:
        telemetry_spans = tracing.spans()
    events = [_span_event(rec) for rec in telemetry_spans]
    if host_spans:
        offset = host_clock_offset() if clock_offset is None else clock_offset
        hp = os.getpid() if pid is None else pid
        events.extend(_host_event(s, offset, hp) for s in host_spans)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, telemetry_spans=None, host_spans=None,
                       clock_offset=None, pid=None):
    """Write the merged trace; returns the number of events."""
    doc = chrome_trace(telemetry_spans, host_spans, clock_offset, pid)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(doc["traceEvents"])


def write_spans_jsonl(path, span_records=None, append=False):
    """One span record per line — the cross-process hand-off format
    (a server dumps its ring; a collector concatenates and exports)."""
    if span_records is None:
        span_records = tracing.spans()
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for rec in span_records:
            f.write(json.dumps(rec) + "\n")
    return len(span_records)


def read_spans_jsonl(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
