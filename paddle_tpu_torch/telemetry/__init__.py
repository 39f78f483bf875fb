"""Telemetry: the metrics registry, cross-process trace spans and
chrome-trace export (counterpart of paddle_tpu/telemetry, with the same
instrument names, so a STATUS scrape of either package's server reads
alike):

  * `registry` — process-wide thread-safe counters / gauges / bucketed
    histograms named like ``serving.step_ms`` or ``rpc.retries``, with
    snapshot-to-dict and bench-style JSONL export;
  * `tracing`  — trace-id/span-id spans whose context rides the RPC
    frame headers, so one request's spans stitch across client ->
    handler -> scheduler, with one child span per retry attempt in
    `resilience.ResilientChannel`;
  * `export`   — chrome-trace JSON merging telemetry spans with host op
    spans, plus span JSONL round-trip for multi-process merges.

Overhead discipline: everything is gated on one module-level bool —
``enabled()`` — flipped by `enable()`/`disable()` (initial state from the
``telemetry`` flag / PADDLE_TPU_TELEMETRY).  Disabled instruments return
before touching a lock or allocating.  The cost when enabled is host
time, measured on the card by chip_smoke.py's telemetry-tax leg.
"""

from __future__ import annotations

from . import export, registry, tracing
from .export import chrome_trace, read_spans_jsonl, write_chrome_trace, \
    write_spans_jsonl
from .registry import counter, disable, enable, enabled, gauge, histogram, \
    reset_metrics, snapshot, write_snapshot, write_snapshot_jsonl
from .tracing import attach, current_context, reset_spans, span, spans, \
    start_span, wire_context

__all__ = [
    "registry", "tracing", "export",
    # registry surface
    "counter", "gauge", "histogram", "snapshot", "write_snapshot",
    "write_snapshot_jsonl", "reset_metrics", "enable", "disable", "enabled",
    # tracing surface
    "span", "start_span", "attach", "current_context", "wire_context",
    "spans", "reset_spans",
    # export surface
    "chrome_trace", "write_chrome_trace", "write_spans_jsonl",
    "read_spans_jsonl",
]
