"""Where one call of the decode kernels (#6 flash_decode, #7
flash_decode_paged) spends its time: the wrapper on the host against the
work on the card.

For each case (chip_smoke.py [3]'s shapes of #6 and #7, and #7 at the
Scheduler's phase-S lengths), with the 50 MB L2 cache flushed (through a
256 MiB buffer) before every call, it prints one JSON line:

  event_us     CUDA events around the call, median of --reps: what a
               caller waits;
  device_us    the card's time in the operations the call launched
               (torch.profiler), per call;
  kernels      those operations by name, launches per call;
  host_us      the host's time to issue one call (perf_counter over
               --reps calls, no synchronisation in between);
  flush_us     the flush's own device time (--flush write: a memset,
               as chip_smoke.py times, which leaves the L2 full of dirty
               lines that the call then writes back; --flush read: a sum
               over the buffer, which leaves it clean).  The card waits
               for the host when host_us > flush_us, so event_us is about
               device_us + max(0, host_us - flush_us);
  host_spans   the host operations inside one profiled call (aten ops,
               CUDA runtime calls), microseconds each.

A first line gives the host time of pieces of the launch path (the
stream lookup, the output allocation).

It takes only the wrappers' public calls, so it also runs on a checkout
from before the cluster kernels: two commits compared on one card.

    python -m paddle_tpu_torch.tools.decode_trace [--reps N]
        [--flush write|read]

It runs on the card only and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..ops.cuda import flash_decode as fd
from ..ops.cuda import flash_decode_paged as fdp

SEED = 2024
B, H, D = 8, 8, 64             # transformer-base serving: 8 heads of 64
POOL, BLOCK, REACH = 2560, 16, 4096   # the Scheduler's default pool


def _inputs(kind, dtype, lens, device):
    rng = np.random.RandomState(SEED)
    g = torch.Generator(device=device).manual_seed(SEED)
    lengths = torch.as_tensor(rng.randint(lens[0], lens[1] + 1, size=B),
                              device=device)
    if kind == "paged":
        q = torch.randn((B, 1, H * D), generator=g, device=device).to(dtype)
        kb, vb = (torch.randn((POOL, BLOCK, H * D), generator=g,
                              device=device).to(dtype) for _ in range(2))
        m = REACH // BLOCK
        table = torch.as_tensor(rng.permutation(POOL)[:B * m].reshape(B, m),
                                device=device)
        return lambda: fdp.flash_decode_paged(q, kb, vb, table, lengths, H)
    q, k, v = (torch.randn((B, s, H * D), generator=g, device=device)
               .to(dtype) for s in (1, 2048, 2048))
    return lambda: fd.flash_decode(q, k, v, H, kv_len=lengths)


CASES = (  # (name, kind, dtype, lengths)
    ("paged f32", "paged", torch.float32, (1024, REACH)),
    ("paged bf16", "paged", torch.bfloat16, (1024, REACH)),
    ("paged S f32", "paged", torch.float32, (1024, 2080)),
    ("paged S bf16", "paged", torch.bfloat16, (1024, 2080)),
    ("dense f32", "dense", torch.float32, (512, 1056)),
    ("dense bf16", "dense", torch.bfloat16, (512, 1056)),
)


def _device_ops(prof, skip=()):
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA and e.name not in skip]


def measure(fn, flush, reps):
    """The numbers of one case; `flush()` empties the L2 cache."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush()
        torch.cuda.synchronize()
    flush_ops = _device_ops(prof)
    flush_names = {n for n, _ in flush_ops}
    pairs = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    event_us = statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    ops = _device_ops(prof, flush_names)
    kernels = collections.Counter(n for n, _ in ops)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):   # the last call, past the profiler's warm-up
            with record_function(f"wrapper call {i}"):
                fn()
            torch.cuda.synchronize()
    host = [e for e in prof.events() if getattr(e, "device_type", None)
            != torch.autograd.DeviceType.CUDA]
    last = next(e.time_range for e in host if e.name == "wrapper call 2")
    spans = [(e.name, round(e.time_range.end - e.time_range.start, 1))
             for e in host if last.start <= e.time_range.start < last.end]
    return {"event_us": event_us,
            "device_us": sum(t for _, t in ops) / reps,
            "kernels": {n[:60]: c / reps for n, c in kernels.items()},
            "host_us": host_us,
            "flush_us": sum(t for _, t in flush_ops),
            "host_spans": spans}


def host_parts(device, reps=2000):
    """Host microseconds a call of the pieces of a wrapper's launch path:
    the stream lookup (public API, and the raw handle where this torch has
    it) and the output allocation."""
    def each(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    parts = {
        "current_stream": each(
            lambda: torch.cuda.current_stream(device).cuda_stream),
        "empty": each(lambda: torch.empty((B, 1, H * D), device=device)),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        parts["raw_stream"] = each(lambda: raw(device.index))
    return parts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decode_trace: no CUDA device")
    device = torch.device("cuda", 0)
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device=device)
    flush = (buf.zero_ if args.flush == "write"
             else buf.view(torch.float32).sum)
    print(json.dumps({"host_parts_us": host_parts(device)}), flush=True)
    for name, kind, dtype, lens in CASES:
        res = {"case": name, "lengths": list(lens), "flush": args.flush,
               **measure(_inputs(kind, dtype, lens, device), flush,
                         args.reps)}
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
