"""Which CUDA calls invalidate a CUDA graph capture in progress, on the
card's torch: the facts `framework/cuda_graph.py` ("Threads") rests on.

Each case captures `b = a @ a; <event>; c = b @ a` on a side stream in
the thread-local capture mode (as `CapturedSegment` captures) and runs in
a process of its own, since an invalidated capture can leave the
process's CUDA state unusable.  Cases:

  gc_graph           the cycle collector destroys another CUDA graph in
                     the capturing thread (`gc.collect()` inside the
                     capture);
  gc_off_graph       the same garbage, the collector off over a capture
                     that allocates past every threshold;
  gc_pinned          ... a pinned host buffer a non_blocking copy read;
  gc_event           ... a recorded torch.cuda.Event;
  other_graph_del    another thread drops the last reference to a graph;
  other_sync         another thread calls torch.cuda.synchronize();
  other_stream_sync  ... its current stream's synchronize();
  other_empty_cache  ... frees a block and calls torch.cuda.empty_cache();
  other_cpu          ... reads a card value back (.item());
  other_event_sync   ... records an event and waits for it.

A line a case: its exit code and the last error line, or "capture ok".

    python -m paddle_tpu_torch.tools.capture_probe [case ...]
"""

from __future__ import annotations

import gc
import subprocess
import sys
import threading

import torch

CASES = ("gc_graph", "gc_off_graph", "gc_pinned", "gc_event",
         "other_graph_del", "other_sync", "other_stream_sync",
         "other_empty_cache", "other_cpu", "other_event_sync")


def _capture(body):
    a = torch.randn(256, 256, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        (a @ a).sum()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        b = a @ a
        body()
        b @ a
    g.replay()
    torch.cuda.synchronize()


def _graph_in_a_cycle():
    """A captured and replayed graph that only a collection frees."""
    x = torch.randn(64, 64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x @ x
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        y = x @ x
    g.replay()
    torch.cuda.synchronize()
    holder = {"graph": g, "out": y}
    holder["self"] = holder
    return holder


def _garbage(name):
    if name in ("gc_graph", "gc_off_graph"):
        _graph_in_a_cycle()
    elif name == "gc_pinned":
        pinned = torch.empty(1 << 20, pin_memory=True)
        torch.empty(1 << 20, device="cuda").copy_(pinned, non_blocking=True)
        holder = {"pinned": pinned}
        holder["self"] = holder
    else:
        event = torch.cuda.Event()
        event.record()
        holder = {"event": event}
        holder["self"] = holder


def _in_other_thread(name):
    def event():
        if name == "other_sync":
            torch.cuda.synchronize()
        elif name == "other_stream_sync":
            torch.ones(4, device="cuda").sum()
            torch.cuda.current_stream().synchronize()
        elif name == "other_empty_cache":
            block = torch.empty(64 << 20, device="cuda")
            del block
            torch.cuda.empty_cache()
        elif name == "other_cpu":
            torch.ones(4, device="cuda").sum().item()
        elif name == "other_event_sync":
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        else:
            graphs.clear()

    graphs = ([_graph_in_a_cycle()["graph"]] if name == "other_graph_del"
              else [])
    started, done, errors = threading.Event(), threading.Event(), []

    def other():
        started.wait()
        try:
            event()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e)[:200])
        done.set()

    t = threading.Thread(target=other)
    t.start()

    def body():
        started.set()
        done.wait(10)

    try:
        _capture(body)
    finally:
        t.join()
        if errors:
            print("  other thread:", errors)


def run_case(name):
    if name.startswith("other_"):
        _in_other_thread(name)
    else:
        _garbage(name)
        gc.disable()
        if name == "gc_off_graph":
            _capture(lambda: [[] for _ in range(100000)])
        else:
            _capture(gc.collect)
        gc.enable()
    print("  capture ok")


def main(argv):
    if len(argv) == 2 and argv[1] == "--child":
        run_case(argv[0])
        return 0
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    for name in argv or CASES:
        r = subprocess.run([sys.executable, __file__, name, "--child"],
                           capture_output=True, text=True, timeout=120)
        lines = (r.stdout + r.stderr).strip().splitlines()
        tail = [ln for ln in lines if "Error" in ln][-1:] + lines[-1:]
        print(name, "rc", r.returncode, " | ".join(tail)[:400], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
