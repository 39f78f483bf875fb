"""A segment of a Program captured as a CUDA graph: the port's counterpart
of the JAX executor's `jax.jit` of a segment (paddle_tpu/framework/
executor.py:_compile_segment, :451).  XLA traces a segment once and
dispatches the compiled computation; here the segment's ops are recorded
once into a `torch.cuda.CUDAGraph` and the graph is replayed, so a call
costs one graph launch and the copies of its host feeds, not one Python
dispatch per op.

A call's signature is each argument's shape and dtype (and strides).
The first call of a signature runs the ops eagerly, on a side stream as
torch requires of a warm-up: it builds the kernels (`ops/cuda/_build.py`
runs nvcc and dlopen, which no capture may contain) and sets up cuBLAS's
workspaces.  A signature seen once is never captured (a prefill of a new
length).  The second call captures the graph, then replays it; later
calls replay.  Each argument of the capture is either
  - "bound": a tensor on the card that lies where the warm-up found it
    (the scope's parameters, a serving pool's streams, a Generator's
    caches, a Scheduler's slot stacks), read and written where it lies.
    The graph keeps its `data_ptr()` and replays only while every bound
    argument is still there, so a graph writing into a stale pool cannot
    happen: when such a storage moves, the segment is warmed up and
    captured again over the new one, and that graph replaces the old;
  - "copied": a host value (a CPU tensor), copied at every call into the
    graph's own device buffer through a pinned host buffer,
    `non_blocking`; or a tensor on the card that moved between the two
    calls (a new tensor every call), copied on the card.

Outputs are copied out of the graph's memory before a call returns
(`clone`), except an output that is a bound input written in place (a
pool stream comes back as the caller's own tensor).  A donated input (a
persistable the segment overwrites) gets its new value copied into its
own storage inside the graph, so a parameter keeps its address.

A segment that holds a stateful op (dropout) is called with the run's
`torch.Generator`, which its graph registers
(`CUDAGraph.register_generator_state`).  At every replay torch copies the
generator's current seed and offset into the graph and advances the
offset by what the graph draws, so the caller reseeds the generator
before a call and the replay draws what an eager run from that seed
would.  A draw from a generator the graph did not register fails the
capture (torch asserts), and that failure names the segment.

Python does not run during a replay, so the capture records the change
of every kernel launch counter (`launches`, `*_launches` of the modules in
`ops/cuda/`) and of `attention_ops.TIER_CALLS`, and every replay adds it:
a replayed call counts what an eager one would.

There is no fallback: a capture that fails raises, naming the op that
was running, and nothing is retried eagerly.

Threads.  Several threads may each drive their own segments (one
Executor a thread, as `inference.Predictor.clone()` gives them).  Every
eager warm-up and every capture of the process runs under one lock
(`_LOCK`), so they share the side stream and torch's capture stream one
at a time, and no capture's counter delta can take in another thread's
counts.  A capture runs in the thread-local capture mode, so a CUDA call
that another thread makes meanwhile (a replay, an allocation, a copy to
the host) neither fails nor invalidates it.  Replays run concurrently
with each other and with a capture, on the caller's current stream; each
adds its counter delta to the shared counters and to `STATS` under the
lock.  (A kernel launched eagerly outside the jit path in another
thread while a capture runs would still be counted into that capture's
delta: no path of the port does that.)
"""

from __future__ import annotations

import threading
import time

import torch

# captures, the seconds spent in them and the bytes the caching allocator
# reserved during them (the graph pools' growth), replays and eager
# warm-ups, over every CapturedSegment of the process (chip_smoke.py reads
# and resets it)
STATS = {"captures": 0, "capture_s": 0.0, "pool_bytes": 0, "replays": 0,
         "warmups": 0}

_SIDE_STREAMS = {}
# held by every warm-up and capture, and around each replay's counter update
_LOCK = threading.RLock()


def reset_stats():
    STATS.update(captures=0, capture_s=0.0, pool_bytes=0, replays=0,
                 warmups=0)


def _side_stream(device):
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


def _counter_modules():
    from ..ops import attention_ops
    from ..ops.cuda import (bn_relu_conv1x1, flash_attention, flash_decode,
                            flash_decode_paged, mha_block)

    mods = (bn_relu_conv1x1, flash_attention, flash_decode,
            flash_decode_paged, mha_block)
    return mods, attention_ops.TIER_CALLS


def _counters():
    """Every launch counter and the attention tier counts, as one dict."""
    mods, tiers = _counter_modules()
    snap = {(m, a): getattr(m, a) for m in mods for a in vars(m)
            if a.endswith("launches") and isinstance(getattr(m, a), int)}
    snap.update({("tier", k): v for k, v in tiers.items()})
    return snap


def _add_counters(delta):
    _, tiers = _counter_modules()
    for (owner, name), d in delta:
        if owner == "tier":
            tiers[name] += d
        else:
            setattr(owner, name, getattr(owner, name) + d)


def _arg_sig(a):
    if a.device.type == "cuda":
        return ("d", a.data_ptr(), tuple(a.shape), a.stride(), a.dtype)
    return ("h", tuple(a.shape), a.dtype)


class _Graph:
    """One captured signature: the graph, the addresses of its bound
    arguments, its device (and, for host values, pinned) buffers for the
    copied ones, its outputs and the counter delta."""

    __slots__ = ("graph", "bound", "copied", "outs", "alias", "delta", "h2d")

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.bound = ()      # (arg index, data_ptr)
        self.copied = []     # (arg index, device buffer, pinned or None)
        self.outs = ()
        self.alias = ()      # out index -> bound arg index, or None
        self.delta = ()
        self.h2d = None      # event after the last call's host copies

    def matches(self, sig):
        return all(sig[i][1] == ptr for i, ptr in self.bound)


class CapturedSegment:
    """fn(rng, *args) -> tuple of outputs, run on the card as described in
    the module docstring.  `donate` holds 1-based argument positions (the
    JAX package's donate_argnums, after the rng); `pool` is a
    `torch.cuda.graph_pool_handle()` shared with the owner's other graphs
    (None: a private pool a graph); `where` is the dict the segment
    function writes its running op into; `label` names the segment in
    errors.  `rng`, the generator a stateful segment draws from, is None
    for one that draws nothing."""

    def __init__(self, fn, in_names, out_names, device, donate=(), pool=None,
                 where=None, label=""):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.where = {} if where is None else where
        self.label = label
        out_pos = {n: i for i, n in enumerate(out_names)}
        # (arg index, out index) of each donated input the segment writes
        self.donate = [(i - 1, out_pos[in_names[i - 1]])
                       for i in donate if in_names[i - 1] in out_pos]
        # signature without addresses -> the _Graph captured for it, or
        # the full signature of its eager warm-up call
        self._graphs = {}
        self._seen = {}

    def __call__(self, rng, *args):
        sig = tuple(_arg_sig(a) for a in args)
        shape_key = tuple(s if s[0] == "h" else s[2:] for s in sig)
        graph = self._graphs.get(shape_key)
        if graph is not None and graph.matches(sig):
            return self._replay(graph, args)
        with _LOCK:
            seen = self._seen.pop(shape_key, None)
            if seen is None:
                self._seen[shape_key] = sig
                return self._warm_up(args, rng)
            # a tensor on the card found where the warm-up found it is
            # bound; one that moved since (a new tensor every call) is
            # copied
            bound = [i for i, (a, b) in enumerate(zip(sig, seen))
                     if a[0] == "d" and a[1] == b[1]]
            graph = self._graphs[shape_key] = self._capture(args, bound,
                                                            rng)
        return self._outputs(graph, args)

    # -- the three kinds of call ------------------------------------------

    def _run(self, args, rng):
        outs = list(self.fn(rng, *args))
        for i, o in self.donate:
            if outs[o] is not args[i]:
                args[i].copy_(outs[o])
                outs[o] = args[i]
        return outs

    def _warm_up(self, args, rng):
        STATS["warmups"] += 1
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            args = [a if a.device.type == "cuda" else a.to(self.device)
                    for a in args]
            outs = self._run(args, rng)
        cur.wait_stream(side)
        for o in outs:
            if isinstance(o, torch.Tensor) and o.device.type == "cuda":
                o.record_stream(cur)
        return tuple(outs)

    def _capture(self, args, bound, rng):
        t0 = time.perf_counter()
        # torch.cuda.graph releases the allocator's cache before it
        # records; release it first, so that the growth of the reserved
        # bytes over the capture is what the graph pool took
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_stats(self.device).get(
            "reserved_bytes.all.current", 0)
        g = _Graph()
        if rng is not None:
            g.graph.register_generator_state(rng)
        g.bound = tuple((i, args[i].data_ptr()) for i in bound)
        staged = list(args)
        for i, a in enumerate(args):
            if i not in bound:
                buf = torch.empty(a.shape, dtype=a.dtype, device=self.device)
                pinned = (None if a.device.type == "cuda" else
                          torch.empty(a.shape, dtype=a.dtype, pin_memory=True))
                g.copied.append((i, buf, pinned))
                staged[i] = buf
        self._stage(g, args)
        before = _counters()
        try:
            with torch.cuda.graph(g.graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                outs = self._run(staged, rng)
        except Exception as e:
            op = self.where.get("op")
            raise RuntimeError(
                f"CUDA graph capture of segment {self.label} failed"
                + (f" at op {op[0]} ({op[1]})" if op else "")
                + f": {e}") from e
        after = _counters()
        g.delta = tuple((k, after[k] - before.get(k, 0)) for k in after
                        if after[k] != before.get(k, 0))
        g.outs = tuple(outs)
        by_id = {id(args[i]): i for i in bound}
        g.alias = tuple(by_id.get(id(o)) for o in outs)
        g.graph.replay()
        STATS["captures"] += 1
        STATS["capture_s"] += time.perf_counter() - t0
        STATS["pool_bytes"] += torch.cuda.memory_stats(self.device).get(
            "reserved_bytes.all.current", 0) - reserved
        return g

    def _replay(self, g, args):
        self._stage(g, args)
        g.graph.replay()
        with _LOCK:
            _add_counters(g.delta)
            STATS["replays"] += 1
        return self._outputs(g, args)

    # -- helpers -----------------------------------------------------------

    def _stage(self, g, args):
        """Copy this call's copied arguments into the graph's buffers: a
        host value into the pinned buffer once the previous call's copy out
        of it is done, then to the card, non_blocking; a tensor on the
        card directly."""
        if not g.copied:
            return
        if g.h2d is not None:
            g.h2d.synchronize()
        for i, buf, pinned in g.copied:
            if pinned is None:
                buf.copy_(args[i])
                continue
            pinned.copy_(args[i])
            buf.copy_(pinned, non_blocking=True)
        if g.h2d is None:
            g.h2d = torch.cuda.Event()
        g.h2d.record(torch.cuda.current_stream(self.device))

    def _outputs(self, g, args):
        return tuple(args[a] if a is not None else o.clone()
                     for o, a in zip(g.outs, g.alias))
