"""Continuous-batching scheduler over the paged KV pool: the multi-tenant
serving core (counterpart of paddle_tpu/serving/scheduler.py).

One decode loop serves every tenant.  Each iteration either ADMITS a group
of waiting requests (one batched prefill, deadline-aware flush) or runs ONE
decode step over the active set, padded up to a shape bucket (1, 2, 4, ...,
max_batch) by replicating row 0.  Requests join and leave at step
granularity: a request admitted mid-flight decodes its next token in the
step after its prefill, and a finished row's slot is free for the next
admission.

KV storage is the block-granular pool shared by every request, not a dense
`[1, max_len]` buffer per request: a request owns a block table covering
[0, cursor).  Two decode paths, the JAX package's:

  * dense (the default): a host `BlockPool`; each step gathers every
    table back into the dense [bucket, max_len] layout the step program
    feeds (zeros past the cursor, which the SeqLen mask never reads) and
    scatters the one newly-written row back;
  * paged (`paged_kv=True` or the `serving_paged_kv` flag): a
    `DeviceBlockPool` on the serving device, and the step program
    rewritten by serving/paged.py, which appends into the pool in place
    (kv_cache_append_paged) and attends through the block tables
    (flash_decode_paged on the card) — no per-step gather, no per-step
    cache upload.

Identical prompts share their prefix chain through the pool's refcounted
prefix cache (copy-on-write on the partial tail block), and pool pressure
preempts the lowest-priority request: its blocks are evicted and the
request is later REPLAYED (prefill, then teacher-forcing its own recorded
tokens), which rebuilds the same cache.

Three paths of the JAX package ride the paged pool:

  * speculative decoding (`spec_decode`): a draft spec
    (models/transformer.build_draft) proposes spec_k - 1 tokens in
    batched single-token steps over the pool's "draft:" streams, and ONE
    Sq = spec_k verify launch of the target checks them; each row emits
    the longest prefix the target agrees with, 1 to spec_k tokens a
    round, each of them the target's own argmax;
  * chunked prefill (`prefill_chunk`): a prompt longer than one chunk
    never runs a monolithic prefill.  It runs Sq = chunk ramp windows, one
    per loop iteration interleaved with the decode steps, so a long
    arrival stalls the streams already decoding by one chunk at most;
  * the two-tier handoff: `submit(prefill_only=True)` runs the prompt,
    emits the first token and retires "prefilled" with a handoff record
    (its KV rows included); another Scheduler, of any block size, resumes
    it with `submit(kv_payload=..., recorded_tokens=...)`.

Parity contract: greedy tokens equal sequential `Generator.generate()`
for the same prompts.  The JAX package holds this bitwise on the CPU, where
XLA computes a row the same way at any batch size; the port's attention
kernels and lowerings are row-wise too, and whether the card's GEMMs are
batch-invariant is what chip_smoke.py's serving phase checks (ROADMAP.md
C4).

A verify window and a chunk window compute their rows with other
summation orders than the sequential Generator's steps and prefill (a
composite ramp attention, wider matmuls); the token contract is held by
tests and by chip_smoke.py, as for batching.

Each Scheduler runs on one device: the card unless it is given
`place=CPUPlace()`, as `decode.Generator`.  Steps run under
`torch.inference_mode()`.

Overload control (`admission=True` or the `serving_admission` flag):
`submit` prices the request against the backlog with
serving/overload.py's estimators and raises AdmissionRejected before any
block is allocated; every iteration feeds the brownout ladder the queue
depth.  The estimators read host wall time around a step or a prefill,
and on the card a launch returns before the card is done: every such
window here ends on a read-back of the card's result (the step's argmax,
the prefill's first token, or a synchronize where there is none), so it
covers the card's work.

Telemetry (the `telemetry` flag, or `telemetry.enable()`): the JAX
Scheduler's instruments under the same names, at the same sites
(`serving.*` histograms, counters and gauges, and one "serving.request"
span a request, a child of the submitter's current span).
"""

from __future__ import annotations

import base64
import collections
import hashlib
import itertools
import threading
import time

import numpy as np
import torch

from ..framework import cuda_graph
from ..ops.kv_cache import BlockPool, DeviceBlockPool, PoolExhausted
from ..telemetry import registry as _telem
from ..telemetry import tracing as _tracing
from .overload import PRIORITIES, AdmissionRejected, OverloadControl
from .paged import BLOCK_TABLE_VAR, build_paged_step

__all__ = ["Scheduler", "ServedRequest", "SchedulerDraining", "prompt_key",
           "encode_feed", "decode_feed"]

# request-id retention: terminal requests stay resolvable this many
# submissions back, so a resubmit after a transport fault attaches to the
# original generation instead of decoding twice.  Live requests are never
# evicted from the map.
_RID_RETAIN = 4096

_H_STEP_MS = _telem.histogram("serving.step_ms")
_H_BUCKET_FILL = _telem.histogram(
    "serving.bucket_fill", bounds=tuple(i / 16 for i in range(1, 17)))
_G_QUEUE = _telem.gauge("serving.queue_depth")
_G_ACTIVE = _telem.gauge("serving.active")
# the wait queue sampled once per scheduler step: the gauge holds only the
# latest value, so scrapes read mean/p99 occupancy from here
_H_QUEUE_DEPTH = _telem.histogram("serving.queue_depth_per_step")
_C_SUBMITTED = _telem.counter("serving.submitted")
_C_ADMISSIONS = _telem.counter("serving.admissions")
_C_EVICTIONS = _telem.counter("serving.evictions")
_C_STEPS = _telem.counter("serving.steps")
_C_REPLAYS = _telem.counter("serving.replays")
# speculative decoding: proposals made and accepted, the per-row
# acceptance rate and the tokens a row emits a round
_C_SPEC_PROPOSED = _telem.counter("serving.spec_proposed")
_C_SPEC_ACCEPTED = _telem.counter("serving.spec_accepted")
_H_SPEC_ACCEPT = _telem.histogram(
    "serving.spec_accept_rate", bounds=tuple(i / 8 for i in range(1, 9)))
_H_TOKENS_PER_STEP = _telem.histogram(
    "serving.tokens_per_step", bounds=(1, 2, 3, 4, 6, 8, 12, 16))
# time to first token per request (submit -> first emit) and each chunked
# prefill pass's wall time
_H_TTFT = _telem.histogram("serving.ttft_ms")
_H_CHUNK_MS = _telem.histogram("serving.prefill_chunk_ms")

# "prefilled" is the prefill tier's terminal: prompt processed, first
# token emitted, the handoff record parked on req.handoff
_STATUS_DONE = ("done", "expired", "cancelled", "error", "prefilled")


class SchedulerDraining(RuntimeError):
    """submit() refused because the scheduler is draining: in-flight work
    finishes, new work must go to another replica."""


def prompt_key(feed, eos_id=None, bos_id=None):
    """Stable prompt-prefix key: every prefill/step feed byte plus the plan
    identity (trace-affecting flags), so two requests collide only when
    their prefill is the same computation.  Process-stable (blake2b, not
    Python's salted ``hash()``)."""
    from .. import flags

    h = hashlib.blake2b(digest_size=8)
    for name in sorted(feed):
        v = np.asarray(feed[name])
        h.update(name.encode("utf-8"))
        h.update(v.dtype.str.encode("ascii"))
        h.update(repr(v.shape).encode("ascii"))
        h.update(v.tobytes())
    h.update(repr(flags.trace_signature()).encode("utf-8"))
    h.update(repr((eos_id, bos_id)).encode("ascii"))
    return int.from_bytes(h.digest(), "little")


def encode_feed(feed):
    """JSON-safe exact encoding of a feed dict (export/import of in-flight
    requests across replicas)."""
    return {name: {"dtype": np.asarray(v).dtype.str,
                   "shape": list(np.asarray(v).shape),
                   "b64": base64.b64encode(
                       np.ascontiguousarray(v).tobytes()).decode("ascii")}
            for name, v in feed.items()}


def decode_feed(enc):
    return {name: np.frombuffer(
        base64.b64decode(rec["b64"]),
        dtype=np.dtype(rec["dtype"])).reshape(rec["shape"]).copy()
        for name, rec in enc.items()}


def _stack(rows, pad):
    """Stack per-request numpy rows and pad the batch to its bucket by
    repeating row 0."""
    out = np.stack(rows)
    return np.concatenate([out, np.repeat(out[:1], pad, 0)]) if pad else out


def _argmax(logits, n):
    """Greedy tokens of the first n rows, as int64 numpy."""
    return torch.argmax(logits, dim=-1).reshape(-1)[:n].cpu().numpy() \
        .astype(np.int64)


class ServedRequest:
    """Handle for one submitted generation.

    status: queued -> running -> done | expired | cancelled | error, or
    "prefilled" for a prefill_only request (preemption and replay are
    invisible here: a preempted request is still "running").  Tokens
    stream into `tokens` as they decode; `stream()` yields them live,
    `result()` blocks until terminal."""

    _ids = itertools.count()

    def __init__(self, feed, max_new_tokens, deadline=None, on_token=None,
                 eos_id=None, bos_id=None, request_id=None,
                 priority="interactive", prefill_only=False):
        self.rid = next(ServedRequest._ids)
        self.request_id = request_id  # caller-chosen idempotency key
        self.feed = feed            # {name: np [1, ...]} prefill feeds
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline    # absolute time.monotonic() or None
        self.priority = priority    # "interactive" | "batch"
        self.on_token = on_token
        self.eos_id = eos_id
        self.bos_id = bos_id
        self.status = "queued"
        self.error = None
        self.tokens = []            # ints, as decoded
        # prefill tier: run the prompt, emit the first token, then retire
        # "prefilled" with the handoff record on `handoff`
        self.prefill_only = bool(prefill_only)
        self.handoff = None
        self.submit_t = time.monotonic()
        self.first_token_t = None
        self.finish_t = None
        self._cond = threading.Condition()
        # scheduler-private decode state
        self._blocks = []           # pool block table
        self._cursor = 0            # KV write cursor (= lengths feed)
        self._last_tok = None
        self._states = {}           # non-paged per-request state rows
        self._prefix_rows = 0
        self._prefix_key = None
        self._needs_replay = False  # blocks evicted; rebuild via replay
        # chunked prefill: prompt tokens processed so far (the partial
        # chain is _blocks; eviction or export re-chunks from 0)
        self._chunk_pos = 0
        self._kv_payload = None     # handoff payload, adopted at admission
        # speculative decoding: the draft's constant states, and how many
        # KV rows the draft chain trails the target cursor (0 or 1: after
        # a fully accepted window the draft has not yet consumed the last
        # accepted token, _draft_gap, which it teacher-forces next round)
        self._draft_states = {}
        self._draft_lag = 0
        self._draft_gap = None
        self._ttft_sink = None      # scheduler's TTFT observer
        self._cancel_flag = False
        self._span = None           # telemetry request span
        # bumps per attached RPC streamer: a handler whose connection died
        # cancels only if no newer handler re-attached (the idempotent
        # resubmit's race guard)
        self._stream_gen = 0

    # -- caller-facing ----------------------------------------------------

    @property
    def done(self):
        return self.status in _STATUS_DONE

    def cancel(self):
        """Ask the scheduler to drop this request at the next step
        boundary (frees its blocks); no-op once terminal."""
        with self._cond:
            self._cancel_flag = True
            self._cond.notify_all()

    def result(self, timeout=None):
        """Block until terminal; returns the tokens as int64 [T].  Check
        `status` to tell done/expired/cancelled apart; `error` carries the
        traceback string for status == "error"."""
        with self._cond:
            if not self._cond.wait_for(lambda: self.done, timeout):
                raise TimeoutError(
                    f"request {self.rid} not finished in {timeout}s")
            return np.asarray(self.tokens, np.int64)

    def stream(self, timeout=None):
        """Yield tokens as they decode; returns when terminal."""
        seen = 0
        while True:
            with self._cond:
                if not self._cond.wait_for(
                        lambda: len(self.tokens) > seen or self.done,
                        timeout):
                    raise TimeoutError(
                        f"request {self.rid}: no token in {timeout}s")
                chunk = self.tokens[seen:]
                terminal = self.done
            yield from chunk
            seen += len(chunk)
            if terminal and seen >= len(self.tokens):
                return

    def latency(self):
        return None if self.finish_t is None else \
            self.finish_t - self.submit_t

    # -- scheduler-side ----------------------------------------------------

    def _emit(self, tok):
        first = False
        with self._cond:
            if self.first_token_t is None:
                self.first_token_t = time.monotonic()
                first = True
            self.tokens.append(int(tok))
            self._cond.notify_all()
        if first and self._ttft_sink is not None:
            self._ttft_sink((self.first_token_t - self.submit_t) * 1e3)
        if self.on_token is not None:
            self.on_token(int(tok))

    def _finish(self, status, error=None):
        with self._cond:
            self.status = status
            self.error = error
            self.finish_t = time.monotonic()
            self._cond.notify_all()


class Scheduler:
    """Continuous-batching serving loop for one GenerationSpec.

        sched = Scheduler(spec, scope=scope).start()
        h = sched.submit(feed, max_new_tokens=32, deadline_ms=500)
        for tok in h.stream(): ...

    Greedy decoding only.  `scope` follows the Generator contract (a
    trained program's scope, or None for fresh weights); `place` is the
    device (the card unless `CPUPlace()`).  Drive the loop either with
    `start()` (background thread) or by calling `step()` yourself (tests,
    benches: fully deterministic)."""

    def __init__(self, spec, scope=None, place=None, max_batch=None,
                 block_size=None, num_blocks=None, flush_deadline_ms=None,
                 prefix_cache=True, admission=None, paged_kv=None,
                 spec_decode=None, spec_k=None, draft_spec=None,
                 draft_scope=None, prefill_chunk=None):
        from .. import flags
        from ..decode import Generator

        self.spec = spec
        if spec.max_len is None:
            raise ValueError("serving needs spec.max_len (KV pool bound)")
        self._gen = Generator(spec, scope=scope, place=place)
        self.device = self._gen.device
        self.max_batch = int(flags.get("serving_max_batch")
                             if max_batch is None else max_batch)
        self.block_size = int(flags.get("kv_block_size")
                              if block_size is None else block_size)
        self.paged_kv = bool(flags.get("serving_paged_kv")
                             if paged_kv is None else paged_kv)
        self.flush_deadline = (
            flags.get("serving_flush_deadline_ms")
            if flush_deadline_ms is None else flush_deadline_ms) / 1e3
        # overload control (admission gate + brownout ladder): opt-in, as
        # admission changes which requests exist
        if admission is None:
            admission = flags.get("serving_admission")
        self._overload = OverloadControl(self.max_batch) if admission \
            else None
        bpseq = -(-int(spec.max_len) // self.block_size)
        if num_blocks is None:
            # every slot can hold a full sequence, plus prefix-cache slack
            num_blocks = bpseq * (self.max_batch + 2)
        self.pool = (DeviceBlockPool(num_blocks, self.block_size,
                                     device=self.device) if self.paged_kv
                     else BlockPool(num_blocks, self.block_size))
        self._table_width = bpseq  # block-table columns per request
        self._paged_prog = None    # lazy build_paged_step rewrite
        self._paged_fns = {}       # (tag, feed sig, trace sig) -> fn
        # (tag, state, bucket) -> (stacked states, the rows stacked)
        self._stacks = {}
        self.prefix_cache = bool(prefix_cache)
        # state classification: paged = positional KV (pool-backed),
        # carried = dense per-step state (an RNN hidden), const = computed
        # once at prefill (encoder-side k/v)
        self._paged = [s for s in spec.states
                       if s.update and s.pad_to is not None]
        self._carried = [s for s in spec.states
                         if s.update and s.pad_to is None]
        self._const = [s for s in spec.states if not s.update]
        self._streams_ready = False
        self._init_spec_decode(spec_decode, spec_k, draft_spec, draft_scope,
                               place)
        self._init_chunking(prefill_chunk)
        # bucket ladder: 1, 2, 4, ... max_batch
        self._buckets = []
        b = 1
        while b < self.max_batch:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.max_batch)

        self._lock = threading.Lock()       # guards _waiting + counters
        self._step_lock = threading.Lock()  # one step() at a time
        self._work = threading.Event()
        self._waiting = []
        self._active = []
        self._preempted = []
        self._prefilling = []  # chunked prompts mid-prefill
        # rolling TTFT and chunk-pass samples for stats() percentiles
        self._ttft_samples = collections.deque(maxlen=1024)
        self._chunk_samples = collections.deque(maxlen=1024)
        self._thread = None
        self._stop = False
        self.draining = False
        # request-id -> ServedRequest, insertion-ordered so terminal
        # entries age out FIFO past _RID_RETAIN (live ones never evict)
        self._by_rid = collections.OrderedDict()
        self.counters = {
            "submitted": 0, "admitted": 0, "completed": 0, "expired": 0,
            "cancelled": 0, "errors": 0, "steps": 0, "prefills": 0,
            "prefill_batches": 0, "preemptions": 0, "replays": 0,
            "dedup_hits": 0, "imported": 0, "exported": 0,
            "peak_active": 0, "peak_occupancy": 0.0, "rejected": 0,
            "spec_rounds": 0, "draft_steps": 0, "spec_proposed": 0,
            "spec_accepted": 0, "spec_tokens": 0,
            "chunked": 0, "chunk_passes": 0, "handoffs": 0, "adopted": 0,
        }

    def _init_spec_decode(self, spec_decode, spec_k, draft_spec,
                          draft_scope, place):
        """Speculative decoding's checks and its draft Generator
        (scheduler.py:348-397 of the JAX package)."""
        from .. import flags
        from ..decode import Generator

        spec = self.spec
        self.spec_decode = bool(flags.get("serving_spec_decode")
                                if spec_decode is None else spec_decode)
        self.spec_k = int(flags.get("spec_k") if spec_k is None else spec_k)
        self._draft_spec = draft_spec
        self._draft_gen = None
        self._draft_prog = None    # lazy paged rewrite of the draft step
        self._verify_prog = None   # lazy paged rewrite of the verify window
        if not self.spec_decode:
            return
        if not self.paged_kv:
            raise ValueError("spec decode rides the paged KV path: pass "
                             "paged_kv=True (serving_paged_kv)")
        if self.spec_k < 2:
            raise ValueError("spec_k must be >= 2")
        if spec.verify_program is None or spec.verify_len is None:
            raise ValueError("spec decode needs a verify program: build the "
                             "spec with build_decode(..., verify_len="
                             "spec_k)")
        if int(spec.verify_len) != self.spec_k:
            raise ValueError(f"spec.verify_len={spec.verify_len} != "
                             f"spec_k={self.spec_k}")
        if draft_spec is None:
            raise ValueError("spec decode needs a draft spec "
                             "(models.transformer.build_draft)")
        if self._carried:
            # a dense carried state advanced k positions by the verify
            # window cannot be rolled back to the acceptance point; KV rows
            # past the cursor are dead by the SeqLen contract
            raise ValueError("spec decode requires KV-only state (no "
                             "carried dense states)")
        self._draft_gen = Generator(
            draft_spec, scope=self._gen.scope if draft_scope is None
            else draft_scope, place=place)
        self._draft_paged = [s for s in draft_spec.states
                             if s.update and s.pad_to is not None]
        self._draft_const = [s for s in draft_spec.states if not s.update]

    def _init_chunking(self, prefill_chunk):
        """Chunked prefill's checks (scheduler.py:409-444 of the JAX
        package)."""
        from .. import flags

        spec = self.spec
        self.prefill_chunk = int(flags.get("serving_prefill_chunk")
                                 if prefill_chunk is None else prefill_chunk)
        self._chunk_prog = None    # lazy paged rewrite of the chunk window
        if not self.prefill_chunk:
            return
        if not self.paged_kv:
            raise ValueError("chunked prefill rides the paged KV path: pass "
                             "paged_kv=True (serving_paged_kv)")
        if self.spec_decode:
            raise ValueError("chunked prefill + spec decode is unsupported: "
                             "the draft KV chain would never cover a "
                             "chunked prompt")
        if spec.chunk_program is None or spec.chunk_len is None:
            raise ValueError("chunked prefill needs a chunk program: build "
                             "the spec with build_decode(..., chunk_len="
                             f"{self.prefill_chunk})")
        if int(spec.chunk_len) != self.prefill_chunk:
            raise ValueError(f"spec.chunk_len={spec.chunk_len} != "
                             f"prefill_chunk={self.prefill_chunk}")
        if spec.prompt_ids_name is None or spec.init_lengths_from is None:
            raise ValueError("chunked prefill needs the spec's prompt feed "
                             "names (prompt_ids_name / init_lengths_from)")
        if self._carried:
            raise ValueError("chunked prefill requires KV-only state (a "
                             "dense carried state cannot skip the prefill "
                             "program)")
        if not all(s.encode_from for s in self._const):
            raise ValueError("chunked prefill needs every constant state "
                             "seeded by the encode program (encode_from "
                             "unset)")

    # -- submission --------------------------------------------------------

    def _observe_ttft(self, ms):
        if _telem._ENABLED:
            _H_TTFT.observe(ms)
        self._ttft_samples.append(ms)

    def submit(self, feed, max_new_tokens, deadline_ms=None, on_token=None,
               eos_id=None, bos_id=None, request_id=None,
               recorded_tokens=None, priority="interactive",
               prefill_only=False, kv_payload=None):
        """Enqueue one request.  `feed` holds the spec's prefill feeds (and
        any step_feeds constants) for a SINGLE sequence — batch-1 arrays or
        unbatched rows; shapes must match across requests (ragged lengths
        ride the spec's *_lens feeds).  deadline_ms is a hard completion
        deadline: a request past it finishes "expired" with whatever tokens
        it has.

        request_id makes the submit idempotent: a duplicate attaches to
        the original generation, live or recently terminal.
        recorded_tokens pre-loads a partially decoded generation's history
        (cross-replica failover): the request rides the evict-and-replay
        path, prefill plus teacher-forcing the recorded tokens, and then
        resumes decoding.

        priority ("interactive" | "batch"): batch work is evicted first
        under pool pressure, clamped and shed first under brownout.  With
        admission on, submit() raises AdmissionRejected (with a
        retry_after_ms hint) before any ServedRequest or KV block exists
        when the deadline is infeasible against the backlog or brownout
        sheds the class.  Continuations (recorded_tokens, kv_payload)
        bypass the gate: they were accepted once already.

        prefill_only=True is the prefill tier's mode: the request runs its
        prompt (chunked or not), emits the first token, then retires
        "prefilled" with a handoff record on `handle.handoff`: the
        export_requests record plus "cursor", "kv" (the KV rows, logical,
        as host arrays), "states", "last_tok" and "n_tokens".  kv_payload
        (that record's "cursor", "rows" = its "kv", "states", "last_tok"
        and "n_tokens") adopts the shipped rows into this pool at
        admission, re-blocked to this pool's block size, and
        teacher-forces any recorded token past the payload's coverage.  A
        spec-decode Scheduler replays instead: the payload has no draft
        chain."""
        if self.draining:
            raise SchedulerDraining(
                "scheduler is draining: submit refused (re-route)")
        if priority not in PRIORITIES:
            raise ValueError(f"priority {priority!r} not in {PRIORITIES}")
        if request_id is not None:
            with self._lock:
                prior = self._by_rid.get(request_id)
                if prior is not None:
                    if not prior.done:
                        # a disconnect-cancel not yet swept loses the race
                        # to the resubmit: revive and re-attach
                        prior._cancel_flag = False
                        self.counters["dedup_hits"] += 1
                        return prior
                    if prior.status != "cancelled":
                        self.counters["dedup_hits"] += 1
                        return prior
                    # the original was reaped before the resubmit landed:
                    # re-run it, teacher-forcing what it had decoded
                    if recorded_tokens is None and prior.tokens:
                        recorded_tokens = [int(t) for t in prior.tokens]
                    del self._by_rid[request_id]
        if self._overload is not None and recorded_tokens is None \
                and kv_payload is None:
            max_new_tokens = self._admit(feed, max_new_tokens, deadline_ms,
                                         eos_id, bos_id, priority)
        fixed = {}
        for name, v in feed.items():
            v = np.asarray(v)
            if name in self.spec.prefill_feeds or name in \
                    self.spec.step_feeds:
                rank = self._feed_rank(name)
                if v.ndim == 0 or (rank is not None and v.ndim == rank):
                    v = v[None]
                if v.shape[0] != 1:
                    raise ValueError(
                        f"feed {name!r}: expected one sequence, got "
                        f"leading dim {v.shape[0]}")
            fixed[name] = v
        deadline = None if deadline_ms is None else \
            time.monotonic() + deadline_ms / 1e3
        req = ServedRequest(fixed, max_new_tokens, deadline, on_token,
                            eos_id=eos_id, bos_id=bos_id,
                            request_id=request_id, priority=priority,
                            prefill_only=prefill_only)
        if recorded_tokens is None:
            # a fresh request's first emit IS its time to first token
            req._ttft_sink = self._observe_ttft
        else:
            req.tokens = [int(t) for t in recorded_tokens]
            req._needs_replay = bool(req.tokens)
        if kv_payload is not None and not self.spec_decode:
            # adoption replaces the replay: the shipped rows land in the
            # pool at admission, only the token tail past them is forced
            req._kv_payload = kv_payload
            req._needs_replay = False
        if _telem._ENABLED:
            # queue -> decode -> retirement, parented on the submitter's
            # current span (an RPC handler's "serving.submit")
            req._span = _tracing.start_span("serving.request", rid=req.rid)
            _C_SUBMITTED.inc()
        with self._lock:
            self._waiting.append(req)
            self.counters["submitted"] += 1
            if recorded_tokens:
                self.counters["imported"] += 1
            if request_id is not None:
                self._by_rid[request_id] = req
                while len(self._by_rid) > _RID_RETAIN:
                    for rid, old in self._by_rid.items():
                        if old.done:
                            del self._by_rid[rid]
                            break
                    else:
                        break
            if _telem._ENABLED:
                _G_QUEUE.set(len(self._waiting))
        self._work.set()
        return req

    def _admit(self, feed, max_new_tokens, deadline_ms, eos_id, bos_id,
               priority):
        """The feasibility gate (scheduler.py:562-591 of the JAX package):
        price the backlog and the prompt's tokens (about zero on a
        prefix-cache hit), then admit, clamp or raise AdmissionRejected,
        before the request exists, so a reject never allocates a block."""
        with self._lock:
            backlog = sum(
                max(0, r.max_new_tokens - len(r.tokens))
                for q in (self._waiting, self._active, self._preempted,
                          self._prefilling)
                for r in q)
        prompt_tokens = 1
        if self.spec.init_lengths_from is not None \
                and self.spec.init_lengths_from in feed:
            prompt_tokens = max(1, int(np.asarray(
                feed[self.spec.init_lengths_from]).reshape(-1)[0]))
        cached = bool(self.prefix_cache and self._streams_ready
                      and self.pool.has_prefix(
                          prompt_key(feed, eos_id, bos_id)))
        try:
            return self._overload.admit(
                priority, int(max_new_tokens), deadline_ms, backlog,
                prompt_tokens=prompt_tokens, cached=cached)
        except AdmissionRejected:
            with self._lock:
                self.counters["rejected"] += 1
            raise

    def _feed_rank(self, name):
        # per-sequence rank of a feed (without batch dim), from the spec's
        # program var shapes when known; None = trust the caller
        for prog in (self.spec.prefill_program, self.spec.step_program):
            var = prog.global_block().vars.get(name)
            if var is not None and getattr(var, "shape", None) is not None:
                return max(0, len(var.shape) - 1)
        return None

    # -- the loop ----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-sched")
        self._thread.start()
        return self

    def close(self, drain=False):
        """Stop the loop.  drain=True finishes in-flight work first;
        otherwise live requests are cancelled."""
        if self._thread is not None:
            if drain:
                self.run_until_idle()
            self._stop = True
            self._work.set()
            self._thread.join(timeout=30.0)
            self._thread = None
        for req in list(self._active) + list(self._preempted) \
                + list(self._waiting) + list(self._prefilling):
            self._retire(req, "cancelled")
        self._active, self._preempted, self._waiting = [], [], []
        self._prefilling = []

    def _run(self):
        while not self._stop:
            if not self.step():
                self._work.wait(timeout=max(self.flush_deadline / 2,
                                            0.001))
                self._work.clear()

    def run_until_idle(self, max_steps=None):
        """Drive step() until no work remains (tests, benches)."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return n

    def idle(self):
        with self._lock:
            return not (self._waiting or self._active or self._preempted
                        or self._prefilling)

    # -- drain / export (deploys and failover) -----------------------------

    def drain(self, draining=True):
        """Flip drain mode: while draining, submit() raises
        SchedulerDraining but in-flight requests decode to completion.
        drain(False) re-opens admission."""
        self.draining = bool(draining)
        self._work.set()
        return self.draining

    def export_requests(self, cancel=False):
        """Snapshot every live request as a JSON-safe record for
        cross-replica replay: {request_id, feed, max_new_tokens, tokens,
        eos_id, bos_id, deadline_ms, priority}.  Importing via
        submit(decode_feed(rec["feed"]), ..., recorded_tokens=
        rec["tokens"]) resumes each generation on another replica.  A
        request mid chunked prefill exports as a plain record (no token
        yet): its chunk cursor stays here, and the importer re-chunks
        from 0.  cancel=True retires the exported requests here."""
        with self._step_lock:  # a step boundary: tokens lists are stable
            with self._lock:
                live = (list(self._waiting) + list(self._active)
                        + list(self._preempted) + list(self._prefilling))
            out = []
            for req in live:
                rem_ms = None
                if req.deadline is not None:
                    rem_ms = max(0.0, (req.deadline - time.monotonic())
                                 * 1e3)
                out.append({
                    "request_id": req.request_id,
                    "feed": encode_feed(req.feed),
                    "max_new_tokens": req.max_new_tokens,
                    "tokens": [int(t) for t in req.tokens],
                    "eos_id": req.eos_id,
                    "bos_id": req.bos_id,
                    "deadline_ms": rem_ms,
                    "priority": req.priority,
                })
                self.counters["exported"] += 1
            if cancel:
                for req in live:
                    req.cancel()
        return out

    def import_requests(self, records):
        """submit() each export_requests record; returns the handles."""
        return [self.submit(
            decode_feed(rec["feed"]), rec["max_new_tokens"],
            deadline_ms=rec.get("deadline_ms"),
            eos_id=rec.get("eos_id"), bos_id=rec.get("bos_id"),
            request_id=rec.get("request_id"),
            recorded_tokens=rec.get("tokens"),
            priority=rec.get("priority", "interactive"))
            for rec in records]

    def step(self):
        """One scheduler iteration: apply cancellations and expiries, then
        either admit a group (one batched prefill) or run one decode step
        (a plain step and/or a draft-and-verify round), followed by one
        chunk pass when a chunked prompt is mid-prefill.  Returns whether
        it did any work.  With admission on, every iteration (busy or
        idle) feeds the brownout ladder the queue depth."""
        if not _telem._ENABLED and self._overload is None:
            return self._step_impl()
        t0 = time.perf_counter()
        did = self._step_impl()
        if self._overload is not None:
            with self._lock:
                depth = len(self._waiting)
            self._overload.observe_queue(depth)
        if _telem._ENABLED and did:
            _H_STEP_MS.observe((time.perf_counter() - t0) * 1e3)
            _C_STEPS.inc()
            with self._lock:
                depth = len(self._waiting)
                _G_QUEUE.set(depth)
                _G_ACTIVE.set(len(self._active))
            _H_QUEUE_DEPTH.observe(depth)
        return did

    def _step_impl(self):
        with self._step_lock, torch.inference_mode():
            self._sweep()
            if self._maybe_admit():
                return True
            did = False
            if self._active:
                self._decode_step()
                did = True
            if self._prefilling:
                # one chunk pass after the decode step: a long arrival
                # stalls decoding by one chunk at most
                self._chunk_pass()
                did = True
            return did

    # -- bookkeeping -------------------------------------------------------

    def _retire(self, req, status, error=None):
        if req._blocks:
            self.pool.release(req._blocks)
            req._blocks = []
        req._states = {}
        req._finish(status, error)
        if req._span is not None:
            req._span.end("ok" if status == "done" else status,
                          tokens=len(req.tokens))
            req._span = None
        key = {"done": "completed", "expired": "expired",
               "cancelled": "cancelled", "error": "errors",
               "prefilled": "completed"}[status]
        self.counters[key] += 1

    def _sweep(self):
        """Apply cancellations and deadline expiries at a step boundary."""
        now = time.monotonic()
        with self._lock:
            for q in (self._waiting, self._active, self._preempted,
                      self._prefilling):
                for req in list(q):
                    if req._cancel_flag and not req.done:
                        q.remove(req)
                        self._retire(req, "cancelled")
                    elif req.deadline is not None and now > req.deadline \
                            and not req.done:
                        q.remove(req)
                        self._retire(req, "expired")

    # -- admission ---------------------------------------------------------

    def _replay_blocks(self, req):
        """Blocks an evicted request's replay takes: its prompt and every
        token it has decoded (and, under spec decode, its first verify
        window's spec_k rows)."""
        rows = len(req.tokens) + (self.spec_k if self.spec_decode else 0)
        if self.spec.init_lengths_from is not None:
            rows += int(np.asarray(
                req.feed[self.spec.init_lengths_from]).reshape(-1)[0])
        return self.pool.blocks_for(rows)

    def _resumable(self, free):
        """Preempted requests to resume into `free` slots, oldest first.
        An evicted one waits until the pool's free blocks hold its whole
        replay (or nothing else is running).  The JAX loop resumes it at
        once: its replay then evicts a running request, which resumes and
        evicts it in turn, and with a pool short of both the scheduler
        replays forever without decoding (ROADMAP.md C7)."""
        budget = self.pool.free_blocks()
        out = []
        for req in self._preempted:
            if len(out) >= free:
                break
            if req._needs_replay and self._active:
                need = self._replay_blocks(req)
                if need > budget:
                    continue
                budget -= need
            out.append(req)
        return out

    def _maybe_admit(self):
        with self._lock:
            # mid-prefill chunked requests hold a slot: they graduate into
            # _active without re-admission
            free = self.max_batch - len(self._active) \
                - len(self._prefilling)
            resumable = self._resumable(free)
            for req in resumable:
                self._preempted.remove(req)
            free -= len(resumable)
            group = []
            if self._waiting and free > 0:
                now = time.monotonic()
                oldest = min(r.submit_t for r in self._waiting)
                urgent = any(
                    r.deadline is not None
                    and r.deadline - now <= 2 * self.flush_deadline
                    for r in self._waiting)
                flush = (not self._active
                         or len(self._waiting) >= free
                         or now - oldest >= self.flush_deadline
                         or urgent)
                if flush:
                    group = self._waiting[:free]
                    del self._waiting[:len(group)]
        if not resumable and not group:
            return False
        # resumed-with-state rejoin directly; evicted ones replay
        for req in resumable:
            if req._needs_replay:
                group.append(req)
            else:
                req.status = "running"
                self._active.append(req)
        if group:
            self._admit_group(group)
        with self._lock:
            self.counters["peak_active"] = max(
                self.counters["peak_active"], len(self._active))
        return True

    def _admit_group(self, group):
        """One batched prefill for the group (cache hits skip it; handoff
        imports adopt their rows; prompts longer than a chunk leave for the
        chunked path)."""
        for req in [r for r in group if r._kv_payload is not None]:
            group.remove(req)
            try:
                self._adopt(req)
            except Exception:  # noqa: BLE001 — request-scoped failure
                import traceback

                self._retire(req, "error", traceback.format_exc())
        hits, misses = [], []
        for req in group:
            req._prefix_key = prompt_key(req.feed, req.eos_id, req.bos_id) \
                if self.prefix_cache else None
            ent = self.pool.lookup_prefix(req._prefix_key) \
                if (self.prefix_cache and self._streams_ready
                    and not req._needs_replay) else None
            if ent is not None:
                blocks, n_rows, aux = ent
                req._blocks = list(blocks)
                req._cursor = n_rows
                req._prefix_rows = n_rows
                req._states = dict(aux["states"])
                if self.spec_decode:
                    req._draft_states = dict(aux["draft_states"])
                    req._draft_lag, req._draft_gap = 0, None
                req._last_tok = aux["first_token"]
                if aux["first_token"] is not None:
                    req._emit(aux["first_token"])
                hits.append(req)
            else:
                misses.append(req)
        if self.prefill_chunk:
            # prompts longer than one chunk run chunk windows, one per
            # loop iteration; shorter ones keep the batched prefill
            for req in [r for r in misses
                        if self._prompt_len(r) > self.prefill_chunk]:
                misses.remove(req)
                req._chunk_pos = 0
                req.status = "running"
                self._prefilling.append(req)
                self.counters["chunked"] += 1
        if misses:
            try:
                self._prefill_group(misses)
            except Exception:  # noqa: BLE001 — request-scoped failure:
                # the group carries the traceback; the loop keeps serving
                # other tenants
                import traceback

                tb = traceback.format_exc()
                for req in misses:
                    self._retire(req, "error", tb)
                misses = []
        for req in hits + misses:
            self._cow_tail(req)
            replay = req._needs_replay
            req._needs_replay = False
            if replay:
                self.counters["replays"] += 1
                _C_REPLAYS.inc()
                self._replay(req)
            if not req.done:
                self._activate(req)
            if not replay:
                self.counters["admitted"] += 1
                _C_ADMISSIONS.inc()

    def _activate(self, req):
        """A prompt is processed and its first token out: retire a request
        that is finished already, hand a prefill_only one off, else start
        decoding it."""
        if self._finished_after_emit(req):
            self._retire(req, "done")
        elif req.prefill_only:
            self._handoff(req)
        else:
            req.status = "running"
            self._active.append(req)

    def _cow_tail(self, req):
        """Copy-on-write the partially filled tail block before this
        request appends into it (it may be shared with the prefix cache or
        another tenant)."""
        if req._cursor % self.block_size == 0 or not req._blocks:
            return
        tail = req._blocks[-1]
        if self.pool._refs[tail] > 1:
            req._blocks[-1] = self.pool.clone_block(tail)
            self.pool.release([tail])

    def _prefill_group(self, group):
        spec = self.spec
        # pad the group to the bucket ladder by replicating row 0, as the
        # decode step does; pad rows are computed and discarded
        n = len(group)
        pad = self._bucket(n) - n
        feed = {}
        for name in list(spec.prefill_feeds) + list(spec.step_feeds):
            if name not in feed:
                feed[name] = np.concatenate(
                    [r.feed[name] for r in group]
                    + [group[0].feed[name]] * pad)
        t0 = time.perf_counter()
        _, states, lengths, logits = self._gen._prefill(feed, slots=False)
        # the draft prefills the same feed, so its KV chain covers the
        # prompt too; its rows ride the same block tables ("draft:"
        # streams), so CoW, prefix sharing and eviction cover it
        paged = {s.feed: states[s.feed] for s in self._paged}
        dstates = None
        if self.spec_decode:
            _, dstates, _, _ = self._draft_gen._prefill(feed, slots=False)
            paged.update({"draft:" + s.feed: dstates[s.feed]
                          for s in self._draft_paged})
        # the first tokens' read-back ends the prefill's window on the card
        toks = None if logits is None else _argmax(logits, n)
        if self._overload is not None:
            if toks is None:
                self._sync()
            # per prompt token, as the chunk passes observe
            self._overload.observe_prefill(
                (time.perf_counter() - t0) * 1e3,
                tokens=max(1, int(np.sum(
                    np.asarray(lengths).reshape(-1)[:n]))))
        self.counters["prefills"] += len(group)
        self.counters["prefill_batches"] += 1
        if not self._streams_ready:
            for name, v in paged.items():
                self.pool.add_stream(name, tuple(v.shape[2:]), v.dtype)
            self._streams_ready = True
        jobs = {name: [] for name in paged}
        for b, req in enumerate(group):
            n_rows = int(lengths[b])
            req._cursor = n_rows
            req._prefix_rows = n_rows
            req._blocks = self.pool.alloc(self.pool.blocks_for(n_rows)) \
                if n_rows else []
            for name, v in paged.items():
                if n_rows:
                    jobs[name].append((req._blocks, 0, v[b, :n_rows]))
            req._states = {s.feed: states[s.feed][b].clone()
                           for s in self._carried + self._const}
            if self.spec_decode:
                req._draft_states = {s.feed: dstates[s.feed][b].clone()
                                     for s in self._draft_const}
                req._draft_lag, req._draft_gap = 0, None
            req._last_tok = None if toks is None else int(toks[b])
        # one batched write for the whole group, per stream
        self.pool.write_rows_multi(jobs)
        for req in group:
            if self.prefix_cache and req._prefix_key is not None \
                    and req._blocks:
                aux = {"states": dict(req._states),
                       "first_token": req._last_tok}
                if self.spec_decode:
                    aux["draft_states"] = dict(req._draft_states)
                self.pool.register_prefix(
                    req._prefix_key, req._blocks, req._prefix_rows, aux=aux)
            if req._last_tok is not None and not req._needs_replay:
                req._emit(req._last_tok)

    def _finished_after_emit(self, req):
        """Terminal right after admission: prefill already emitted eos or
        the budget is a single token."""
        eos = req.eos_id if req.eos_id is not None else self.spec.eos_id
        return bool(req.tokens) and (
            req.tokens[-1] == eos
            or len(req.tokens) >= req.max_new_tokens)

    # -- chunked prefill ---------------------------------------------------

    def _prompt_len(self, req):
        return int(np.asarray(
            req.feed[self.spec.init_lengths_from]).reshape(-1)[0])

    def _ensure_streams_from_spec(self):
        """Register the pool's KV streams from the step program's var
        shapes ([-1, max_len, *row]): chunked prefill and handoff adoption
        write rows before any monolithic prefill has added them.  No draft
        stream arises here: chunking refuses spec decode, and a spec-decode
        Scheduler replays a handoff instead of adopting it."""
        if self._streams_ready:
            return
        prog_vars = self.spec.step_program.global_block().vars
        for s in self._paged:
            var = prog_vars[s.feed]
            self.pool.add_stream(s.feed, tuple(int(d) for d in var.shape[2:]),
                                 var.dtype)
        self._streams_ready = True

    def _chunk_step_program(self):
        if self._chunk_prog is None:
            self._chunk_prog = build_paged_step(
                self.spec, self.block_size, self.pool.num_blocks,
                program=self.spec.chunk_program)
        return self._chunk_prog

    def _run_encode(self, req):
        """Seed the request's constant states (the cross-attention k/v)
        from the spec's encode program: a chunked prompt never runs the
        prefill program, where they come from otherwise."""
        spec = self.spec
        if not self._const:
            return
        prog_vars = spec.encode_program.global_block().vars
        feed = {n: v for n, v in req.feed.items() if n in prog_vars}
        outs = self._gen._run("encode", spec.encode_program,
                              spec.encode_fetches(), feed)
        req._states = {s.feed: outs[s.encode_from][0].clone()
                       for s in self._const}

    def _chunk_pass(self):
        """ONE chunk window for the oldest mid-prefill request (round robin
        by pop and append).  Under pool pressure with nothing to evict,
        the request drops its partial chain and goes back to the FRONT of
        the queue, to re-chunk from 0 when room returns (it emitted
        nothing, so nothing replays)."""
        req = self._prefilling.pop(0)
        try:
            done = self._run_chunk(req)
        except PoolExhausted:
            if req._blocks:
                self.pool.release(req._blocks)
                req._blocks = []
            req._chunk_pos = req._cursor = 0
            req._states = {}
            req.status = "queued"
            with self._lock:
                self._waiting.insert(0, req)
            self.counters["preemptions"] += 1
            _C_EVICTIONS.inc()
            return
        except Exception:  # noqa: BLE001 — request-scoped failure
            import traceback

            self._retire(req, "error", traceback.format_exc())
            return
        if done:
            self._graduate(req)
        else:
            self._prefilling.append(req)

    def _run_chunk(self, req):
        """One Sq = chunk window of the prompt through the paged chunk
        program (batch 1).  The length remainder rides the FIRST window,
        padded to full width with its last real token: the pad rows sit
        past the cursor (`lengths` counts real rows only), are masked by
        the ramp and are overwritten by the next window.  So the last
        window is always full, and its last row's argmax is the first
        token.  Returns True once the prompt is processed."""
        spec = self.spec
        c = self.prefill_chunk
        length = self._prompt_len(req)
        self._ensure_streams_from_spec()
        if not req._states:
            self._run_encode(req)
        if not self._ensure_block(req, rows=c):
            raise PoolExhausted(f"no room for a {c}-row chunk window")
        t0 = time.perf_counter()
        toks = np.asarray(
            req.feed[spec.prompt_ids_name]).reshape(-1)[:length]
        if req._chunk_pos == 0:
            real = length % c or c
            window = np.concatenate(
                [toks[:real], np.full(c - real, toks[real - 1], toks.dtype)])
        else:
            real = c
            window = toks[req._chunk_pos:req._chunk_pos + c]
        feed = self._window_feed(spec, [req], window.reshape(1, c),
                                 [req._chunk_pos], self._const, "_states",
                                 self._paged, tag="chunk")
        outs = self._run_paged_exec(feed, spec.chunk_fetches(), tag="chunk",
                                    program=self._chunk_step_program())
        for s in self._paged:
            self.pool.set_stream(s.feed, outs[s.chunk_update])
        req._chunk_pos += real
        req._cursor = req._chunk_pos
        done = req._chunk_pos >= length
        if done:
            req._last_tok = int(torch.argmax(
                outs[spec.chunk_logits].reshape(c, -1)[c - 1]))
        else:
            self._sync()  # the pass, not its enqueue
        ms = (time.perf_counter() - t0) * 1e3
        if _telem._ENABLED:
            _H_CHUNK_MS.observe(ms)
        self._chunk_samples.append(ms)
        if self._overload is not None:
            self._overload.observe_prefill(ms, tokens=real)
        self.counters["chunk_passes"] += 1
        self._note_occupancy()
        return done

    def _graduate(self, req):
        """A chunked prefill finished: _prefill_group's tail for one
        request (prefix registration, CoW, replay or emit, activation)."""
        req._prefix_rows = req._cursor
        if self.prefix_cache and req._prefix_key is not None \
                and req._blocks:
            self.pool.register_prefix(
                req._prefix_key, req._blocks, req._prefix_rows,
                aux={"states": dict(req._states),
                     "first_token": req._last_tok})
        self._cow_tail(req)
        replay = req._needs_replay
        req._needs_replay = False
        if replay:
            self.counters["replays"] += 1
            _C_REPLAYS.inc()
            self._replay(req)
        else:
            req._emit(req._last_tok)
        if not req.done:
            self._activate(req)
        if not replay:
            self.counters["admitted"] += 1
            _C_ADMISSIONS.inc()
        with self._lock:
            self.counters["peak_active"] = max(
                self.counters["peak_active"], len(self._active))

    # -- two-tier handoff --------------------------------------------------

    def _handoff(self, req):
        """Prefill tier's terminal: park the handoff record (the plain
        export record plus the cursor, the KV rows, the constant states
        and the first token) on the handle and retire "prefilled"."""
        rem_ms = None
        if req.deadline is not None:
            rem_ms = max(0.0, (req.deadline - time.monotonic()) * 1e3)
        req.handoff = {
            "request_id": req.request_id,
            "feed": encode_feed(req.feed),
            "max_new_tokens": req.max_new_tokens,
            "tokens": [int(t) for t in req.tokens],
            "eos_id": req.eos_id,
            "bos_id": req.bos_id,
            "deadline_ms": rem_ms,
            "priority": req.priority,
            "cursor": int(req._cursor),
            "kv": self.pool.export_rows(req._blocks, req._cursor),
            "states": {k: v.cpu().numpy() for k, v in req._states.items()},
            "last_tok": int(req._last_tok),
            "n_tokens": len(req.tokens),
        }
        self.counters["handoffs"] += 1
        self._retire(req, "prefilled")

    def _adopt(self, req):
        """Decode tier's admission of a handed-off request: land the
        shipped rows in this pool (re-blocked: the tiers need not share a
        block size), restore the states, cursor and last token, then
        teacher-force any recorded token past the payload's coverage.  Under
        pool pressure it falls back to evict-and-replay, which rebuilds the
        same rows from the feed and the tokens."""
        p = req._kv_payload
        req._kv_payload = None
        cursor = int(p["cursor"])
        self._ensure_streams_from_spec()
        try:
            req._blocks = self.pool.adopt_rows(p["rows"], cursor)
        except PoolExhausted:
            req._needs_replay = True
            self._preempted.append(req)
            return
        req._cursor = cursor
        req._prefix_rows = 0
        req._states = {k: torch.as_tensor(np.asarray(v), device=self.device)
                       for k, v in p.get("states", {}).items()}
        req._last_tok = int(p["last_tok"])
        self.counters["adopted"] += 1
        recorded = list(req.tokens)
        prev = req._last_tok
        for i in range(int(p.get("n_tokens", len(recorded))), len(recorded)):
            if not self._ensure_block(req):
                self._retire(req, "error", "KV pool exhausted mid-adopt")
                return
            self._run_step([req], [prev])
            prev = recorded[i]
            req._last_tok = prev
        self._activate(req)
        self.counters["admitted"] += 1
        _C_ADMISSIONS.inc()

    # -- replay (evicted-state rebuild) ------------------------------------

    def _replay(self, req):
        """Rebuild an evicted request's cache by teacher-forcing its own
        recorded tokens through batch-1 steps, so the request resumes as
        if never evicted."""
        recorded = list(req.tokens)
        had_prefill_tok = self.spec.prefill_logits is not None
        # prefill just re-ran in _prefill_group (emit suppressed); check
        # that its first token agrees with the history, then force the rest
        start = 1 if had_prefill_tok else 0
        if had_prefill_tok and recorded and req._last_tok != recorded[0]:
            self._retire(req, "error",
                         "replay diverged at the prefill token")
            return
        bos = req.bos_id if req.bos_id is not None else self.spec.bos_id
        prev = req._last_tok if had_prefill_tok else bos
        for i in range(start, len(recorded)):
            if not self._ensure_block(req):
                self._retire(req, "error", "KV pool exhausted mid-replay")
                return
            if self.spec_decode:
                # the draft chain replays in lockstep (same forced token,
                # same row), so the request resumes at draft lag 0
                self._run_draft_step([req], [prev], [req._cursor])
            self._run_step([req], [prev])
            prev = recorded[i]
            req._last_tok = prev
        req._last_tok = recorded[-1] if recorded else req._last_tok
        req._draft_lag, req._draft_gap = 0, None

    # -- decode ------------------------------------------------------------

    def _bucket(self, n):
        for b in self._buckets:
            if b >= n:
                return b
        return self.max_batch

    def _ensure_block(self, req, rows=1):
        """Grow req's table to cover the next `rows` writes (a verify or
        chunk window writes several); under pool pressure preempt-and-evict
        the lowest-priority OTHER tenant and retry."""
        from ..ops.kv_cache import PoolExhausted

        need = self.pool.blocks_for(req._cursor + rows) - len(req._blocks)
        while need > 0:
            try:
                req._blocks.extend(self.pool.alloc(need))
                break
            except PoolExhausted:
                victim = self._pick_victim(exclude=req)
                if victim is None:
                    return False
                self._evict(victim)
        return True

    def _pick_victim(self, exclude=None):
        """Preemption order under pool pressure: already-expired tenants
        first, then batch class before interactive, then latest deadline
        (no deadline = last possible), newest admission breaking ties."""
        pool = [r for r in self._active if r is not exclude]
        if not pool:
            return None
        far = float("inf")
        now = time.monotonic()
        return max(pool, key=lambda r: (
            r.deadline is not None and r.deadline <= now,
            r.priority == "batch",
            far if r.deadline is None else r.deadline, r.submit_t))

    def preempt(self, req, evict=False):
        """Take `req` off the active set at a step boundary.  Its state
        stays in the pool for a cheap resume; evict=True frees the blocks
        too (the request replays on resume)."""
        if req in self._active:
            self._active.remove(req)
        if evict:
            self._evict_blocks(req)
        req.status = "queued"
        self._preempted.append(req)
        self.counters["preemptions"] += 1
        _C_EVICTIONS.inc()

    def _evict(self, req):
        self._active.remove(req)
        self._evict_blocks(req)
        req.status = "queued"
        self._preempted.append(req)
        self.counters["preemptions"] += 1
        _C_EVICTIONS.inc()

    def _evict_blocks(self, req):
        if req._blocks:
            self.pool.release(req._blocks)
            req._blocks = []
        req._needs_replay = True
        req._cursor = 0

    def _decode_step(self):
        # a full cache ends the generation with whatever was decoded
        for req in list(self._active):
            if req._cursor >= self.spec.max_len:
                self._active.remove(req)
                self._retire(req, "done")
        batch = list(self._active)
        if not self.spec_decode:
            if batch:
                self._plain_round(batch)
            return
        # a verify window writes rows [cursor, cursor + k): a row whose
        # window would cross max_len takes the plain step instead (it
        # retires within k steps), so the window stays inside the table
        # and keys past the limit exist as masked positions
        lim = self.spec.max_len - self.spec_k
        plain = [r for r in batch if r._cursor > lim]
        if plain:
            self._plain_round(plain)
        # the plain round's block growth may have evicted spec rows
        spec_rows = [r for r in batch if r._cursor <= lim
                     and r in self._active]
        if spec_rows:
            self._spec_round(spec_rows)

    def _plain_round(self, batch):
        for req in list(batch):
            if req not in self._active:
                # evicted by an earlier row's _ensure_block this round: it
                # holds no blocks and must not be given one (the JAX loop
                # allocates it a block here that its replay's prefill
                # then overwrites and leaks, ROADMAP.md C7)
                continue
            if not self._ensure_block(req):
                batch.remove(req)
                self._active.remove(req)
                self._retire(req, "error", "KV pool exhausted")
        batch = [r for r in batch if r in self._active]
        if not batch:
            return
        toks = self._run_step(batch, [r._last_tok for r in batch])
        for req, tok in zip(batch, toks):
            eos = req.eos_id if req.eos_id is not None else self.spec.eos_id
            req._last_tok = int(tok)
            req._emit(tok)
            if tok == eos or len(req.tokens) >= req.max_new_tokens:
                self._active.remove(req)
                self._retire(req, "done")

    # -- speculative decoding (draft and verify) ---------------------------

    def _spec_round(self, batch):
        """One draft-and-verify round (scheduler.py:1537 of the JAX
        package): k - 1 batched draft steps propose a window, ONE bucketed
        Sq = k verify launch of the target scores every position, and each
        row emits the longest prefix the target agrees with, 1 to k
        tokens.

        Verify output j is the target's greedy token given inputs 0..j
        (input 0 is the row's last emitted token), so proposal d_j (input
        j) stands iff it equals output j - 1; output 0 is what a plain
        step would produce and is always emitted.  Rows past the new
        cursor hold the rejected inputs' k/v, dead by the SeqLen contract
        until the next write lands over them."""
        k = self.spec_k
        for req in list(batch):
            if req not in self._active:
                # evicted by an earlier row's _ensure_block this round: no
                # blocks for it (ROADMAP.md C7)
                continue
            if not self._ensure_block(req, rows=k):
                self._active.remove(req)
                self._retire(req, "error", "KV pool exhausted")
        batch = [r for r in batch if r in self._active]
        if not batch:
            return
        # every row runs every draft step (one uniform batch); a row at
        # draft lag 1 spends its first step on the gap token (its output
        # discarded) and proposes k - 2
        prev = [r._draft_gap if r._draft_lag else r._last_tok for r in batch]
        dcurs = [r._cursor - r._draft_lag for r in batch]
        proposals = [[] for _ in batch]
        for j in range(k - 1):
            dtoks = self._run_draft_step(batch, prev, dcurs)
            for i, r in enumerate(batch):
                dcurs[i] += 1
                if r._draft_lag and j == 0:
                    prev[i] = r._last_tok
                else:
                    proposals[i].append(int(dtoks[i]))
                    prev[i] = int(dtoks[i])
        # verify inputs [last_tok, d_1, ...], padded to k with the final
        # entry (pad positions lie past any acceptance point)
        inps = []
        for i, r in enumerate(batch):
            row = [r._last_tok] + proposals[i]
            inps.append(row + [row[-1]] * (k - len(row)))
        t = self._run_verify(batch, np.asarray(inps, np.int64))
        n_prop = n_acc = n_tok = 0
        for i, req in enumerate(batch):
            eos = req.eos_id if req.eos_id is not None else self.spec.eos_id
            p = len(proposals[i])
            m = 1
            while m <= p and proposals[i][m - 1] == int(t[i][m - 1]):
                m += 1
            n_prop += p
            n_acc += m - 1
            old_last = req._last_tok
            emitted = []
            for j in range(m):
                emitted.append(int(t[i][j]))
                if emitted[-1] == eos or len(req.tokens) + len(emitted) \
                        >= req.max_new_tokens:
                    break
            e = len(emitted)
            n_tok += e
            req._cursor += e
            req._last_tok = emitted[-1]
            # the draft chain now covers [0, old cursor + k - 1 - old lag);
            # the new lag is how far the cursor ran past it (at most 1, on
            # full acceptance), and the gap token is the one at the new
            # cursor's last filled position
            draft_next = (req._cursor - e) + (k - 1) - req._draft_lag
            req._draft_lag = max(0, req._cursor - draft_next)
            req._draft_gap = None if not req._draft_lag else (
                emitted[e - 2] if e >= 2 else old_last)
            for tok in emitted:
                req._emit(tok)
            if _telem._ENABLED:
                if p:
                    _H_SPEC_ACCEPT.observe((m - 1) / p)
                _H_TOKENS_PER_STEP.observe(float(e))
            if emitted[-1] == eos or len(req.tokens) >= req.max_new_tokens:
                self._active.remove(req)
                self._retire(req, "done")
        self.counters["spec_rounds"] += 1
        self.counters["spec_proposed"] += n_prop
        self.counters["spec_accepted"] += n_acc
        self.counters["spec_tokens"] += n_tok
        if _telem._ENABLED:
            _C_SPEC_PROPOSED.inc(n_prop)
            _C_SPEC_ACCEPTED.inc(n_acc)

    def _step_feed(self, batch, prev_toks, pad):
        """The step program's dense feeds for `batch`, padded to its
        bucket: previous tokens, cursors, step-feed constants and the
        carried and constant states."""
        spec = self.spec
        feed = {spec.prev_ids_name: _stack(
            [np.int64(t) for t in prev_toks], pad).reshape(-1, 1)}
        if spec.lengths_name is not None:
            feed[spec.lengths_name] = _stack(
                [np.int64(r._cursor) for r in batch], pad)
        for name in spec.step_feeds:
            feed[name] = _stack([r.feed[name][0] for r in batch], pad)
        for s in self._carried + self._const:
            feed[s.feed] = self._state_stack(
                "dense", s.feed, [r._states[s.feed] for r in batch], pad)
        return feed

    def _state_stack(self, tag, name, rows, pad):
        """The batch's per-request state rows stacked [bucket, ...], pad
        rows repeating row 0, in a buffer kept per (tag, state, bucket) and
        rewritten only when the rows change (the batch's membership or
        order, or a carried state's new value): a captured program reads
        it where it lies, and a steady batch copies nothing for it."""
        n = len(rows)
        key = (tag, name, n + pad)
        shape = (n + pad,) + tuple(rows[0].shape)
        hit = self._stacks.get(key)
        if hit is not None and hit[0].shape == shape \
                and hit[0].dtype == rows[0].dtype:
            buf, held = hit
            if len(held) == n and all(a is b for a, b in zip(held, rows)):
                return buf
        else:
            buf = torch.empty(shape, dtype=rows[0].dtype,
                              device=rows[0].device)
        torch.stack(rows, out=buf[:n])
        if pad:
            buf[n:].copy_(buf[:1].expand((pad,) + shape[1:]))
        self._stacks[key] = (buf, tuple(rows))
        return buf

    def _run_step(self, batch, prev_toks):
        """One step program run for `batch`, padded to a bucket (pad rows
        replicate row 0 and are discarded).  Returns the argmax token per
        real row and writes each row's new cache row into the pool."""
        if self.paged_kv:
            return self._run_step_paged(batch, prev_toks)
        spec = self.spec
        n = len(batch)
        pad = self._bucket(n) - n
        feed = self._step_feed(batch, prev_toks, pad)
        states = {s.feed: _stack([self.pool.gather(
            s.feed, r._blocks, r._cursor, spec.max_len) for r in batch],
            pad) for s in self._paged}
        states.update({s.feed: feed.pop(s.feed)
                       for s in self._carried + self._const})
        prev = feed.pop(spec.prev_ids_name)
        lengths = feed.pop(spec.lengths_name) \
            if spec.lengths_name is not None else None
        t0 = time.perf_counter()
        logits, states = self._gen._step(prev, lengths, states, feed)
        toks = _argmax(logits, n)  # the read-back ends the step's window
        if self._overload is not None:
            self._overload.observe_step((time.perf_counter() - t0) * 1e3)
        self.counters["steps"] += 1
        _H_BUCKET_FILL.observe(n / (n + pad))
        rows = torch.arange(n, device=self.device)
        curs = torch.as_tensor([r._cursor for r in batch],
                               device=self.device)
        for s in self._paged:
            new_rows = states[s.feed][rows, curs].cpu().numpy()
            for i, req in enumerate(batch):
                self.pool.write_row(s.feed, req._blocks, req._cursor,
                                    new_rows[i])
        for s in self._carried:
            for i, req in enumerate(batch):
                req._states[s.feed] = states[s.feed][i].clone()
        for req in batch:
            req._cursor += 1
        self._note_occupancy()
        return toks

    # -- paged decode step (device-resident pool) --------------------------

    def _paged_step_program(self):
        if self._paged_prog is None:
            self._paged_prog = build_paged_step(
                self.spec, self.block_size, self.pool.num_blocks)
        return self._paged_prog

    def _draft_step_program(self):
        if self._draft_prog is None:
            self._draft_prog = build_paged_step(
                self._draft_spec, self.block_size, self.pool.num_blocks)
        return self._draft_prog

    def _verify_step_program(self):
        if self._verify_prog is None:
            self._verify_prog = build_paged_step(
                self.spec, self.block_size, self.pool.num_blocks,
                program=self.spec.verify_program)
        return self._verify_prog

    def _run_paged_exec(self, feed, fetch_names, tag="step", program=None,
                        scope=None):
        """Run a rewritten paged program (the step, or `program`: the
        draft step, the verify or the chunk window) over `scope` (the
        target's by default; the draft reads the draft scope): one
        program_as_function cached per (tag, feed shapes and dtypes,
        flags.trace_signature()).  The pool streams are fed as the live
        pool tensors, which kv_cache_append_paged writes in place."""
        from .. import flags
        from ..framework.executor import program_as_function

        sig = tuple((n, tuple(v.shape), str(v.dtype))
                    for n, v in sorted(feed.items()))
        key = (tag, sig, flags.trace_signature())
        fn = self._paged_fns.get(key)
        if fn is None:
            fn = program_as_function(
                self._paged_step_program() if program is None else program,
                self._gen.scope if scope is None else scope, fetch_names,
                self.device, graph_pool=self._gen.graph_pool(),
                mode=self._gen.mode)
            self._paged_fns[key] = fn
        return dict(zip(fetch_names, fn(feed)))

    def _run_step_paged(self, batch, prev_toks):
        """Paged sibling of _run_step: the step program consumes the
        device pool in place through per-row block tables — no per-step
        gather, no per-step cache upload, no host write-back.  Pad rows
        replicate row 0's table AND cursor, so their in-place append
        duplicates row 0's write with the same value."""
        spec = self.spec
        n = len(batch)
        feed = self._window_feed(spec, batch, np.asarray(prev_toks),
                                 [r._cursor for r in batch],
                                 self._carried + self._const, "_states",
                                 self._paged, tag="step")
        t0 = time.perf_counter()
        outs = self._run_paged_exec(feed, spec.step_fetches())
        spec.notify_monitor(outs)
        for s in self._paged:
            self.pool.set_stream(s.feed, outs[s.update])
        toks = _argmax(outs[spec.step_logits], n)
        if self._overload is not None:
            self._overload.observe_step((time.perf_counter() - t0) * 1e3)
        self.counters["steps"] += 1
        _H_BUCKET_FILL.observe(n / self._bucket(n))
        for s in self._carried:
            for i, req in enumerate(batch):
                req._states[s.feed] = outs[s.update][i].clone()
        for req in batch:
            req._cursor += 1
        self._note_occupancy()
        return toks

    def _window_feed(self, spec, batch, ids, curs, states, state_attr,
                     streams, prefix="", tag="step"):
        """A paged program's feeds for `batch`, padded to its bucket by
        replicating row 0 (its table and cursor too, so a pad row's append
        repeats row 0's write): ids [n, w], the write cursors, the
        step-feed constants and the block table as host arrays (a captured
        program copies them into its own buffers), the dense `states`
        (`state_attr` names the request's dict: "_states" or
        "_draft_states") stacked on the device per `tag`
        (`_state_stack`), and the pool streams (`prefix` + name)."""
        n = len(batch)
        bucket = self._bucket(n)
        pad = bucket - n
        table = np.zeros((bucket, self._table_width), np.int64)
        for i, req in enumerate(batch):
            table[i, :len(req._blocks)] = req._blocks
        table[n:] = table[0]
        feed = {spec.prev_ids_name: _stack(
            list(np.asarray(ids, np.int64).reshape(n, -1)), pad)}
        if spec.lengths_name is not None:
            feed[spec.lengths_name] = _stack([np.int64(c) for c in curs],
                                             pad)
        for name in spec.step_feeds:
            feed[name] = _stack([r.feed[name][0] for r in batch], pad)
        for s in states:
            feed[s.feed] = self._state_stack(
                tag, prefix + s.feed,
                [getattr(r, state_attr)[s.feed] for r in batch], pad)
        feed[BLOCK_TABLE_VAR] = table
        for s in streams:
            feed[s.feed] = self.pool.stream(prefix + s.feed)
        return feed

    def _run_draft_step(self, batch, prev_toks, dcurs):
        """One batched single-token DRAFT step over the shared block tables
        (the pool's "draft:" streams) at the caller's cursors (the draft
        trails the target by its lag); request cursors do not move.
        Returns the draft's argmax per real row: it only steers proposals,
        never what is emitted."""
        dspec = self._draft_spec
        feed = self._window_feed(dspec, batch, np.asarray(prev_toks), dcurs,
                                 self._draft_const, "_draft_states",
                                 self._draft_paged, "draft:", tag="draft")
        outs = self._run_paged_exec(feed, dspec.step_fetches(), tag="draft",
                                    program=self._draft_step_program(),
                                    scope=self._draft_gen.scope)
        for s in self._draft_paged:
            self.pool.set_stream("draft:" + s.feed, outs[s.update])
        self.counters["draft_steps"] += 1
        return _argmax(outs[dspec.step_logits], len(batch))

    def _run_verify(self, batch, inps):
        """ONE bucketed Sq = k launch of the target's verify window: all k
        candidate rows append through the paged scatter; returns the
        argmax per (row, position), int64 [n, k]."""
        spec = self.spec
        n = len(batch)
        feed = self._window_feed(spec, batch, inps,
                                 [r._cursor for r in batch], self._const,
                                 "_states", self._paged, tag="verify")
        t0 = time.perf_counter()
        outs = self._run_paged_exec(feed, spec.verify_fetches(),
                                    tag="verify",
                                    program=self._verify_step_program())
        for s in self._paged:
            self.pool.set_stream(s.feed, outs[s.verify_update])
        logits = outs[spec.verify_logits]
        logits = logits.reshape(-1, self.spec_k, logits.shape[-1])[:n]
        toks = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)
        if self._overload is not None:
            self._overload.observe_step((time.perf_counter() - t0) * 1e3)
        self.counters["steps"] += 1
        _H_BUCKET_FILL.observe(n / self._bucket(n))
        self._note_occupancy()
        return toks

    def _sync(self):
        """Wait for the card (a no-op on the CPU): ends a timed window
        that has no read-back of its own."""
        if self.device.type == "cuda":
            cuda_graph.synchronize(self.device)

    def _note_occupancy(self):
        self.counters["peak_occupancy"] = max(
            self.counters["peak_occupancy"], self.pool.occupancy())

    # -- introspection -----------------------------------------------------

    @staticmethod
    def _dist(samples):
        """count/p50/p99 of a rolling sample deque (None when empty)."""
        if not samples:
            return None
        s = sorted(samples)
        return {"count": len(s),
                "p50": s[len(s) // 2],
                "p99": s[min(len(s) - 1, int(len(s) * 0.99))]}

    def stats(self):
        with self._lock:
            out = dict(self.counters)
            out.update({
                "waiting": len(self._waiting),
                "active": len(self._active),
                "preempted": len(self._preempted),
                "draining": self.draining,
                "prefilling": len(self._prefilling),
                "paged_kv": self.paged_kv,
                "spec_decode": self.spec_decode,
                "spec_k": self.spec_k if self.spec_decode else None,
                "prefill_chunk": self.prefill_chunk or None,
                "ttft_ms": self._dist(self._ttft_samples),
                "prefill_chunk_ms": self._dist(self._chunk_samples),
                "pool": self.pool.stats(),
                "buckets": list(self._buckets),
                "overload": None if self._overload is None
                else self._overload.view(),
            })
            return out
