"""Flag registry: one definition per knob with a type, a default, an env
spelling and a docstring (counterpart of paddle_tpu/flags.py).

    from paddle_tpu_torch import flags
    flags.set("flash_attention", "0")

Env override: PADDLE_TPU_<NAME-UPPERCASED>, the JAX package's spelling, so
one environment steers both packages the same way.

Only the flags the port's slices read are defined: the Executor's, the
attention gate's, the serving Scheduler's, its front end's (telemetry,
the RPC channel, overload control), the serving fleet's (the router,
its circuit breakers, the supervisor, the routing table's slot count) and
the sparse tier's and the checkpoint manager's, each with the JAX package's default (decode.Generator and
serving.Scheduler take the jit path whatever `executor_mode` says), and
the JAX package's four other trace-affecting flags (`ir_passes`,
`op_remat`, `spec_draft`, `zero_stage`; only the ParallelExecutor reads
one, `zero_stage`), so that `trace_signature()` and with it
`serving.prompt_key` are the JAX package's.  The attention-gate
defaults are the JAX package's (sized for TPU v5e VMEM), kept so that the
same shapes take the same tier in both packages.  H100 values would change
`trace_signature()` and so the fleet's routing (ROADMAP.md A item 4, C16);
`tools/attn_sweep.py` measures the card's crossover.
"""

from __future__ import annotations

import os
import threading

__all__ = ["DEFINE_bool", "DEFINE_int", "DEFINE_string", "get", "set",
           "reset", "trace_signature"]

_LOCK = threading.Lock()
_REGISTRY: dict = {}


class _Flag:
    __slots__ = ("name", "type", "default", "help", "env", "value", "is_set",
                 "trace_affecting")

    def __init__(self, name, type_, default, help_, trace_affecting=False):
        self.name = name
        self.type = type_
        self.default = default
        self.help = help_
        self.env = "PADDLE_TPU_" + name.upper()
        self.value = None
        self.is_set = False
        self.trace_affecting = trace_affecting


def _define(name, type_, default, help_, trace_affecting=False):
    with _LOCK:
        if name in _REGISTRY:
            raise ValueError(f"flag {name!r} defined twice")
        _REGISTRY[name] = _Flag(name, type_, default, help_, trace_affecting)


def DEFINE_bool(name, default, help_="", trace_affecting=False):
    _define(name, bool, default, help_, trace_affecting)


def DEFINE_int(name, default, help_="", trace_affecting=False):
    _define(name, int, default, help_, trace_affecting)


def DEFINE_string(name, default, help_="", trace_affecting=False):
    _define(name, str, default, help_, trace_affecting)


def _coerce(flag, raw):
    """An env or string spelling in the flag's type; for a bool, "0",
    "false", "False", "" and "off" are False (the JAX package's rule)."""
    if flag.type is bool:
        return raw not in ("0", "false", "False", "", "off")
    return flag.type(raw)


def _effective(flag):
    if flag.is_set:
        return flag.value
    raw = os.environ.get(flag.env)
    if raw is not None:
        return _coerce(flag, raw)
    return flag.default


def get(name):
    with _LOCK:
        flag = _REGISTRY.get(name)
        if flag is None:
            raise KeyError(f"unknown flag {name!r} (known: {sorted(_REGISTRY)})")
        return _effective(flag)


def trace_signature():
    """(name, value) pairs of every trace-affecting flag: the flags that
    change which lowering or kernel an op runs."""
    with _LOCK:
        return tuple(
            (name, _effective(f))
            for name, f in sorted(_REGISTRY.items())
            if f.trace_affecting
        )


def set(name, value):  # noqa: A001 - gflags-style API
    with _LOCK:
        flag = _REGISTRY.get(name)
        if flag is None:
            raise KeyError(f"unknown flag {name!r}")
        if isinstance(value, flag.type):
            flag.value = value
        elif isinstance(value, str):
            flag.value = _coerce(flag, value)
        else:
            flag.value = flag.type(value)
        flag.is_set = True


def reset(name):
    with _LOCK:
        flag = _REGISTRY[name]
        flag.is_set = False
        flag.value = None


DEFINE_string("executor_mode", "jit",
              "Executor lowering: 'jit' (segments between no_jit ops; on "
              "the card each is run eagerly at its first signature, then "
              "captured as a CUDA graph and replayed, a training step and "
              "its dropout draws included) or 'interpret' (per-op eager "
              "replay, the path to force for debugging an op).  The JAX "
              "package's default")
DEFINE_string("flash_attention", "auto",
              "Attention-kernel gate: auto (kernels for tensors on the card, "
              "the composite on the CPU) | force/1 | interpret (route to the "
              "kernel wrappers on the CPU too, where they run their plain "
              "versions — the JAX package's Pallas interpret mode) | 0 (the "
              "composite everywhere) | flash (skip the single-block tier)",
              trace_affecting=True)
DEFINE_int("attn_vmem_score_budget", 4 * 1024 * 1024,
           "Byte budget for one [hc, Sq, Sk] f32 score tile: the JAX "
           "package's TPU VMEM gate for the single-block MHA tier.  The "
           "CUDA kernel streams keys and has no such limit; the flag stays "
           "in mha_block.supported() so both packages route the same "
           "shapes to the same tier",
           trace_affecting=True)
DEFINE_int("attn_decode_min_keys", 2048,
           "Decode-gate crossover: flash_decode engages when the cached "
           "key length reaches this many positions; below it the "
           "single-block MHA kernel serves the single-query step "
           "(mha_decode).  The JAX package's TPU default",
           trace_affecting=True)
DEFINE_int("attn_flash_min_scores", 512 * 1024,
           "Auto-gate crossover: the streaming flash tier engages when "
           "Sq*Sk reaches this many score elements AND the single-block "
           "tile no longer fits attn_vmem_score_budget.  The JAX package's "
           "TPU default",
           trace_affecting=True)
DEFINE_bool("conv1x1_as_dot", False,
            "Lower pad-0 group-1 1x1 conv2d as a channel matmul "
            "(torch.matmul over [B, C, H*W]) instead of a library "
            "convolution; a strided one subsamples first.  The JAX "
            "package's A/B lever, off by default as there",
            trace_affecting=True)

# the serving Scheduler's flags, with the JAX package's defaults and help
DEFINE_int("serving_max_batch", 8,
           "serving.Scheduler slot count: the ceiling of the shape-bucket "
           "ladder (1,2,4,...,max_batch), i.e. the largest decode-step "
           "batch one executable is traced for.  Trace-affecting: it is "
           "the bucket-plan identity, so two schedulers with different "
           "ladders never alias each other's step executables",
           trace_affecting=True)
DEFINE_int("serving_flush_deadline_ms", 10,
           "serving.Scheduler admission flush deadline in ms: a waiting "
           "request is admitted no later than this even if the batch "
           "could still coalesce more arrivals.  Scheduling-only — never "
           "changes traced shapes or emitted tokens, only which step a "
           "request joins")
DEFINE_int("kv_block_size", 16,
           "ops.kv_cache pool block granularity in KV positions — and, "
           "on the paged decode path, the flash_decode_paged kernel's "
           "k-tile (each grid step streams exactly one pool block "
           "through VMEM).  Trace-affecting since the paged kernel "
           "landed: block size sets the pool array shapes "
           "[num_blocks, block_size, ...] and the kernel grid, so a "
           "resize must recompile the step executable.  The dense-"
           "gather path still only sees it as allocation granularity, "
           "but the plan cache keys on the value either way",
           trace_affecting=True)
DEFINE_bool("serving_paged_kv", False,
            "serving.Scheduler decode-path selector: with it on the "
            "scheduler holds KV in a device-resident DeviceBlockPool "
            "and runs a paged step executable that consumes block "
            "tables in place (kv_cache_append_paged scatter + paged "
            "attention) — no per-step dense gather, no per-step "
            "host->device cache upload.  Off runs the host-pool dense-"
            "gather path unchanged (the fallback; bitwise token parity "
            "between the two is asserted in bench and tests).  Trace-"
            "affecting: it rewrites which ops the step program runs",
            trace_affecting=True)
DEFINE_int("serving_prefill_chunk", 0,
           "serving.Scheduler chunked-prefill slice width in prompt "
           "tokens (0 = off: whole-prompt prefill).  With it on, a "
           "prompt longer than one chunk never runs a monolithic "
           "prefill: the prompt is processed in Sq=chunk ramp-masked "
           "passes (the speculative-verify program shape) interleaved "
           "with decode steps, so a long arrival can stall in-flight "
           "streams by at most one chunk's wall time.  The prompt-"
           "length remainder rides the FIRST chunk (padded; pad rows "
           "are masked then overwritten), so every later pass is "
           "exact and the final pass's last row emits the first "
           "token — bitwise-identical to monolithic prefill (the "
           "Sq>=2 ramp pathway is bitwise; the Sq=1 step pathway is "
           "NOT, which is why chunks never run through the step "
           "program).  Requires serving_paged_kv and a spec built "
           "with chunk_len equal to this value.  Trace-affecting: it "
           "is the static Sq dimension of the chunk executable",
           trace_affecting=True)
DEFINE_bool("serving_spec_decode", False,
            "serving.Scheduler speculative-decoding selector: a cheap "
            "draft spec proposes spec_k-1 tokens per round and ONE "
            "bucketed Sq=spec_k verify step of the target accepts the "
            "longest matching prefix (greedy accept-longest-prefix, so "
            "emitted tokens are bitwise-identical to plain greedy by "
            "construction).  Requires serving_paged_kv and a draft spec "
            "handed to the Scheduler.  Trace-affecting: the serving "
            "path compiles a second (verify) executable per bucket and "
            "the draft's own step executable",
            trace_affecting=True)
DEFINE_int("spec_k", 4,
           "Speculative-decode verify window: the verify program runs "
           "Sq=spec_k query positions per target step, so each round "
           "can emit up to spec_k tokens (draft proposes spec_k-1).  "
           "Trace-affecting: it is the static Sq dimension of the "
           "verify executable, so a resize must recompile",
           trace_affecting=True)
DEFINE_bool("serving_admission", False,
            "serving.Scheduler overload control (serving/overload.py): "
            "feasibility-gate admissions against the EWMA step time and "
            "token backlog, and run the brownout degradation ladder.  "
            "Off by default (opt-in per deployment); the bench overload "
            "A/B and serving_soak --overload enable it explicitly.  "
            "Scheduling-only — admission decides WHETHER a request "
            "enters, never the shapes or tokens of one that does (the "
            "parity contract is arrival-visible, outcome-invisible)")

# the serving front end's flags (telemetry, the resilient channel, overload
# control), with the JAX package's defaults and help
DEFINE_bool("telemetry", False,
            "Master gate for telemetry: counters/gauges/histograms record "
            "and spans trace (including trace-context propagation on RPC "
            "frame headers).  Off by default — every instrument checks one "
            "module-level bool and returns.  Read once at import; flip at "
            "runtime via telemetry.enable()/disable()")
DEFINE_int("telemetry_max_spans", 50000,
           "Bound on the in-process span ring buffer: oldest spans are "
           "dropped past this count, so enabled-mode memory is O(1) over "
           "a soak.  Read once when telemetry is imported")
DEFINE_int("rpc_max_attempts", 4,
           "resilience.RpcPolicy default: total attempts per RPC (1 = no "
           "retry).  Only transport faults (refused/reset/closed/timeout) "
           "retry; server-side OP_ERROR replies never do")
DEFINE_int("rpc_backoff_ms", 50,
           "resilience.RpcPolicy default: base retry backoff in ms; "
           "attempt k sleeps min(2s, base * 2^k) * (1 + jitter)")
DEFINE_int("rpc_call_timeout_ms", 30000,
           "resilience.RpcPolicy default per-op deadline in ms; a call "
           "exceeding it invalidates the socket (late replies can never "
           "desync the stream) and counts as a retryable fault")
DEFINE_int("retry_budget_ratio", 10,
           "resilience.RetryBudget earn rate as a percent: every call "
           "deposits ratio/100 retry tokens (capped), every retry "
           "spends one — the gRPC retry-throttling idiom, bounding "
           "retry amplification at ~ratio% of offered load no matter how "
           "many clients storm.  0 disables the budget (retries bounded "
           "only by rpc_max_attempts).  Client-side only")
DEFINE_int("brownout_queue_high", 12,
           "Brownout pressure threshold: a scheduler step observing "
           "more than this many waiting requests counts as pressured; "
           "brownout_up_after consecutive pressured steps escalate the "
           "ladder one rung (see serving/overload.py).  Scheduling-only "
           "— drives admission policy, never a traced executable")
DEFINE_int("brownout_up_after", 4,
           "Brownout escalation hysteresis: consecutive pressured "
           "observations required before the ladder climbs one rung "
           "(NORMAL -> CLAMP_BATCH -> SHED_BATCH -> TIGHTEN_SLO).  "
           "Scheduling-only policy knob")
DEFINE_int("brownout_down_after", 16,
           "Brownout recovery hysteresis: consecutive calm observations "
           "required before the ladder descends one rung.  Deliberately "
           "larger than brownout_up_after so degradation releases "
           "slower than it engages (no flapping at the threshold).  "
           "Scheduling-only policy knob")
DEFINE_int("brownout_clamp_tokens", 8,
           "CLAMP_BATCH rung: batch-priority admissions have "
           "max_new_tokens clamped to this while browned out.  The "
           "clamped generation is a PREFIX of the unclamped one (greedy "
           "decode's prefix property), so the parity contract holds — "
           "the clamp changes how much decodes, never what")
DEFINE_int("brownout_slo_tighten_pct", 50,
           "TIGHTEN_SLO rung: interactive admissions must fit their "
           "feasibility estimate in (100 - pct)% of the caller's "
           "deadline — headroom reserved for requests already in "
           "flight.  Scheduling-only policy knob")

# the sparse tier's and the checkpoint manager's flags, with the JAX
# package's defaults and help; none is trace-affecting
DEFINE_bool("ckpt_async", True,
            "checkpoint.CheckpointManager default mode: snapshot device "
            "state to host on the caller thread, then serialize + commit "
            "on a background writer so the train step never blocks on "
            "disk (save() returns immediately; wait() barriers; writer "
            "errors surface on wait()/the next save)")
DEFINE_int("ckpt_keep", 3,
           "checkpoint.CheckpointManager retention default: keep the "
           "newest k COMMITTED checkpoints (keep_every_n survivors are "
           "exempt); 0 disables garbage collection")
DEFINE_int("shard_ping_interval_ms", 500,
           "resilience.ShardSupervisor health-probe period in ms (side "
           "connection PINGs against every shard server)")
DEFINE_bool("sparse_degraded_lookup", False,
            "ShardSupervisor degradation mode (async-pserver semantics): "
            "while a shard is down, lookups serve deterministic "
            "hash_init_rows virgin rows and pushes buffer for replay, "
            "instead of blocking until recovery.  Keeps training stepping "
            "through an outage at the cost of temporarily stale rows")
DEFINE_int("sparse_autoscale_hot_rows", 0,
           "ShardSupervisor.autoscale_check threshold: mean pushed rows "
           "per shard between checks above which the supervisor doubles "
           "the shard count via its spawn hook (live reshard).  0 "
           "disables load-triggered scaling; explicit reshard() always "
           "works")

# the serving fleet's flags (router, supervisor, the routing table), with
# the JAX package's defaults and help
DEFINE_int("sparse_route_slots", 840,
           "sparse.RoutingTable default hash-slot count.  840 = lcm(1..8) "
           "makes the canonical N-shard table reproduce the historical "
           "`id % N` placement bitwise for every N <= 8, so epoch-0 "
           "tables are drop-in for existing checkpoints and tests")
DEFINE_int("fleet_ping_interval_ms", 200,
           "fleet.FleetSupervisor probe period in ms: each cycle PINGs "
           "every replica on a side connection AND scrapes its queue "
           "depth (the router's spill signal).  Tighter than the sparse "
           "tier's default because serving MTTR is user-visible latency")
DEFINE_int("fleet_spill_queue_depth", 4,
           "fleet.FleetRouter imbalance threshold: a request spills off "
           "its prefix-affine replica when that replica's scraped queue "
           "depth exceeds the least-loaded UP replica's by this many "
           "requests.  Low enough to dodge a stalled replica fast, high "
           "enough that normal jitter keeps prefix affinity (and the "
           "cross-replica prefix hit rate) intact")
DEFINE_int("breaker_open_after", 3,
           "fleet.FleetRouter per-replica circuit breaker: consecutive "
           "relay failures (transport faults or admission rejects) "
           "before the breaker trips OPEN and the replica stops "
           "receiving traffic — faster isolation than the supervisor's "
           "fleet_down_after PING debounce for sick-but-alive replicas. "
           "Router-side only; nowhere near a traced root")
DEFINE_int("fleet_prefill_min_tokens", 256,
           "fleet.FleetRouter two-tier routing threshold: a SUBMIT "
           "whose widest feed row (max axis-1 of any 2-D int feed) "
           "reaches this many tokens routes through the prefill tier "
           "first — a prefill replica runs the prompt to completion "
           "and hands off the KV block payload; the decode tier "
           "imports and continues.  Below it (and whenever the "
           "prefill tier is empty or dead) the request goes straight "
           "to the prefix-affine decode replica.  Routing-only; "
           "nowhere near a traced root")
DEFINE_int("breaker_cooldown_ms", 1000,
           "Circuit-breaker OPEN dwell in ms: after this long OPEN, one "
           "probe request flows (HALF_OPEN); success closes the "
           "breaker, failure re-opens it for another cooldown.  "
           "Router-side only; nowhere near a traced root")

# the JAX package's other trace-affecting flags, with its defaults and help.
# They are defined so that the port's plan identity, `trace_signature()`,
# is the JAX package's, and with it `serving.prompt_key` and the fleet
# router's affine index: one feed picks the same replica in both packages.
# `zero_stage` is read by parallel.ParallelExecutor (when
# BuildStrategy.zero_stage is None); no port code reads `ir_passes` (the
# IR pass pipeline, ROADMAP A item 8), `op_remat` or `spec_draft`
DEFINE_bool("ir_passes", False,
            "Run framework/ir.py's PassManager pipeline (constant_fold, "
            "cse, dead_op_elim, memory_reuse) over a clone of the program "
            "before execution.  Every pass output is re-verified by the "
            "static gate's verify_program and results are bitwise-equal "
            "to the unoptimized program; trace-affecting because the "
            "optimized desc lowers to different XLA segments",
            trace_affecting=True)
DEFINE_bool("op_remat", False,
            "barrier'd grad replays (fused_attention/layer_norm): recompute "
            "op internals in the backward instead of storing them fwd->bwd. "
            "~2% step time for much less live memory — enable when the "
            "model doesn't fit (PERF.md round 3)",
            trace_affecting=True)
DEFINE_string("spec_draft", "trunc",
              "Speculative-decode draft tier: 'trunc' rebuilds the "
              "target with half the decoder layers against the SAME "
              "scope (free — shares weights), 'int8' additionally "
              "freezes the draft programs to quantized_matmul via "
              "contrib.quantize.freeze_int8 against a cloned scope.  "
              "Trace-affecting: the tiers trace different draft "
              "executables (layer count / quantized ops)",
              trace_affecting=True)
DEFINE_int("zero_stage", 0,
           "parallel.apply_zero: ZeRO optimizer-state sharding over the "
           "dp mesh axis (0 = off, replicated moments).  Stage 1 shards "
           "every param-shaped optimizer accumulator 1/dp — each "
           "replica keeps only its moment slice, runs a partitioned "
           "update, and the updated params are all-gathered inside the "
           "step computation (XLA overlaps the gather).  Stage 2 "
           "additionally stamps the @GRAD vars so boundary gradients "
           "reduce-scatter instead of all-reduce.  Applied by "
           "ParallelExecutor when BuildStrategy.zero_stage is None.  "
           "Trace-affecting: moment shardings change every compiled "
           "optimizer segment",
           trace_affecting=True)
