"""Flag registry: one definition per knob with a type, a default, an env
spelling and a docstring (counterpart of paddle_tpu/flags.py).

    from paddle_tpu_torch import flags
    flags.set("flash_attention", "0")

Env override: PADDLE_TPU_<NAME-UPPERCASED>, the JAX package's spelling, so
one environment steers both packages the same way.

Only the flags the port's slices read are defined: the Executor's, the
attention gate's and the serving Scheduler's, each with the JAX
package's default (decode.Generator and serving.Scheduler take the jit
path whatever `executor_mode` says).  The attention-gate
defaults are the JAX package's (sized for TPU v5e VMEM), kept so that the
same shapes take the same tier in both packages; an H100-derived gate is
later work (ROADMAP A5).
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
