"""Per-device memory accounting: static budget model + live byte probes
(counterpart of paddle_tpu/parallel/memory.py).

  * STATIC — `estimate(program, axes=...)` walks a built Program's vars
    (no devices, no process group: pure host arithmetic) and reports
    per-device bytes by tensor class: params, optimizer_state,
    activations, kv_cache, other.  Each var's footprint is divided by the
    product of live mesh-axis extents its dist_attr names — the same
    resolution sharding_for_var applies — so the model reflects exactly
    what apply_zero / TP / FSDP annotations buy.  The activations number
    is the sum of forward intermediates with batch dims substituted: an
    upper bound (no liveness analysis, no remat).  The arithmetic is the
    JAX package's, number for number.
  * LIVE — `live_bytes()` and `peak_bytes()` read the caching allocator
    of this process's card (`torch.cuda.memory_stats`: the current and
    peak `allocated_bytes.all`); `note_peak()` records a high-water mark
    of `live_bytes()`.  On the CPU there is no allocator to read: they
    return 0 and the recorded mark.

`optimizer_state_bytes(scope, program)` measures the A/B number the
ZeRO leg reports: the bytes this rank holds in optimizer accumulators
(the local shard of each DTensor; ~1/dp under ZeRO stage 1).
"""

from __future__ import annotations

import math
import re

__all__ = [
    "TENSOR_CLASSES",
    "classify_var",
    "estimate",
    "live_bytes",
    "peak_bytes",
    "note_peak",
    "reset_peak",
    "optimizer_state_bytes",
    "max_fittable_params",
]

TENSOR_CLASSES = ("params", "optimizer_state", "activations", "kv_cache",
                  "other")

# Optimizer._add_accumulator names state `<param>_<acc>_<n>` (unique_name
# numbering); scalar schedule state (beta pows, lr) matches too — it is
# optimizer state even though ZeRO cannot shard a [1] var.
_OPT_STATE_RE = re.compile(
    r".*_(moment\d*|velocity|accumulator|avg_squared_grad|avg_squared_update"
    r"|mean_square|mean_grad|squared|linear|beta\d+_pow_acc"
    r"|master_weight)(_\d+)?$"
)
_KV_CACHE_RE = re.compile(r".*(kv_cache|k_cache|v_cache|cache_k|cache_v).*")

_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}


def _dtype_bytes(dtype, default=4):
    name = getattr(dtype, "name", None) or str(dtype or "float32")
    return _DTYPE_BYTES.get(name.lower(), default)


def classify_var(var):
    """Tensor class of one program variable (see TENSOR_CLASSES)."""
    from ..framework.framework import Parameter

    name = getattr(var, "name", "") or ""
    if _KV_CACHE_RE.fullmatch(name):
        return "kv_cache"
    if isinstance(var, Parameter):
        return "params"
    if getattr(var, "persistable", False):
        return "optimizer_state" if _OPT_STATE_RE.fullmatch(name) else "other"
    if getattr(var, "is_data", False):
        return "other"
    return "activations"


def _shard_divisor(var, axes):
    """Product of live axis extents the var's dist_attr names — the factor
    one chip's copy is divided by.  Unannotated activations fall back to
    the batch heuristic (dim0 == -1 → sharded over the data axes), the
    same default sharding_for_var applies to feeds."""
    axes = axes or {}

    def live(a):
        return int(axes.get(a, 1)) if a else 1

    attr = getattr(var, "dist_attr", None)
    div = 1
    if attr:
        for entry in attr:
            names = entry if isinstance(entry, (tuple, list)) else (entry,)
            for a in names:
                div *= live(a)
        return max(1, div)
    shape = getattr(var, "shape", None) or ()
    if (not getattr(var, "persistable", False) and shape
            and int(shape[0]) in (-1, 0)):
        return max(1, live("dp") * live("fsdp"))
    return 1


def estimate(program, axes=None, batch=1, seq_len=None, default_dtype_bytes=4):
    """Static per-chip HBM model: {"per_chip": {class: bytes}, "global":
    {class: bytes}, "per_chip_total": int, "global_total": int,
    "num_vars": {class: int}}.

    `axes` is {axis_name: extent} (e.g. {"dp": 4, "tp": 2}) — a plain
    dict, deliberately not a DeviceMesh, so the model runs without any
    devices.  -1 dims resolve to `batch` (dim0) / `seq_len` (later
    dims, defaulting to `batch`)."""
    axes = dict(axes or {})
    per_chip = {c: 0 for c in TENSOR_CLASSES}
    global_b = {c: 0 for c in TENSOR_CLASSES}
    counts = {c: 0 for c in TENSOR_CLASSES}
    seen = set()
    for block in program.blocks:
        for name, var in block.vars.items():
            if name in seen:
                continue
            seen.add(name)
            shape = getattr(var, "shape", None)
            if shape is None:
                continue
            dims = []
            for i, d in enumerate(shape):
                d = int(d)
                if d <= 0:
                    d = int(batch) if i == 0 else int(seq_len or batch)
                dims.append(d)
            nbytes = (math.prod(dims) if dims else 1) * _dtype_bytes(
                getattr(var, "dtype", None), default_dtype_bytes)
            cls = classify_var(var)
            div = _shard_divisor(var, axes)
            counts[cls] += 1
            global_b[cls] += nbytes
            per_chip[cls] += -(-nbytes // div)  # ceil: uneven remainders count
    return {
        "per_chip": per_chip,
        "global": global_b,
        "num_vars": counts,
        "per_chip_total": sum(per_chip.values()),
        "global_total": sum(global_b.values()),
    }


# ---------------------------------------------------------------------------
# Live probes
# ---------------------------------------------------------------------------

_observed_peak = 0


def _card_stats():
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats()


def live_bytes(per_device=False):
    """Bytes this process's card allocator holds now (one device per
    process: `per_device` gives {device index: bytes})."""
    import torch

    stats = _card_stats()
    now = int(stats.get("allocated_bytes.all.current", 0)) if stats else 0
    if per_device:
        return {torch.cuda.current_device(): now} if stats else {}
    return now


def note_peak():
    """Record the current live_bytes() high-water mark.  Returns the
    running peak."""
    global _observed_peak
    now = live_bytes()
    if now > _observed_peak:
        _observed_peak = now
    return _observed_peak


def reset_peak():
    global _observed_peak
    _observed_peak = 0
    import torch

    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def peak_bytes():
    """Peak bytes of this process's card allocator since the last
    reset_peak() (`allocated_bytes.all.peak`), else the note_peak()
    high-water mark — never raises on the CPU."""
    stats = _card_stats()
    best = int(stats.get("allocated_bytes.all.peak", 0)) if stats else 0
    return max(best, _observed_peak)


def optimizer_state_bytes(scope, program, per_device=True):
    """Measured bytes of optimizer-state vars in a live scope: the bytes
    this rank holds (the local shard of each DTensor; per_device=True —
    the per-device number ZeRO shrinks), or the global total of the
    full values (per_device=False)."""
    local = 0
    global_total = 0
    for block in program.blocks:
        for name, var in block.vars.items():
            if classify_var(var) != "optimizer_state":
                continue
            val = scope.find_var(name)
            if val is None:
                continue
            full = val.numel() * val.element_size()
            to_local = getattr(val, "to_local", None)
            local += (to_local().nbytes if to_local is not None
                      else int(full))
            global_total += int(full)
    return local if per_device else global_total


def max_fittable_params(budget_bytes, axes=None, zero_stage=0,
                        param_bytes=4, moment_bytes=4, n_moments=2,
                        grad_bytes=4, overhead_frac=0.10):
    """Closed-form "how many params fit one chip" model.

    Per-chip bytes per parameter under flat dp:
        params (replicated)     param_bytes
        grads                   grad_bytes          (stage 2: /dp)
        moments (n_moments)     n_moments*moment_bytes  (stage >=1: /dp)
    `overhead_frac` reserves headroom for activations/workspace.  A
    model, not a measurement — the ZeRO leg reports it alongside
    the measured optimizer_state_bytes so drift is visible."""
    axes = dict(axes or {})
    dp = max(1, int(axes.get("dp", 1)) * int(axes.get("fsdp", 1)))
    tp = max(1, int(axes.get("tp", 1)))
    per_param = param_bytes / tp
    per_param += (grad_bytes / tp) / (dp if zero_stage >= 2 else 1)
    per_param += (n_moments * moment_bytes / tp) / (dp if zero_stage >= 1
                                                    else 1)
    usable = float(budget_bytes) * (1.0 - overhead_frac)
    return int(usable / per_param)
