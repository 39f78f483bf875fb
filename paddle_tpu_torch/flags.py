"""Flag registry: one definition per knob with a type, a default, an env
spelling and a docstring (counterpart of paddle_tpu/flags.py).

    from paddle_tpu_torch import flags
    flags.set("flash_attention", "0")

Env override: PADDLE_TPU_<NAME-UPPERCASED>, the JAX package's spelling, so
one environment steers both packages the same way.

Only the flags the serving slice reads are defined.  The attention-gate
defaults are the JAX package's (sized for TPU v5e VMEM), kept so that the
same shapes take the same tier in both packages; an H100-derived gate is
later work (ROADMAP A5).
"""

from __future__ import annotations

import os
import threading

__all__ = ["DEFINE_int", "DEFINE_string", "get", "set", "reset",
           "trace_signature"]

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


def DEFINE_int(name, default, help_="", trace_affecting=False):
    _define(name, int, default, help_, trace_affecting)


def DEFINE_string(name, default, help_="", trace_affecting=False):
    _define(name, str, default, help_, trace_affecting)


def _effective(flag):
    if flag.is_set:
        return flag.value
    raw = os.environ.get(flag.env)
    if raw is not None:
        return flag.type(raw)
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
        flag.value = value if isinstance(value, flag.type) \
            else flag.type(value)
        flag.is_set = True


def reset(name):
    with _LOCK:
        flag = _REGISTRY[name]
        flag.is_set = False
        flag.value = None


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
