"""Contrib tier (paddle_tpu/contrib/): quantization-aware training and the
int8 freeze (`quantize`), and the memory estimate (`memory_usage_calc`).
`contrib/trainer.py` (Trainer, Inferencer, the event classes) is not
ported yet: ROADMAP.md A item 8."""

from . import memory_usage_calc
from . import quantize
from .memory_usage_calc import memory_usage
from .quantize import QuantizeTranspiler, convert_to_int8

__all__ = [
    "memory_usage_calc",
    "memory_usage",
    "quantize",
    "QuantizeTranspiler",
    "convert_to_int8",
]
