"""Estimate a program's memory for a given batch size: the counterpart of
paddle_tpu/contrib/memory_usage_calc.py (reference
contrib/memory_usage_calc.py).  It sums the var descs' bytes with the
batch dimension substituted; on the card that is device memory:
persistables (parameters and optimizer state) plus the activations a step
materialises.
"""

from __future__ import annotations

import math

from ..framework.core_types import dtype_itemsize

__all__ = ["memory_usage"]


def _var_bytes(var, batch_size):
    shape = var.shape
    if shape is None:
        return 0
    dims = [int(batch_size) if s in (-1, None) else int(s) for s in shape]
    itemsize = dtype_itemsize(var.dtype)
    return int(math.prod(dims)) * itemsize if dims else itemsize


def memory_usage(program, batch_size):
    """Estimated bytes of one iteration of `program` at `batch_size`:
    (total_bytes, {"persistable_bytes", "activation_bytes"})."""
    if (batch_size is None or batch_size <= 0
            or int(batch_size) != batch_size):
        raise ValueError(
            f"batch_size must be a positive integer, got {batch_size}")
    persistable = 0
    activations = 0
    for var in program.list_vars():
        if getattr(var, "type", "lod_tensor") != "lod_tensor":
            continue
        b = _var_bytes(var, batch_size)
        if var.persistable:
            persistable += b
        else:
            activations += b  # feed vars live on the device too
    total = persistable + activations
    return total, {"persistable_bytes": persistable,
                   "activation_bytes": activations}
