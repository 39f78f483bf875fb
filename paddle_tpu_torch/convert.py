"""Carry weights into the port's scope.

`load_params(scope, params, place, programs)` stages {name: ndarray} into
`scope` as tensors on `place`, in the dtype each program declares.  Names
and layouts are the JAX package's: `mul` weights are [in, out],
embeddings [V, d], conv filters OIHW.  Every name is checked against the
persistable vars of `programs` (decode programs, or a training program
with its optimizer state: learning rate, Adam's moments and beta powers or
Momentum's velocities, f32 master weights, and batch norms' running
statistics, which stay float32 next to bf16 parameters under AMP):

  * a name no program declares, or a shape that disagrees, raises;
  * a trainable parameter of the programs missing from `params` raises.
    Non-trainable ones (the decode programs' sinusoid position tables)
    may be left out: decode.Generator fills them from the startups.

bfloat16 values (numpy arrays of the `bfloat16` extension dtype, as a JAX
scope holds them after `amp.cast_model_to_bf16`) are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .framework.core_types import as_device, dtype_to_torch
from .framework.framework import Parameter


def _persistables(programs):
    out = {}
    for prog in programs:
        for v in prog.list_vars():
            if v.persistable:
                out.setdefault(v.name, v)
    return out


def load_params(scope, params, place, programs):
    device = as_device(place)
    declared = _persistables(programs)
    unknown = sorted(set(params) - set(declared))
    if unknown:
        raise KeyError(f"load_params: {unknown} are not persistable vars of "
                       "the given programs")
    missing = sorted(n for n, v in declared.items()
                     if isinstance(v, Parameter) and v.trainable
                     and n not in params)
    if missing:
        raise KeyError(f"load_params: trainable parameters {missing} are "
                       "missing")
    for name, value in params.items():
        var = declared[name]
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(var.shape):
            raise ValueError(f"load_params: {name} has shape "
                             f"{tuple(arr.shape)}, the program declares "
                             f"{tuple(var.shape)}")
        scope.set_var(name, _to_tensor(arr).to(
            device=device, dtype=dtype_to_torch(var.dtype)))


def _to_tensor(arr):
    if arr.dtype.name == "bfloat16":   # no numpy dtype torch knows
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(arr)
