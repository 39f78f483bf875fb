"""Host-side I/O ops: save, load, save_combine, load_combine.

Counterparts of paddle_tpu/ops/io_ops.py:22-121.  Saving stays "a program
the executor runs" (io.py builds small programs of these ops).  All four
are `no_jit`: the Executor's jit path runs them on the host between its
segments, never inside a captured graph.

The on-disk format is the JAX package's, byte for byte, so each package
reads the other's files:
  - a single-var file is `_MAGIC`, then `np.save` of the array, then the
    pickled dtype name; bfloat16 is stored as its uint16 bits under the
    name "bfloat16";
  - a combined file is an `np.savez` archive, one entry per var name,
    bfloat16 entries as uint16 bits under `"__bf16__" + name`.
numpy has no bfloat16 of its own, so the port moves bfloat16 bits through
int16 views of the tensor and never needs `ml_dtypes`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .registry import register_op

_MAGIC = b"PTPUVAR1"
_BF16_PREFIX = "__bf16__"


def _to_numpy(x):
    """(numpy array, is_bfloat16): bfloat16 values as their uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), True
        return x.numpy(), False
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _bf16_tensor(bits):
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


def save_array(path, value):
    """Write one tensor or array in the single-var format."""
    arr, bf16 = _to_numpy(value)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        np.save(f, arr, allow_pickle=False)
        pickle.dump("bfloat16" if bf16 else arr.dtype.name, f)


def load_array(path) -> torch.Tensor:
    """Read a single-var file as a CPU tensor."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a paddle_tpu tensor file")
        arr = np.load(f, allow_pickle=False)
        dtype = pickle.load(f)
    if dtype == "bfloat16":
        return _bf16_tensor(arr)
    return torch.from_numpy(arr)


@register_op("save", no_jit=True, no_grad=True)
def save(ctx):
    path = ctx.attr("file_path")
    if os.path.exists(path) and not ctx.attr("overwrite", True):
        raise RuntimeError(f"{path} exists and overwrite=False")
    save_array(path, ctx.input("X"))


@register_op("load", no_jit=True, no_grad=True)
def load(ctx):
    """The tensor on the Executor's device, in the dtype it was saved in."""
    ctx.set_output("Out", load_array(ctx.attr("file_path")).to(ctx.device))


@register_op("save_combine", no_jit=True, no_grad=True)
def save_combine(ctx):
    """Every input into one archive (reference save_combine_op.cc)."""
    path = ctx.attr("file_path")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    names = ctx.attr("var_names", [])
    arrs = {}
    for i, x in enumerate(ctx.inputs("X")):
        key = names[i] if i < len(names) else f"var_{i}"
        arr, bf16 = _to_numpy(x)
        arrs[_BF16_PREFIX + key if bf16 else key] = arr
    with open(path, "wb") as f:
        np.savez(f, **arrs)


@register_op("load_combine", no_jit=True, no_grad=True)
def load_combine(ctx):
    path = ctx.attr("file_path")
    outs = []
    with np.load(path) as z:
        for key in ctx.attr("var_names", []):
            if key in z:
                t = torch.from_numpy(z[key])
            elif _BF16_PREFIX + key in z:
                t = _bf16_tensor(z[_BF16_PREFIX + key])
            else:
                raise KeyError(f"var {key} not in {path}")
            outs.append(t.to(ctx.device))
    ctx.set_outputs("Out", outs)
