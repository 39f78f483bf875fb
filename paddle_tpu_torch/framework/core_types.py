"""Core scalar types, dtype handling and the Place abstraction.

PyTorch counterpart of paddle_tpu/framework/core_types.py: the same
canonical dtype strings (the Program IR stores these), mapped onto torch
dtypes, and Places that name a `torch.device`.  `CPUPlace` is
`torch.device("cpu")`, `CUDAPlace(i)` is `cuda:i`.  `default_place()` is
the card and never falls back to the CPU: a caller who wants the CPU asks
for `CPUPlace()`.
"""

from __future__ import annotations

import numpy as np
import torch


class VarType:
    """Variable kinds (reference framework.proto VarType.Type); the IR keeps
    the same strings as the JAX package."""

    LOD_TENSOR = "lod_tensor"


_CANONICAL_DTYPES = {
    "float16": "float16",
    "bfloat16": "bfloat16",
    "float32": "float32",
    "float64": "float64",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "uint8": "uint8",
    "bool": "bool",
    "fp16": "float16",
    "bf16": "bfloat16",
    "fp32": "float32",
    "fp64": "float64",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

_TORCH_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_FROM_TORCH = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype) -> str:
    """Normalise any dtype spelling (str / np.dtype / torch.dtype) to a
    canonical string name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        if dtype in _FROM_TORCH:
            return _FROM_TORCH[dtype]
        raise TypeError(f"unsupported dtype: {dtype!r}")
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _CANONICAL_DTYPES:
            return _CANONICAL_DTYPES[key]
        raise TypeError(f"unsupported dtype string: {dtype!r}")
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = getattr(dtype, "__name__", None) or str(dtype)
    if name in _CANONICAL_DTYPES:
        return _CANONICAL_DTYPES[name]
    if "bfloat16" in str(dtype):
        return "bfloat16"
    raise TypeError(f"unsupported dtype: {dtype!r}")


def dtype_to_torch(dtype) -> torch.dtype:
    return _TORCH_DTYPES[convert_dtype(dtype)]


FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def is_float_dtype(dtype) -> bool:
    return convert_dtype(dtype) in FLOAT_DTYPES


class Place:
    """Names one `torch.device`."""

    _device_type = "cpu"

    def __init__(self, device_id: int = 0):
        self._device_id = device_id

    @property
    def device(self) -> torch.device:
        if self._device_type == "cpu":
            return torch.device("cpu")
        return torch.device(self._device_type, self._device_id)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((type(self).__name__, self._device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self._device_id})"


class CPUPlace(Place):
    _device_type = "cpu"


class CUDAPlace(Place):
    _device_type = "cuda"


def default_place() -> Place:
    """The card.  Raises when there is none: the port's entry points run
    on the CPU only when the caller passes `CPUPlace()`."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass place=CPUPlace() to run on "
            "the CPU")
    return CUDAPlace(0)


def as_device(place) -> torch.device:
    """A Place, a torch.device or None (the default place) -> torch.device."""
    if place is None:
        place = default_place()
    if isinstance(place, torch.device):
        return place
    return place.device
