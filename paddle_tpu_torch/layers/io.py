"""Data-input layer functions: `data`, the feed declaration
(paddle_tpu/layers/io.py:16)."""

from __future__ import annotations

from ..framework.framework import VarType
from ..layer_helper import LayerHelper


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """Declare a feed variable; a leading -1 batch dim is prepended unless
    append_batch_size is False."""
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name, shape=shape, dtype=dtype, type=type,
        stop_gradient=stop_gradient, lod_level=lod_level, is_data=True)
