"""Layer function namespace of the serving slice (counterpart of
paddle_tpu/layers/): what transformer.build_decode calls."""

from . import control_flow, io, nn, sequence, tensor
from .control_flow import increment
from .io import data
from .nn import (
    elementwise_add,
    embedding,
    fc,
    fused_attention,
    gather,
    kv_cache_append,
    layer_norm,
    multi_head_attention,
    relu,
    reshape,
    scale,
)
from .sequence import sequence_last_step, sequence_pool
from .tensor import create_parameter
