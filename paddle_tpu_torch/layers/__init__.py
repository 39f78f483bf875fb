"""Layer function namespace (counterpart of paddle_tpu/layers/): what
transformer.build_decode and transformer.build call."""

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
    mean,
    multi_head_attention,
    relu,
    reshape,
    scale,
    softmax_with_cross_entropy,
)
from .sequence import sequence_last_step, sequence_pool
from .tensor import create_global_var, create_parameter, sums
