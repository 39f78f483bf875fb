"""Layer function namespace (counterpart of paddle_tpu/layers/): what
transformer.build_decode, transformer.build, bert.build, resnet.build and
googlenet.build call.
Importing it patches Variable's arithmetic and comparison operators
(math_op_patch), as the JAX package's does."""

from . import control_flow, io, nn, sequence, tensor
from .control_flow import increment
from .io import data
from .nn import (
    accuracy,
    batch_norm,
    conv2d,
    cross_entropy,
    dropout,
    elementwise_add,
    elementwise_div,
    elementwise_mul,
    elementwise_op,
    elementwise_pow,
    elementwise_sub,
    embedding,
    fc,
    fused_attention,
    gather,
    kv_cache_append,
    layer_norm,
    matmul,
    mean,
    multi_head_attention,
    one_hot,
    pool2d,
    reduce_sum,
    relu,
    reshape,
    scale,
    slice,
    softmax,
    softmax_with_cross_entropy,
    topk,
)
from .sequence import sequence_last_step, sequence_pool
from .tensor import (
    assign,
    cast,
    concat,
    create_global_var,
    create_parameter,
    fill_constant,
    fill_constant_batch_size_like,
    sums,
)
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
