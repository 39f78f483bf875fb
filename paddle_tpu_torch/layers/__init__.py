"""Layer function namespace (counterpart of paddle_tpu/layers/): what
transformer.build_decode, transformer.build, bert.build, resnet.build,
googlenet.build, stacked_lstm.build, machine_translation's build and
build_decode, vgg.build, alexnet.build, mnist's builders,
se_resnext.build and nets call, the clip layers and the learning-rate
schedules, with the generated unary, compare and logical wrappers of
`ops`.  The compares are control_flow's, which
override `ops`' as in the JAX namespace.  Importing it patches
Variable's arithmetic and comparison operators (math_op_patch), as the
JAX package's does."""

from . import (control_flow, io, learning_rate_scheduler, nn, ops,
               sequence, tensor)
from .ops import *  # noqa: F401,F403
from .control_flow import (
    equal,
    greater_equal,
    greater_than,
    increment,
    less_equal,
    less_than,
    not_equal,
)
from .io import data
from .learning_rate_scheduler import (
    cosine_decay,
    exponential_decay,
    inverse_time_decay,
    natural_exp_decay,
    noam_decay,
    piecewise_decay,
    polynomial_decay,
)
from .nn import (
    accuracy,
    batch_norm,
    clip,
    clip_by_norm,
    conv2d,
    cross_entropy,
    dropout,
    elementwise_add,
    elementwise_div,
    elementwise_max,
    elementwise_min,
    elementwise_mul,
    elementwise_op,
    elementwise_pow,
    elementwise_sub,
    embedding,
    fc,
    fused_attention,
    fused_linear_cross_entropy,
    gather,
    gru,
    kv_cache_append,
    layer_norm,
    log_softmax,
    lrn,
    lstm,
    matmul,
    mean,
    multi_head_attention,
    one_hot,
    pool2d,
    prelu,
    reduce_max,
    reduce_mean,
    reduce_min,
    reduce_prod,
    reduce_sum,
    relu,
    reshape,
    scale,
    sigmoid_cross_entropy_with_logits,
    slice,
    softmax,
    softmax_with_cross_entropy,
    square_error_cost,
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
