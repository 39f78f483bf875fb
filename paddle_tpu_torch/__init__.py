"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

Same Fluid contract as the JAX package: `layers.*` build a Program, the
Executor runs it, parameters live in a Scope under the same names.  Op
lowerings are plain torch functions, run eagerly or, on the Executor's
jit path (which decode.Generator and serving.Scheduler take), recorded
into CUDA graphs on the card and replayed; the attention kernels are
CUDA C++ for Hopper (sm_90a) in csrc/.  This package imports neither
jax nor paddle_tpu.

The first slice serves transformer-base through decode.Generator:
prefill and greedy steps, with the mha_block and flash_decode kernels.
The second trains it: `backward.append_backward`, `optimizer` (SGD, Adam
with f32 master weights), `amp.cast_model_to_bf16`, and the mha_block
backward kernel.  The third serves it through `serving.Scheduler`
(continuous batching over a host or device-resident paged KV pool), with
the flash_decode_paged kernel and the flash attention forward.  The
fourth pretrains BERT-base (models.bert) at 2048 tokens through the flash
attention tier, with its backward kernels.  The fifth trains ResNet
(models.resnet: convolutions, pooling, batch norm, Momentum) and carries
the batch-norm + relu + 1x1 conv kernel of the conv1x1 probe
(tools.conv1x1_fuse_probe).  Later slices capture the Executor's steps
as CUDA graphs, train GoogLeNet and the recurrent models, and save, load
and serve a saved model: `io` (the JAX package's file formats),
`transpiler.InferenceTranspiler` and `inference.Predictor`, with VGG and
AlexNet (`nets`, `models.vgg`, `models.alexnet`).  The int8 tier
(`contrib.QuantizeTranspiler`: quantization-aware training, freeze_int8,
convert_to_int8; the quantized_matmul and quantized_conv2d ops on the
card's int8 tensor cores) serves int8 models through the Predictor, the
Scheduler and as a speculative-decoding draft.  The sparse tier
(`sparse`: the host-side embedding service, its shard servers and the
SparseTrainStep that trains CTR DeepFM, `models.ctr_deepfm`),
`resilience.ShardSupervisor` and `checkpoint.CheckpointManager` are
host-side Python like the JAX package's; the dense model runs on the card.
The dense op tails (the tensor, math, random, loss, misc and nn ops, with
their `layers` builders, the TruncatedNormal, MSRA and Bilinear
initializers, `nets.glu` and `nets.scaled_dot_product_attention`) and
the host-side `metrics` and `evaluator` complete the JAX package's
dense surface.
"""

from .framework import (
    Block,
    CPUPlace,
    CUDAPlace,
    Executor,
    Operator,
    Parameter,
    Place,
    Program,
    Scope,
    Variable,
    VarType,
    convert_dtype,
    default_main_program,
    default_place,
    default_startup_program,
    global_scope,
    program_guard,
    scope_guard,
    switch_main_program,
    switch_startup_program,
    unique_name,
)
from . import ops  # registers the op lowerings
from . import flags
from . import initializer
from .layer_helper import LayerHelper, ParamAttr
from . import layers
from . import decode
from . import convert
from . import backward
from . import clip
from . import regularizer
from . import optimizer
from . import average
from . import amp
from . import serving
from . import io
from . import checkpoint
from . import nets
from . import metrics
from . import evaluator
from . import transpiler
from . import inference
# a program loaded from disk with fake-quant ops finds their lowerings
from . import contrib
from .backward import append_backward

__version__ = "0.5.0"
