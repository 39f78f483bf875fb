"""Op library: importing this package registers every op lowering of the
ported slices (transformer.build_decode's programs, and transformer.build
with its backward, optimizer and AMP ops, bert.build's, resnet.build's,
googlenet.build's, stacked_lstm.build's and machine_translation's,
beam_search, vgg's and alexnet's lrn, the inference transpiler's fc,
io.py's save and load ops, the int8 tier's quantized_matmul and
quantized_conv2d, the recurrent tail and the sequence losses, and the
mixture-of-experts pair; the fake-quant ops register in
contrib/quantize.py)."""

from . import registry
from . import math_ops
from . import activation_ops
from . import nn_ops
from . import tensor_ops
from . import random_ops
from . import sequence_ops
from . import kv_cache
from . import attention_ops
from . import loss_ops
from . import optimizer_ops
from . import misc_ops
from . import control_flow_ops
from . import beam_search_ops
from . import rnn_ops
from . import sequence_loss_ops
from . import io_ops
from . import int8_ops
from . import moe_ops
