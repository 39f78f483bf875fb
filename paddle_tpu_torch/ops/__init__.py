"""Op library of the serving slice: importing this package registers the
15 op lowerings that transformer.build_decode's programs run (prefill,
step and startup)."""

from . import registry
from . import math_ops
from . import activation_ops
from . import nn_ops
from . import tensor_ops
from . import random_ops
from . import sequence_ops
from . import kv_cache
from . import attention_ops
