"""Program-to-program rewrites (counterpart of paddle_tpu/transpiler/).

Ported: the InferenceTranspiler, whose passes fold frozen batch norms
into the convolutions before them, fuse conv + relu and mul + bias add,
fuse the RNN chains (rnn_fuse_passes.py) and take dropout out of an
inference program.
"""

from .inference_transpiler import INFERENCE_PASSES, InferenceTranspiler
from . import rnn_fuse_passes  # noqa: F401  (registers the RNN fusions)

__all__ = ["INFERENCE_PASSES", "InferenceTranspiler"]
