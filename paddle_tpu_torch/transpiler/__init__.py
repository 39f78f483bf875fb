"""Program-to-program rewrites (counterpart of paddle_tpu/transpiler/).

Ported: the InferenceTranspiler, whose passes fold frozen batch norms
into the convolutions before them, fuse conv + relu and mul + bias add,
and take dropout out of an inference program.
"""

from .inference_transpiler import INFERENCE_PASSES, InferenceTranspiler

__all__ = ["INFERENCE_PASSES", "InferenceTranspiler"]
