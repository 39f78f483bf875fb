"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

mha_block    <- paddle_tpu/ops/pallas/mha_block.py:_mha_fwd_kernel
flash_decode <- paddle_tpu/ops/pallas/flash_attention.py:_decode_kernel

Sources live in paddle_tpu_torch/csrc/ and are built by `_build` at first
use; importing these modules compiles and loads nothing.
"""
