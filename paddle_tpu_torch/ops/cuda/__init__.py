"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

mha_block          <- paddle_tpu/ops/pallas/mha_block.py:_mha_fwd_kernel
                      and _mha_bwd_kernel
flash_decode       <- paddle_tpu/ops/pallas/flash_attention.py:_decode_kernel
flash_decode_paged <- flash_attention.py:_paged_decode_kernel
flash_attention    <- flash_attention.py:_fwd_kernel, _bwd_dq_kernel and
                      _bwd_dkv_kernel
bn_relu_conv1x1    <- tools/conv1x1_fuse_probe.py:fused_kernel

Sources live in paddle_tpu_torch/csrc/ and are built by `_build` at first
use; importing these modules compiles and loads nothing.
"""
