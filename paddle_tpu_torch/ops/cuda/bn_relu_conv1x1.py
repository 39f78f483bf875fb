"""Batch-norm affine + relu folded into a 1x1 convolution: the CUDA kernel
(csrc/bn_relu_conv1x1.cu), its wrapper and its plain PyTorch version.

Port of tools/conv1x1_fuse_probe.py's Pallas kernel (`fused_kernel`,
entry `pallas_bn_relu_conv1x1`): y [B, C, H, W], scale/bias [C] float32,
w [C, K] -> z [B, K, H, W] with

    z = w^T . relu(y * scale + bias)

where the activation is computed in float32, rounded to w's dtype, and
the product is summed in float32 and returned in y's dtype.  The kernel
never writes the activation to device memory.

`bn_relu_conv1x1` runs the plain version for tensors on the CPU (and on
the meta device) and launches the kernel for tensors on the card;
anything else raises.  In bfloat16 the kernel is a pipelined tensor-core
GEMM (`bn_relu_conv1x1_mma_kernel`) and y, w and z must start on 16 bytes
(a misaligned view raises); float32 runs a SIMT kernel.  `launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def bn_relu_conv1x1_reference(y, scale, bias, w):
    """The plain PyTorch version: relu(float(y) * scale + bias) rounded to
    w's dtype, a float32 product, rounded to y's dtype."""
    b, c, h, wd = y.shape
    a = torch.relu(y.float() * scale.float().reshape(1, c, 1, 1)
                   + bias.float().reshape(1, c, 1, 1)).to(w.dtype)
    z = torch.matmul(w.float().t(), a.float().reshape(b, c, h * wd))
    return z.to(y.dtype).reshape(b, w.shape[1], h, wd)


def _lib():
    lib = _build.load("bn_relu_conv1x1")
    fn = lib.bn_relu_conv1x1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(y, scale, bias, w):
    global launches
    if any(t.device != y.device for t in (scale, bias, w)):
        raise ValueError("bn_relu_conv1x1: y, scale, bias, w must be on one "
                         "device")
    if y.dtype not in _DTYPES or w.dtype != y.dtype:
        raise ValueError(f"bn_relu_conv1x1: dtypes {y.dtype}/{w.dtype}; the "
                         "kernel takes float32 or bfloat16 y and w, alike")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("bn_relu_conv1x1: scale and bias must be float32")
    if y.dim() != 4 or w.dim() != 2:
        raise ValueError(f"bn_relu_conv1x1: shapes y {tuple(y.shape)}, w "
                         f"{tuple(w.shape)}; want [B, C, H, W] and [C, K]")
    b, c, h, wd = y.shape
    k = w.shape[1]
    if w.shape[0] != c or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"bn_relu_conv1x1: y {tuple(y.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)} disagree on C")
    if not all(t.is_contiguous() for t in (y, scale, bias, w)):
        raise ValueError("bn_relu_conv1x1: y, scale, bias and w must be "
                         "contiguous")
    z = torch.empty((b, k, h, wd), dtype=y.dtype, device=y.device)
    rc = _lib()(y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                w.data_ptr(), z.data_ptr(), b, c, k, h * wd, _DTYPES[y.dtype],
                torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_relu_conv1x1 kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return z


def bn_relu_conv1x1(y, scale, bias, w):
    """y [B,C,H,W], scale/bias [C] f32, w [C,K] -> [B,K,H,W]: the kernel
    for tensors on the card, the plain version for tensors on the CPU or
    meta device."""
    if y.device.type in ("cpu", "meta"):
        return bn_relu_conv1x1_reference(y, scale, bias, w)
    if y.device.type != "cuda":
        raise ValueError(f"bn_relu_conv1x1: no kernel for device {y.device}")
    return _launch(y, scale, bias, w)
