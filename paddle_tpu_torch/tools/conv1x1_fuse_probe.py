"""Can a hand-written 1x1 conv that applies the batch-norm affine + relu as
it loads its operand beat the library composite (the affine + relu
materialised, then a cuDNN 1x1 convolution), in a program context?

The port's counterpart of tools/conv1x1_fuse_probe.py: the same four
shapes (the conv3 sites of ResNet-50's bottlenecks at batch 256), the
same RandomState(0) draws, and the same context: the operand y is the
output of a preceding bf16 3x3 convolution.  For each shape it checks
kernel #8 (ops/cuda/bn_relu_conv1x1.py) against the composite at rtol /
atol 2e-2, times both pairs (producer included, as the TPU probe timed
them) with CUDA events, and prints one JSON line.

    python -m paddle_tpu_torch.tools.conv1x1_fuse_probe [--reps N]

It runs on the card only and raises without one.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda import bn_relu_conv1x1 as brc

SHAPES = (  # (B, C, H, K): conv3 sites of the ResNet-50 bottlenecks
    (256, 64, 56, 256), (256, 128, 28, 512),
    (256, 256, 14, 1024), (256, 512, 7, 2048),
)
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores


def draw(b, c, h, k, device):
    """The TPU probe's inputs, from RandomState(0) in its order: x3 and w3
    (the producer's image and 3x3 filter, bf16), the affine A and Bc
    (float32), the 1x1 weight w1 [C, K] (bf16) and its OIHW form w1c."""
    rng = np.random.RandomState(0)

    def bf16(a):
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)

    x3 = bf16(rng.randn(b, c, h, h) * 0.1)
    w3 = bf16(rng.randn(c, c, 3, 3) * 0.02)
    scale = torch.as_tensor((rng.rand(c) + 0.5).astype(np.float32))
    bias = torch.as_tensor((rng.randn(c) * 0.1).astype(np.float32))
    w1 = bf16(rng.randn(c, k) * 0.05)
    w1c = w1.t().reshape(k, c, 1, 1).contiguous()
    return [t.to(device) for t in (x3, w3, scale, bias, w1, w1c)]


def producer(x3, w3):
    """The in-context y: a 3x3 'SAME' convolution, bf16 NCHW."""
    return F.conv2d(x3, w3, padding=1)


def composite(y, scale, bias, w1c):
    """The affine + relu materialised in bf16, then a 1x1 convolution."""
    c = y.shape[1]
    a = torch.relu(y.float() * scale.reshape(1, c, 1, 1)
                   + bias.reshape(1, c, 1, 1)).to(y.dtype)
    return F.conv2d(a, w1c)


def via_composite(x3, w3, scale, bias, w1c):
    return composite(producer(x3, w3), scale, bias, w1c)


def via_kernel(x3, w3, scale, bias, w1):
    return brc.bn_relu_conv1x1(producer(x3, w3), scale, bias, w1)


def cost(b, c, h, k, itemsize=2):
    """(kernel bytes, composite bytes, FLOP) of the 1x1 stage: the kernel
    reads y, w, scale and bias and writes z; the composite also writes
    and reads the activation."""
    hw = h * h
    kernel = itemsize * (b * c * hw + c * k + b * k * hw) + 8 * c
    return kernel, kernel + 2 * itemsize * b * c * hw, 2 * b * hw * c * k


def time_ms(fn, reps, warmup=3):
    """Median CUDA-event time of one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def run_shape(b, c, h, k, device, reps=20):
    x3, w3, scale, bias, w1, w1c = draw(b, c, h, k, device)
    zc = via_composite(x3, w3, scale, bias, w1c).float()
    zk = via_kernel(x3, w3, scale, bias, w1).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(zk, zc, rtol=2e-2, atol=2e-2)
    diff = (zk - zc).abs().max().item()
    del zc, zk
    kernel_bytes, composite_bytes, flop = cost(b, c, h, k)
    t_bytes = kernel_bytes / PEAK_BYTES_PER_S * 1e6
    t_ops = flop / PEAK_BF16_FLOP_PER_S * 1e6
    res = {
        "shape": f"B{b}xC{c}x{h}x{h}->K{k}",
        "producer_ms": time_ms(lambda: producer(x3, w3), reps),
        "composite_ms": time_ms(
            lambda: via_composite(x3, w3, scale, bias, w1c), reps),
        "kernel_ms": time_ms(lambda: via_kernel(x3, w3, scale, bias, w1),
                             reps),
        "kernel_bytes": kernel_bytes, "composite_bytes": composite_bytes,
        "flop": flop, "bound_us": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "max_abs_diff": diff, "device": torch.cuda.get_device_name(device),
    }
    res["kernel_vs_composite"] = res["composite_ms"] / res["kernel_ms"]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("conv1x1_fuse_probe runs on the card: no CUDA "
                           "device")
    device = torch.device("cuda", torch.cuda.current_device())
    results = []
    for shape in SHAPES:
        res = run_shape(*shape, device, args.reps)
        print(json.dumps(res), flush=True)
        results.append(res)
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
