"""What the int8 product's operand layout costs on the card.

`torch._int_mm` (cuBLASLt's int8 path, which ops/int8_ops.py calls) takes
A [M, K] row-major and B [K, N] in either layout; the kernel cuBLASLt
picks depends on it.  The weights of a frozen program lie in the scope
row-major ([K, N], the JAX package's layout and file format), and
int8_ops makes a column-major copy of B at every call.  For each shape
(transformer-base's decode products at 32 rows, the padded decode batch;
a 2048-row prefill window; VGG-19's 3x3 64->64 conv at 224 as its im2col
GEMM) it prints one JSON line with, for three ways to pass B, whether the
int32 product equals the float64 plain version and the card's busy time
a call (torch.profiler over --reps calls, L2 warm) with its top kernels:

  copied    B copied column-major at every call (what int8_ops does);
  kept      B column-major made once, outside the timed calls;
  row_major B as it lies in the scope.

    python -m paddle_tpu_torch.tools.int8_layout_probe [--reps N]

It runs on the card only and raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import int8_ops

SHAPES = ((32, 512, 512), (32, 512, 32000), (32, 2048, 512),
          (2048, 512, 512), (802816, 576, 64))


def _busy_us(fn, reps):
    """The card's busy time a call (the union of its operations) and the
    two kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (b - a) / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:2]
    return busy / reps, [[k, round(v, 1)] for k, v in top]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_layout_probe: no CUDA device")
    device = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    for m, k, n in SHAPES:
        a = torch.as_tensor(rng.randint(-127, 128, (m, k)),
                            device=device).to(torch.int8)
        b = torch.as_tensor(rng.randint(-127, 128, (k, n)),
                            device=device).to(torch.int8)
        ref = int8_ops.int8_matmul_reference(a, b)
        kept = b.t().contiguous().t()
        ways = {"copied": lambda: torch._int_mm(a, b.t().contiguous().t()),
                "kept": lambda: torch._int_mm(a, kept),
                "row_major": lambda: torch._int_mm(a, b)}
        row = {"m": m, "k": k, "n": n}
        for name, fn in ways.items():
            us, top = _busy_us(fn, args.reps)
            row[name] = {"equal": bool(torch.equal(fn(), ref)),
                         "card_us": round(us, 1), "top_kernels_us": top}
        print(json.dumps(row), flush=True)
        del a, b, ref, kept
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
