"""Build and time variants of the decode kernels' shared body
(csrc/decode_stream.cuh, kernels #6 and #7): the shared-memory ring
budget, the CTAs an SM must hold, the L2 policy of the K/V copies, the
cluster size, and a per-CTA timeline read from %globaltimer stamps.

    python -m paddle_tpu_torch.tools.decode_variants
        [--ring 16384,24576,32768] [--min-blocks shipped,6]
        [--l2 evict_first,evict_normal] [--ranks 8,16] [--flush read,write]
        [--timeline]

A variant is a patched copy of paddle_tpu_torch/csrc under
build/decode_variants/, compiled with _build's nvcc flags; the wrappers
launch it in place of the shipped library (their ctypes entry is
swapped).  Each variant is timed over decode_trace's cases (median CUDA
event time and profiler device time per call, the L2 flushed before each
call), in two rounds, the second in reverse order.  --min-blocks
"shipped" keeps the source's __launch_bounds__.

--timeline instead builds the shipped configuration with a stamp at six
points of every CTA (entry; the prologue's loads and first copies issued;
the first tile landed; the loop done; both cluster barriers passed) and
prints, per case, percentiles over the CTAs of each phase in
microseconds.  The stamps cost a few instructions a CTA.

It runs on the card only and raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import numpy as np
import torch

from ..ops.cuda import _build, decode_stream
from ..ops.cuda import flash_decode as fd
from ..ops.cuda import flash_decode_paged as fdp
from . import decode_trace as dt

ROOT = _build.BUILD_DIR.parent / "decode_variants"
SOURCES = ("flash_decode", "flash_decode_paged")
RING = "constexpr int kRingBytes = 24 * 1024;"
POLICY = "L2::evict_first"
BOUNDS = "__launch_bounds__(ds::kThreads, ds::min_blocks(D))"
STAMPS = (  # (text in the body, text that replaces it)
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_stamp[1 << 16];\n"
     "#define STAMP(k) do { if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "g_stamp[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
     "blockIdx.x) * 8 + (k)] = t_; } } while (0)"),
    ("  cluster_arrive_relaxed();  // this CTA has started",
     "  STAMP(0);\n  cluster_arrive_relaxed();  // this CTA has started"),
    ("  float m = -INFINITY, l = 0.f;\n",
     "  float m = -INFINITY, l = 0.f;\n  STAMP(1);\n  STAMP(2);\n"),
    ("    const int t = rank + i * a.ranks;\n    const int row0",
     "    if (i == 0) STAMP(2);\n    const int t = rank + i * a.ranks;\n"
     "    const int row0"),
    ("  flash_mma::cp_async_wait<0>();\n",
     "  flash_mma::cp_async_wait<0>();\n  STAMP(3);\n"
     "  if (threadIdx.x == 0) g_stamp[((blockIdx.z * gridDim.y + blockIdx.y)"
     " * gridDim.x + blockIdx.x) * 8 + 6] = mine;\n"),
    ("  cluster_wait();\n  if (threadIdx.x < D / 2) {",
     "  cluster_wait();\n  STAMP(4);\n  if (threadIdx.x < D / 2) {"),
    ("  cluster_wait();  // every rank's triple is in rank 0's shared memory",
     "  cluster_wait();\n  STAMP(5);"),
)
READ_STAMPS = ('\nextern "C" int read_stamps(void* host, int n) {\n'
               '  return (int)cudaMemcpyFromSymbol(host, '
               'decode_stream::g_stamp, (size_t)n * 8);\n}\n')


def _patch(path, old, new):
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"decode_variants: {path.name} no longer holds "
                           f"{old!r} once; update the patch")
    path.write_text(text.replace(old, new))


def build(name, ring=None, min_blocks=None, policy=None, stamps=False):
    """Compile one variant of both sources; returns {source: CDLL}."""
    src = ROOT / name / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    header = src / "decode_stream.cuh"
    if ring is not None:
        _patch(header, RING, f"constexpr int kRingBytes = {ring};")
    if policy is not None:
        _patch(header, POLICY, f"L2::{policy}")
    if stamps:
        for old, new in STAMPS:
            _patch(header, old, new)
    procs = {}
    for source in SOURCES:
        cu = src / f"{source}.cu"
        if min_blocks is not None:
            _patch(cu, BOUNDS, f"__launch_bounds__(ds::kThreads, "
                               f"{min_blocks})")
        if stamps:
            cu.write_text(cu.read_text() + READ_STAMPS)
        out = ROOT / name / f"{source}.so"
        procs[source] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for source, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"decode_variants: {name} {source}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        if spills:
            print(f"# {name} {source}: {spills}", flush=True)
        libs[source] = ctypes.CDLL(str(out))
    return libs


def use(libs):
    """Make the wrappers launch `libs` from their next call on."""
    _build._LIBS.update(libs)
    fd._FN = fdp._FN = None


def timeline(libs, device, flush):
    for name, kind, dtype, lens in dt.CASES:
        fn = dt._inputs(kind, dtype, lens, device)
        for _ in range(3):
            fn()
        flush()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        n = 1 << 16
        host = (ctypes.c_ulonglong * n)()
        lib = libs["flash_decode_paged" if kind == "paged" else "flash_decode"]
        if lib.read_stamps(ctypes.cast(host, ctypes.c_void_p), n) != 0:
            raise RuntimeError("decode_variants: reading the stamps failed")
        ctas = dt.B * dt.H * decode_stream.cluster_ranks(
            dt.REACH if kind == "paged" else 2048)
        st = np.frombuffer(host, np.uint64)[:ctas * 8].reshape(ctas, 8)
        t = (st[:, :6].astype(np.int64) - int(st[:, 0].min())) / 1e3
        mine = st[:, 6].astype(np.int64)
        many = mine > 1

        def pct(x):
            return "/".join(f"{np.percentile(x, q):.2f}" for q in (50, 100))

        print(f"{name:13s} span {t[:, 5].max():6.2f}  start {pct(t[:, 0])}  "
              f"prologue {pct(t[:, 1] - t[:, 0])}  first tile "
              f"{pct(t[:, 2] - t[:, 1])}  per tile "
              f"{pct((t[many, 3] - t[many, 2]) / (mine[many] - 1))}  "
              f"loop end {pct(t[:, 3])}  last rank {pct(t[:, 5] - t[:, 4])}"
              f"  tiles {mine.min()}-{mine.max()}  (us, p50/max)",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", default="24576")
    ap.add_argument("--min-blocks", default="shipped")
    ap.add_argument("--l2", default="evict_first")
    ap.add_argument("--ranks", default=str(decode_stream.CLUSTER))
    ap.add_argument("--flush", default="read,write")
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decode_variants: no CUDA device")
    device = torch.device("cuda", 0)
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device=device)
    flushes = {"write": buf.zero_, "read": buf.view(torch.float32).sum}
    if args.timeline:
        use(build("timeline", stamps=True))
        timeline(_build._LIBS, device, flushes["read"])
        return
    variants = {}
    for ring in args.ring.split(","):
        for mb in args.min_blocks.split(","):
            for l2 in args.l2.split(","):
                name = f"r{ring}_b{mb}_{l2}"
                variants[name] = build(name, int(ring),
                                       None if mb == "shipped" else int(mb),
                                       l2)
    ranks = [int(r) for r in args.ranks.split(",")]
    for rnd in range(2):
        order = list(variants) if rnd == 0 else list(variants)[::-1]
        for name, kind, dtype, lens in dt.CASES:
            fn = dt._inputs(kind, dtype, lens, device)
            for variant in order:
                use(variants[variant])
                for r in ranks:
                    decode_stream.CLUSTER = r
                    for fl in args.flush.split(","):
                        res = dt.measure(fn, flushes[fl], args.reps)
                        print(f"round {rnd} {name:13s} {variant:28s} ranks "
                              f"{r:2d} flush {fl:5s} device "
                              f"{res['device_us']:7.1f} event "
                              f"{res['event_us']:7.1f} us", flush=True)


if __name__ == "__main__":
    main()
