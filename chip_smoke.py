#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of the JAX package.  Phases, none of which
catches its own failure:

  1. the card: name, count, power limit;
  2. build every kernel from paddle_tpu_torch/csrc (one nvcc per source,
     started together) and print nvcc's -Xptxas -v report;
  3. each kernel at its main paths' shapes (transformer-base: d_model 512,
     8 heads of 64; serving in float32 at batch 8, training at batch 16
     in float32 and batch 128 in bfloat16, the Scheduler's paged decode
     over a 2560-block pool and its 2048-token causal prefill in float32
     and bfloat16) against its plain PyTorch version on the card
     (float32: max abs error <= 1e-4; bfloat16: 2e-2, of the output's
     largest magnitude for the backward; the flash forward's lse 1e-4),
     and the flash tier's forward (#3) and backward (#4 dQ, #5 dK/dV) at
     BERT-base pretraining's shapes (batch 16 x 2048 tokens and batch 8 x
     4096, 12 heads of 64, masked and unmasked, bfloat16 and float32) and
     at transformer widths (causal 2048, a causal Sq < Sk offset, an
     off-grid 1000 with a kv_len-0 row), and kernel #8 (batch-norm affine
     + relu folded into a 1x1 conv) at ResNet-50's four conv3 sites
     (batch 256, bfloat16: 2e-2 of the output's largest magnitude) and a
     float32 case, and last the bfloat16 backward at head_dim 128 (#2 at
     T2's shape with 4 heads of 128, #4 and #5 at L2's with 6), #7 at
     phase S's real lengths (1024-2080) in both dtypes and #6 in
     bfloat16; one call of #6 or #7 must be exactly one launch of its
     kernel in a profiler trace (no merge, cast or scratch kernel);
     then timed with CUDA events, L2 flushed before every launch: kernel,
     plain version, and the library yardstick the port never calls
     (F.scaled_dot_product_attention with an equivalent mask, over a
     pre-gathered dense view for the paged kernel, and for the backward
     its autograd backward alone; for #8 a cuDNN 1x1 conv on the
     activation materialised beforehand, and the composite: the affine +
     relu materialised, then that conv), beside the least time the card could
     take (bytes over 3.35 TB/s, or FLOP over 67 TFLOP/s for float32 and
     989 TFLOP/s for bfloat16 inputs), and for bfloat16 the TFLOP/s on
     the device time (for #2 also what its kernels compute: S and dP
     three times over);
  4. serving: decode.Generator(...).generate, greedy, on
     transformer.base() with seeded random weights, in two phases
     (A: translation, 256-token sources and short prefixes; B: a long
     cache, 1024-token prefixes in a 2048-slot cache).  Each phase's
     kernel launch counts are set to 0 just before generate and read just
     after, and must equal what the gate predicts.  Then the same feeds
     through the composite tier (flash_attention "0"): prefill and
     teacher-forced step logits must agree within 1e-3.  Phase A's feeds
     then go through serving.Scheduler at its default paged_kv=False
     (host BlockPool, dense gather per step), counted the same way; every
     request's tokens must equal the sequential batch-1 Generator's.
     Phase Beam: generate(method="beam", beam_size=4) at phase A's feeds
     (8 sources, so the step runs at 32 rows): beam 1 must give greedy's
     tokens, beam 4's tokens and scores must equal the same search under
     Generator(mode="interpret") (scores within 1e-5), best beam first,
     and its launches the gate's prediction.  Every serving program of
     [4] and [5] runs through the Executor's jit path: eagerly at a
     signature's first call, captured as a CUDA graph at its second,
     replayed after; each phase prints the graphs it captured (and their
     seconds), replayed and warmed up, and its peak memory;
  5. serving through the Scheduler, phase S: paged_kv=True (the pool on
     the card, the rewritten step program) on transformer.base(), 2048-
     token prompt windows with ragged prompts of 1024-2048 tokens, a
     4096-slot cache, blocks of 16, 8 slots.  16 requests of 32 tokens:
     a second wave of 8 submitted after the first wave's 4th decode step
     and admitted while the first still decodes, one prompt repeated (a
     prefix-cache hit), one request evicted mid-flight (it replays).
     Launch counts are set to 0 before and read after and must equal the
     gate's prediction from the scheduler's own step and prefill counts;
     the profiles of phases B and S give #6's and #7's card ms per step
     and share of the busy time; before the counted run, uncounted
     traffic of the same shapes on other prompts captures its programs,
     and after it the captured step at one signature is held against an
     eager replay of its ops on the same feed (logits within 1e-5, equal
     launch counts);
     every request's tokens must equal the sequential Generator's; the
     pool must drain to 0 blocks; tokens/s, TTFT, ms per decode step and
     a profile of a few steps are printed.  Then, on the same weights,
     blocks of 16, 8 slots and S's request feeds (each phase its own
     seed):
     V, speculative decoding (build_decode(verify_len=4), spec_k 4, 8
     requests of 32 tokens, prompts of 1024-2048, a prefix hit, an
     eviction after the 2nd round), in two legs: V/trunc, the draft is
     build_draft(tier="trunc") (3 decoder layers on the target's
     scope); V/self, the draft is the target's own configuration, so
     every proposal must be accepted.  Reported: rounds, proposals,
     acceptance, tokens per row and round, host ms per round, and, from a
     profile of 4 rounds, card busy per round split into the draft steps
     and the verify window (a replayed graph runs no Python, so a range
     around a function inside a captured program would see nothing);
     C, chunked prefill (build_decode(chunk_len=512), prefill_chunk 512):
     after uncounted warm-up traffic of the same shapes, 4 prompts of
     256-512 tokens prefill whole and decode; after their 2nd step 4 of
     1024-2048 arrive and run 512-row windows, one per iteration after the
     decode step; one of them is exported after its first window and
     imported into a second Scheduler.  Reported: chunk passes and ms per
     pass, the gaps between decode steps, TTFT, and card busy per pass;
     then the C10 line: C's longest decode gap against S's longest
     monolithic prefill iteration, in the same run;
     H, the two-tier handoff: a prefill tier (prefill_chunk 512, blocks of
     16) runs 4 prompts with prefill_only=True and a decode tier with
     blocks of 32 resumes each from its record (kv_payload,
     recorded_tokens).  Reported: payload bytes, export and adoption ms.
     Each of V, C and H asserts the launch counts the gate predicts from
     the schedulers' counters, tokens equal to the sequential
     Generator's, and a drained pool;
  6. training: transformer.build + Adam(1e-4) through Executor.run on
     transformer.base() (seq 256, random tokens from a seed), on the
     default (jit) path: each training step after its signature's eager
     warm-up is one captured CUDA graph, its parameters and moments
     donated (written in place), and after a phase every graph must bind
     every argument but the feeds (none copied in at a call).  T1,
     float32, dropout 0, batch 16, ragged source lengths 128-256: 4
     steps with the launch counts set to 0 before and 18 forward and 18
     backward mha_block launches a step after; the same 4 steps from the
     same weights through the composite must give the same losses (rtol
     1e-4); then 4 steps each run twice from the same persistables and
     run counter, by the interpreter (mode="interpret") and by the
     captured graph, losses within rtol 1e-5.  T2, bench.py's
     transformer configuration (dropout 0, batch 128, bf16 AMP, Adam
     multi_precision): 2 warm-up (eager, capture) and 5 timed replays,
     tokens/s, ms per step, card busy time and idle share (profiled, and
     1 - card / host), #1's and #2's card time and share of it, graphs,
     capture seconds, graph-pool MiB, peak memory and MFU; its first loss
     must match the composite's within 2e-2.  T2/drop, T2's step at the
     published dropout 0.1 (44 dropouts a step): the warm-up and the
     capture each equal the interpreter's step from the same state and
     counter (rtol 1e-5), the same numbers as T2; every step fetches the
     first dropout's mask: the last two (two consecutive replays) differ
     and 0.9 +- 0.001 of each is kept;
  7. BERT-base masked-LM pretraining at 2048 tokens through
     bert.build + Adam(1e-4) + Executor.run on the jit path (dropout 0,
     random tokens and ragged input masks of 1024-2048 real tokens from a
     seed): every attention takes the flash tier, forward (#3) and grad
     (#3 again to recompute out and lse, then #4 and #5).  L1, float32,
     batch 2: 3 steps with the launch counts set to 0 before and exactly
     24 #3, 12 #4 and 12 #5 launches a step after; the same steps from
     the same weights through the composite give the same losses (rtol
     1e-4); 3 steps jit vs interpret as T1.  L2, bench.py's
     long_2048_masked leg (batch 16, bf16 AMP, Adam multi_precision): 2
     warm-up, 3 timed and 1 profiled step, T2's numbers and the flash
     kernels' card time and share; its first loss must match the
     composite's within 2e-2;
  8. ResNet-50 training through resnet.build(dataset="imagenet",
     fused_loss=True) + Momentum + Executor.run on the jit path (224x224
     images, 1000 classes, images and labels drawn as bench.py draws
     them).  R1, float32, batch 8, Momentum(1e-5, 0.9): 3 steps on the
     card and the same 3 on the port's CPU path from the same weights,
     losses within rtol 1e-3, every forward conv of the steps that ran
     their ops (warm-ups, captures) with cuDNN's TF32 off; 3 steps jit vs
     interpret as T1.  R2, bench.py's resnet50 step (batch 256, bf16
     AMP, Momentum(0.1, 0.9, multi_precision=True)): 2 warm-up, 3 timed
     and 1 profiled step, img/s, MFU and T2's numbers, the top kernels;
     its first loss within 2e-2 of a float32 forward of the same weights
     and batch; no kernel of the port runs in it.  R/probe: kernel #8 at
     the 16 conv3 sites of one more R2 step (conv2's output, the BN's
     saved statistics and affine, conv3's filter) against the port's own
     batch_norm + relu + conv2d, exactly 16 launches; then the conv1x1
     probe (paddle_tpu_torch.tools.conv1x1_fuse_probe) at its four
     shapes;
  9. GoogLeNet training, phase G: bench.py's googlenet leg
     (googlenet.build(with_aux=True), batch 128, 3x224x224, 1000
     classes, bf16 AMP, Momentum(0.01, 0.9, multi_precision=True),
     random_seed 1, the feed from RandomState(0)) on the jit path: 2
     warm-up, 5 timed and 1 profiled step, img/s and T2's numbers, finite
     losses, no port kernel; then the float32 clone(for_test=True)
     forward loss at batch 8 on the card within rtol 1e-3 of the port's
     CPU path;
 10. one {"kernels": [...]} line, the card's name and power limit, and
     last the {"ok": true, "device": ...} line.

Exits non-zero, printing no result, when there is no CUDA device or when
any check fails.  A served request whose tokens differ from the
sequential Generator's is reported with its first diverging step and the
sequential run's top-2 logit gap there, the remaining phases still run
for their numbers, and the script then exits 1.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 2024
BATCH = 8
NEW_TOKENS = 32
SRC_LEN = 256
PHASES = {
    # name: (prefix_len, ragged prefix range, cache max_len)
    "A": (8, (1, 8), 256),
    "B": (1024, (512, 1024), 2048),
}
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FLOP_PER_S = {           # H100 SXM, dense
    torch.float32: 67e12,     # float32, outside the tensor cores
    torch.bfloat16: 989e12,   # bfloat16 tensor cores
}
TOL = 1e-4                    # kernel vs plain version, float32
BF16_TOL = 2e-2               # kernel vs plain version, bfloat16
LOGITS_TOL = 1e-3             # kernel tiers vs composite, end to end
TF_STEPS = 4                  # teacher-forced steps compared
SEQ = 256                     # training sequence length (bench.py's)
T1_BATCH, T1_STEPS = 16, 4
T2_BATCH, T2_WARMUP, T2_STEPS, T2_PROFILED = 128, 2, 5, 2
LOSS_RTOL_F32 = 1e-4          # T1: kernels vs composite, float32
LOSS_RTOL_BF16 = 2e-2         # T2: first loss, kernels vs composite
LSE_TOL = 1e-4                # flash forward's float32 lse vs plain
PARITY_TOL = 1e-5             # captured vs eager replay of S's step logits
BEAM_K = 4                    # phase Beam's beam_size
BEAM_TOL = 1e-5               # phase Beam: scores, captured vs interpret
# phase S: the Scheduler over the device pool
S_WINDOW, S_PROMPTS, S_MAX_LEN = 2048, (1024, 2048), 4096
S_BLOCK, S_SLOTS, S_PROFILED = 16, 8, 6
# phase L: BERT-base pretraining at 2048 tokens (bench.py's long_2048
# legs: batch max(64 // (S // 512), 4))
L_SEQ = 2048
L1_BATCH, L1_STEPS = 2, 3
L2_BATCH, L2_WARMUP, L2_STEPS, L2_PROFILED = 16, 2, 3, 1
BWD_REPS = 10                 # timed launches of each flash backward case
# phase R: ResNet-50 training (bench.py's resnet50 leg: batch 256, 224x224
# images, 1000 classes, bf16 AMP, Momentum(0.1, 0.9, multi_precision))
R_CLASSES, R_HW = 1000, 224
# R1's learning rate: at bench.py's 0.1 a 3-step float32 trajectory at
# batch 8 is chaotic (a 1e-7 relative change of the images moves the third
# loss by 3% on the port's own CPU path); at 1e-5 it moves it by 2.7e-5
# while the loss still falls 14% in 3 steps
R1_BATCH, R1_STEPS, R1_LR = 8, 3, 1e-5
R1_LOSS_RTOL = 1e-3           # card vs the port's CPU path, float32
R2_BATCH, R2_WARMUP, R2_STEPS, R2_PROFILED = 256, 2, 3, 1
RESNET50_FWD_FLOPS = 4.089e9  # per 224x224 image (bench.py:67)
R_SITES = 16                  # conv3 sites: ResNet-50's 16 bottlenecks
JIT_RTOL = 1e-5               # a step's loss, jit vs interpret (expected 0)
KEEP_TOL = 1e-3               # T2/drop: |kept share of a mask - 0.9|
# phase G: GoogLeNet training (bench.py's googlenet leg, bench.py:497-545
# and _setup :186-202: batch 128, 3x224x224, 1000 classes, with_aux, bf16
# AMP, Momentum(0.01, 0.9, multi_precision), random_seed 1, the feed from
# RandomState(0))
G_BATCH, G_WARMUP, G_STEPS, G_PROFILED = 128, 2, 5, 1
G_CHECK_BATCH = 8             # G's float32 test forward, card vs CPU
G_LOSS_RTOL = 1e-3            # cuDNN and the CPU sum in other orders

KERNELS = {
    "mha_block": {
        "source": "paddle_tpu_torch/csrc/mha_block.cu",
        "replaces": "paddle_tpu/ops/pallas/mha_block.py:109",
        # float32 (SIMT), bf16 (tensor cores), Sq = 1 (both dtypes)
        "device_names": ("mha_fwd_kernel", "mha_fwd_mma_kernel",
                         "mha_decode_kernel"),
    },
    "mha_block_bwd": {
        "source": "paddle_tpu_torch/csrc/mha_block_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/mha_block.py:120",
        # float32 (SIMT), bf16 (tensor cores: stats, dQ, dK/dV)
        "device_names": ("mha_bwd_dq_kernel", "mha_bwd_dkv_kernel",
                         "mha_bwd_stats_mma_kernel", "mha_bwd_dq_mma_kernel",
                         "mha_bwd_dkv_mma_kernel"),
    },
    "flash_decode": {
        "source": "paddle_tpu_torch/csrc/flash_decode.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:630",
        # one cluster launch a call (body in csrc/decode_stream.cuh)
        "device_names": ("dense_decode_kernel",),
    },
    "flash_decode_paged": {
        "source": "paddle_tpu_torch/csrc/flash_decode_paged.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:793",
        "device_names": ("paged_decode_kernel",),
    },
    "flash_attention_fwd": {
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:205",
        # flash_fwd_kernel: float32 (SIMT); flash_fwd_mma_kernel: bf16
        "device_names": ("flash_fwd_kernel", "flash_fwd_mma_kernel"),
    },
    "flash_attention_bwd_dq": {
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:318",
        # float32 (SIMT), bf16 (tensor cores)
        "device_names": ("flash_bwd_dq_kernel", "flash_bwd_dq_mma_kernel"),
    },
    "flash_attention_bwd_dkv": {
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:354",
        # float32 (SIMT), bf16 (tensor cores)
        "device_names": ("flash_bwd_dkv_kernel", "flash_bwd_dkv_mma_kernel"),
    },
    "bn_relu_conv1x1": {
        "source": "paddle_tpu_torch/csrc/bn_relu_conv1x1.cu",
        "replaces": "tools/conv1x1_fuse_probe.py:21",
        # float32 (SIMT), bf16 (tensor cores)
        "device_names": ("bn_relu_conv1x1_kernel",
                         "bn_relu_conv1x1_mma_kernel"),
    },
}
# served requests whose tokens differed from the sequential Generator's:
# reported at the end, after every phase ran (the script then exits 1)
DIVERGED = []


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ---------------------------------------------------------------- timing


def device_spans(prof):
    """(name, start_us, end_us) of every operation the card ran inside a
    torch.profiler window."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


def busy_us(spans):
    """Time the card was busy: the union of the spans."""
    total, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class Timer:
    """Times one call on the card, with the L2 cache (50 MB) flushed
    before every launch: on the main path each attention reads K/V that
    six other layers' traffic has pushed out of it.

    `ms`: median CUDA-event time around the call (what a caller waits,
    the wrapper's own small copies and launch gaps included).
    `device_ms`: the card's time in the kernels whose names contain
    `names`, per call, from a torch.profiler trace."""

    def __init__(self, device, reps=20, warmup=3):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        self.reps, self.warmup = reps, warmup

    def ms(self, fn, reps=None):
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def device_ms(self, fn, names, reps=None):
        from torch.profiler import ProfilerActivity, profile

        reps = reps or self.reps
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        mine = [s for s in device_spans(prof)
                if any(n in s[0] for n in names)]
        if not mine:
            return None   # the profiler saw no device activity
        return sum(b - a for _, a, b in mine) / reps / 1e3


def device_ops_of_one_call(fn, tries=3):
    """The names of the operations the card ran for one call of fn (after
    a warm-up call), from a torch.profiler trace.  A trace that holds no
    operation of the card at all (the profiler saw nothing, which happens
    now and then) is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [name for name, _, _ in device_spans(prof)]
        if names:
            break
    return names


# ------------------------------------------------------- kernel checks


def _us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def _lengths(rng, lo, hi, n, device):
    return torch.as_tensor(rng.randint(lo, hi + 1, size=n).astype(np.int64),
                           device=device)


def _sdpa_mask(lens, b, sq, sk, device):
    keys = torch.arange(sk, device=device)
    return (keys[None, :] < lens[:, None]).reshape(b, 1, 1, sk).expand(
        b, 1, sq, sk)


def _heads(x, h):
    b, s, hd = x.shape
    return x.view(b, s, h, hd // h).transpose(1, 2)


def _live(b, sq, sk, causal, key_len, uniform_empty=False):
    """Live (query, key) pairs and live key rows per image, as the kernels
    visit them: keys past key_len and above the causal diagonal are
    skipped.  uniform_empty (mha_block): an image with key_len <= 0 is the
    mean of V over every key, so its rows see all Sk keys, causal or not."""
    kl = [sk] * b if key_len is None else key_len.tolist()
    off = sk - sq
    pairs = rows = 0
    for n in kl:
        if uniform_empty and n <= 0:
            pairs += sq * sk
            rows += sk
            continue
        if causal:
            pairs += sum(min(r + off + 1, n) for r in range(sq))
        else:
            pairs += sq * min(sk, n)
        rows += min(sk, n)
    return pairs, rows


def _shape(b, sq, sk, hd, causal, lens, dtype):
    return (f"q {b}x{sq}x{hd} k {b}x{sk}x{hd}{' causal' if causal else ''}"
            f"{'' if lens is None else f' key_len {lens[0]}-{lens[1]}'}"
            f" {str(dtype).replace('torch.', '')}")


def mha_case(name, b, sq, sk, h, d, causal, lens, device, rng,
             dtype=torch.float32, empty_first=False):
    """Kernel #1; with empty_first, image 0 has key_len 0 (the mean of V
    over every key)."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               .to(dtype) for s in (sq, sk, sk))
    key_len = None if lens is None else _lengths(rng, *lens, b, device)
    if empty_first:
        key_len[0] = 0
    pairs, rows = _live(b, sq, sk, causal, key_len, uniform_empty=True)
    item = q.element_size()
    nbytes = item * h * d * (2 * b * sq + 2 * rows) + (
        0 if key_len is None else key_len.numel() * key_len.element_size())
    from paddle_tpu_torch.ops.cuda import mha_block

    kernel = lambda: mha_block.mha_attention(q, k, v, h, causal,  # noqa: E731
                                             key_len=key_len)
    plain = lambda: mha_block.mha_reference(q, k, v, h, causal,  # noqa: E731
                                            key_len=key_len)
    mask = (None if key_len is None
            else _sdpa_mask(key_len, b, sq, sk, device))
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None)
    # bf16 Sq > 1 runs two sweeps: Q K^T twice, P V once
    two_sweeps = dtype == torch.bfloat16 and sq > 1
    return dict(kernel="mha_block", case=name, fns=(kernel, plain, library),
                shape=_shape(b, sq, sk, h * d, causal, lens, dtype)
                + (" key_len[0] 0" if empty_first else ""),
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                flop=4 * d * h * pairs, bytes=nbytes,
                exec_flop=(6 if two_sweeps else 4) * d * h * pairs)


def bwd_case(name, b, sq, sk, h, d, causal, lens, device, rng, dtype):
    """Kernel #2 at a training shape: dq, dk, dv from q, k, v, dO."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v, dout = (torch.randn((b, s, h * d), generator=g, device=device)
                     .to(dtype) for s in (sq, sk, sk, sq))
    key_len = None if lens is None else _lengths(rng, *lens, b, device)
    pairs, rows = _live(b, sq, sk, causal, key_len)
    item = q.element_size()
    # q, dO read and dq written; k, v read where live; dk, dv written
    nbytes = item * h * d * (3 * b * sq + 2 * rows + 2 * b * sk) + (
        0 if key_len is None else key_len.numel() * key_len.element_size())
    from paddle_tpu_torch.ops.cuda import mha_block

    kernel = lambda: mha_block.mha_block_bwd(  # noqa: E731
        q, k, v, dout, h, causal, key_len=key_len)
    plain = lambda: mha_block.mha_block_bwd_reference(  # noqa: E731
        q, k, v, dout, h, causal, key_len=key_len)
    mask = (None if key_len is None
            else _sdpa_mask(key_len, b, sq, sk, device))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *(_heads(x, h) for x in leaves), attn_mask=mask,
        is_causal=causal and mask is None)
    g_heads = _heads(dout, h).contiguous()
    library = lambda: torch.autograd.grad(  # noqa: E731
        out, leaves, g_heads, retain_graph=True)
    return dict(kernel="mha_block_bwd", case=name,
                fns=(kernel, plain, library),
                shape=_shape(b, sq, sk, h * d, causal, lens, dtype),
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                # dS K, dS^T q, P^T dO and the two recomputed products
                flop=5 * 2 * d * h * pairs, bytes=nbytes,
                # what the kernels compute: S and dP three times over
                # (statistics, dQ, dK/dV), then the three products
                exec_flop=9 * 2 * d * h * pairs)


def decode_case(name, b, sk, h, d, lens, device, rng, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               .to(dtype) for s in (1, sk, sk))
    kv_len = _lengths(rng, *lens, b, device)
    live = sum(min(sk, n) for n in kv_len.tolist())
    from paddle_tpu_torch.ops.cuda import flash_decode

    kernel = lambda: flash_decode.flash_decode(q, k, v, h,  # noqa: E731
                                               kv_len=kv_len)
    plain = lambda: flash_decode.flash_decode_reference(  # noqa: E731
        q, k, v, h, kv_len=kv_len)
    mask = _sdpa_mask(kv_len, b, 1, sk, device)
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask)
    return dict(kernel="flash_decode", case=name, fns=(kernel, plain, library),
                shape=f"q {b}x1x{h * d} k {b}x{sk}x{h * d} "
                      f"kv_len {lens[0]}-{lens[1]} "
                      f"{str(dtype).replace('torch.', '')}",
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                flop=4 * d * h * live,
                bytes=q.element_size() * h * d * (2 * b + 2 * live)
                + kv_len.numel() * kv_len.element_size())


def paged_case(name, b, n, bs, lens, h, d, device, rng, dtype):
    """Kernel #7 at the Scheduler's decode step: pools [n, bs, H*D], one
    table row of max_len / bs block ids per request, drawn from a random
    permutation of the pool."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    hd = h * d
    m = S_MAX_LEN // bs
    q = torch.randn((b, 1, hd), generator=g, device=device).to(dtype)
    kb, vb = (torch.randn((n, bs, hd), generator=g, device=device).to(dtype)
              for _ in range(2))
    table = torch.as_tensor(rng.permutation(n)[:b * m].reshape(b, m),
                            device=device)
    lengths = _lengths(rng, *lens, b, device)
    live = sum(lengths.tolist())
    from paddle_tpu_torch.ops.cuda import flash_decode_paged as fdp

    kernel = lambda: fdp.flash_decode_paged(  # noqa: E731
        q, kb, vb, table, lengths, h)
    plain = lambda: fdp.flash_decode_paged_reference(  # noqa: E731
        q, kb, vb, table, lengths, h)
    # the library call reads a dense view gathered beforehand (not timed)
    kd, vd = (_heads(t[table.reshape(-1)].reshape(b, m * bs, hd), h)
              for t in (kb, vb))
    mask = _sdpa_mask(lengths, b, 1, m * bs, device)
    qh = _heads(q, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kd, vd, attn_mask=mask)
    item = q.element_size()
    return dict(kernel="flash_decode_paged", case=name,
                fns=(kernel, plain, library),
                shape=f"q {b}x1x{hd} pool {n}x{bs}x{hd} table {b}x{m} "
                      f"lengths {lens[0]}-{lens[1]} "
                      f"{str(dtype).replace('torch.', '')}",
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                flop=4 * d * h * live,
                bytes=item * hd * (2 * b + 2 * live)
                + table.numel() * table.element_size()
                + lengths.numel() * lengths.element_size())


def flash_case(name, b, sq, sk, h, d, causal, lens, device, rng, dtype,
               zero_row=False):
    """Kernel #3's forward: (out, lse).  zero_row sets row 0's kv_len to
    0, which must give out 0 and lse -1e30."""
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               .to(dtype) for s in (sq, sk, sk))
    kv_len = None if lens is None else _lengths(rng, *lens, b, device)
    if zero_row:
        kv_len[0] = 0
    pairs, rows = _live(b, sq, sk, causal, kv_len)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    kernel = lambda: fa.flash_attention_lse(q, k, v, h, causal,  # noqa: E731
                                            kv_len=kv_len)
    plain = lambda: fa.flash_attention_fwd_reference(  # noqa: E731
        q, k, v, h, causal, kv_len=kv_len)
    mask, is_causal = _flash_mask(kv_len, b, sq, sk, causal, device)
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, is_causal=is_causal)
    item = q.element_size()
    # q read, out written, live K and V rows read, lse written
    nbytes = item * h * d * (2 * b * sq + 2 * rows) + 4 * b * h * sq + (
        0 if kv_len is None else kv_len.numel() * kv_len.element_size())
    lens_tag = lens if not zero_row else (0, lens[1])
    return dict(kernel="flash_attention_fwd", case=name,
                fns=(kernel, plain, library),
                shape=_shape(b, sq, sk, h * d, causal, lens_tag, dtype),
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                err=_flash_err, zero_row=zero_row,
                flop=4 * d * h * pairs, bytes=nbytes)


def _flash_err(out, ref, dtype, zero_row):
    """Max abs error of the flash forward's out; its lse must agree within
    LSE_TOL, and a kv_len-0 row 0 must give out 0 and lse -1e30."""
    (o, lse), (ro, rlse) = out, ref
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        return float("inf")
    lse_err = (lse - rlse).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention_fwd: lse error {lse_err}")
    if zero_row and not (torch.count_nonzero(o[0]).item() == 0
                         and bool((lse[0] == -1e30).all())):
        raise AssertionError("flash_attention_fwd: the kv_len-0 row is not "
                             "out 0, lse -1e30")
    return (o.float() - ro.float()).abs().max().item()


def _flash_mask(kv_len, b, sq, sk, causal, device):
    """(attn_mask or None, is_causal) giving SDPA the flash tier's live
    pairs: kv_len, and the (Sk - Sq)-offset causal diagonal."""
    mask = None
    if kv_len is not None:
        mask = _sdpa_mask(kv_len, b, sq, sk, device)
    if causal and (mask is not None or sq != sk):
        tri = torch.ones((sq, sk), dtype=torch.bool,
                         device=device).tril(sk - sq)
        mask = tri if mask is None else mask & tri
    return mask, causal and mask is None


def flash_bwd_cases(name, b, sq, sk, h, d, causal, lens, device, rng, dtype,
                    zero_row=False):
    """Kernels #4 and #5 at one shape, one case each, from the plain
    forward's lse and delta (with no lse cotangent, as in the grad op).
    Each case makes its inputs, and the library yardstick's forward
    graph, when it runs, so that only one shape's tensors are alive at a
    time.  zero_row sets row 0's kv_len to 0, which must give dq = dk =
    dv = 0 there."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    seed = int(rng.randint(1 << 30))
    kv_len = None if lens is None else _lengths(rng, *lens, b, device)
    if zero_row:
        kv_len[0] = 0
    pairs, rows = _live(b, sq, sk, causal, kv_len)
    item = torch.empty((), dtype=dtype).element_size()
    # lse and delta read (float32 per row and head), and the lengths
    extra = 8 * b * h * sq + (
        0 if kv_len is None else kv_len.numel() * kv_len.element_size())

    def make(which):
        g = torch.Generator(device=device).manual_seed(seed)
        q, k, v, dout = (torch.randn((b, s, h * d), generator=g,
                                     device=device).to(dtype)
                         for s in (sq, sk, sk, sq))
        out, lse = fa.flash_attention_fwd_reference(q, k, v, h, causal,
                                                    kv_len=kv_len)
        delta = fa.bwd_delta(out, dout, h)
        del out
        args = (q, k, v, dout, lse, delta, h, causal)
        if which == "dq":
            kernel = lambda: (fa.flash_attention_bwd_dq(  # noqa: E731
                *args, kv_len=kv_len),)
            plain = lambda: fa.bwd_reference(  # noqa: E731
                *args, 0.0, kv_len)[:1]
        else:
            kernel = lambda: fa.flash_attention_bwd_dkv(  # noqa: E731
                *args, kv_len=kv_len)
            plain = lambda: fa.bwd_reference(  # noqa: E731
                *args, 0.0, kv_len)[1:]
        mask, is_causal = _flash_mask(kv_len, b, sq, sk, causal, device)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *(_heads(x, h) for x in leaves), attn_mask=mask,
            is_causal=is_causal)
        g_heads = _heads(dout, h).contiguous()
        library = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, g_heads, retain_graph=True)
        return kernel, plain, library

    shape = _shape(b, sq, sk, h * d, causal,
                   lens if not zero_row else (0, lens[1]), dtype)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    common = dict(case=name, shape=shape, dtype=dtype, tol=tol,
                  err=_bwd_err, zero_row=zero_row, reps=BWD_REPS)
    return [
        # QK^T, dO V^T and dS K on every live pair
        dict(kernel="flash_attention_bwd_dq", fns=functools.partial(
            make, "dq"), flop=6 * d * h * pairs,
            bytes=item * h * d * (3 * b * sq + 2 * rows) + extra, **common),
        # QK^T, dO V^T, P^T dO and dS^T q; dK and dV written for every key
        dict(kernel="flash_attention_bwd_dkv", fns=functools.partial(
            make, "dkv"), flop=8 * d * h * pairs,
            bytes=item * h * d * (2 * b * sq + 2 * rows + 2 * b * sk)
            + extra, **common),
    ]


def conv1x1_case(name, b, c, h, k, device, rng, dtype):
    """Kernel #8 at a conv3 site of ResNet-50's bottlenecks: y [B,C,H,H],
    scale/bias [C] float32, w [C,K].  The library yardstick is F.conv2d
    alone on the activation materialised beforehand; the composite is the
    probe's: the affine + relu materialised, then that conv."""
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc
    from paddle_tpu_torch.tools import conv1x1_fuse_probe as probe

    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    y = torch.randn((b, c, h, h), generator=g, device=device).to(dtype)
    scale = torch.rand(c, generator=g, device=device) + 0.5
    bias = torch.randn(c, generator=g, device=device) * 0.5
    w = (torch.randn((c, k), generator=g, device=device)
         * c ** -0.5).to(dtype)
    w1c = w.t().reshape(k, c, 1, 1).contiguous()
    act = torch.relu(y.float() * scale.reshape(1, c, 1, 1)
                     + bias.reshape(1, c, 1, 1)).to(dtype)

    def exact(fn):   # float32 convs in full float32, as the port runs them
        def run():
            with nn_ops.cudnn_fp32_exact():
                return fn()
        return run

    kernel = lambda: brc.bn_relu_conv1x1(y, scale, bias, w)  # noqa: E731
    plain = lambda: brc.bn_relu_conv1x1_reference(  # noqa: E731
        y, scale, bias, w)
    library = exact(lambda: torch.nn.functional.conv2d(act, w1c))
    composite = exact(lambda: probe.composite(y, scale, bias, w1c))
    item = y.element_size()
    return dict(kernel="bn_relu_conv1x1", case=name,
                fns=(kernel, plain, library), composite=composite,
                shape=f"y {b}x{c}x{h}x{h} w {c}x{k} "
                      f"{str(dtype).replace('torch.', '')}",
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                err=_conv1x1_err, zero_row=False,
                flop=2 * b * h * h * c * k,
                bytes=item * (b * c * h * h + c * k + b * k * h * h) + 8 * c)


def _conv1x1_err(out, ref, dtype, zero_row):
    """Max abs error of #8; in bfloat16 relative to the output's largest
    magnitude."""
    if not torch.isfinite(out).all():
        return float("inf")
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= max(ref.float().abs().max().item(), 1e-30)
    return err


def _bwd_err(out, ref, dtype, zero_row):
    """_max_err of a flash backward kernel's outputs; with zero_row, row
    0 of each must be exactly 0."""
    if zero_row and any(torch.count_nonzero(o[0]).item() for o in out):
        raise AssertionError("flash backward: the kv_len-0 row has "
                             "non-zero gradients")
    return _max_err(out, ref, dtype)


def _max_err(out, ref, dtype):
    """Max abs error over the outputs; for the backward in bfloat16,
    relative to each output's largest magnitude."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = []
    for o, r in zip(outs, refs, strict=True):
        if not torch.isfinite(o).all():
            return float("inf")
        e = (o.float() - r.float()).abs().max().item()
        if dtype == torch.bfloat16 and isinstance(out, tuple):
            e /= max(r.float().abs().max().item(), 1e-30)
        errs.append(e)
    return max(errs)


def check_kernels(device):
    """Phase 3: every kernel of the paths at the paths' shapes."""
    rng = np.random.RandomState(SEED)
    h, d = 8, 64
    train = (128, SEQ)
    cases = [
        mha_case("mha_decode 1x256", BATCH, 1, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
        mha_case("encoder 256x256", BATCH, SRC_LEN, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
        mha_case("causal prefix 1024x1024", BATCH, 1024, 1024, h, d, True,
                 None, device, rng),
        mha_case("cross 1024x256", BATCH, 1024, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
    ]
    for b, dtype in ((T1_BATCH, torch.float32), (T2_BATCH, torch.bfloat16)):
        tag = f"b{b} {str(dtype).replace('torch.', '')}"
        cases += [
            mha_case(f"train encoder {tag}", b, SEQ, SEQ, h, d, False, train,
                     device, rng, dtype),
            mha_case(f"train causal {tag}", b, SEQ, SEQ, h, d, True, None,
                     device, rng, dtype),
        ]
    for b, dtype in ((T2_BATCH, torch.bfloat16), (T2_BATCH, torch.float32),
                     (T1_BATCH, torch.float32), (T1_BATCH, torch.bfloat16)):
        tag = f"b{b} {str(dtype).replace('torch.', '')}"
        cases += [
            bwd_case(f"encoder {tag}", b, SEQ, SEQ, h, d, False, train,
                     device, rng, dtype),
            bwd_case(f"causal {tag}", b, SEQ, SEQ, h, d, True, None, device,
                     rng, dtype),
            bwd_case(f"cross {tag}", b, SEQ, SEQ, h, d, False, train, device,
                     rng, dtype),
        ]
    cases.append(decode_case("flash_decode 1x2048", BATCH, 2048, h, d,
                             (512, 1056), device, rng))
    pool = S_MAX_LEN // S_BLOCK * (S_SLOTS + 2)   # the Scheduler's default
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases.append(paged_case(f"paged decode {tag}", S_SLOTS, pool,
                                S_BLOCK, (1024, S_MAX_LEN), h, d, device,
                                rng, dtype))
    bert_h = 12                   # BERT-base: 12 heads of 64
    bert_lens = (L_SEQ // 2, L_SEQ)
    cases += [
        flash_case("bert L2 b16 masked bf16", L2_BATCH, L_SEQ, L_SEQ, bert_h,
                   d, False, bert_lens, device, rng, torch.bfloat16),
        flash_case("bert long_4096 b8 masked bf16", 8, 2 * L_SEQ, 2 * L_SEQ,
                   bert_h, d, False, (L_SEQ, 2 * L_SEQ), device, rng,
                   torch.bfloat16),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases.append(flash_case(f"prefill 2048 {tag}", S_SLOTS, S_WINDOW,
                                S_WINDOW, h, d, True, None, device, rng,
                                dtype))
    cases += [
        flash_case("off-grid 1000", BATCH, 1000, 1000, h, d, True,
                   (500, 1000), device, rng, torch.float32),
        flash_case("kv_len 0 row", BATCH, 1000, 1000, h, d, False,
                   (500, 1000), device, rng, torch.float32, zero_row=True),
    ]
    # kernels #4 and #5: L2's shape first (the main path's), then the
    # rest of the flash tier's training shapes
    for args in (
        ("bert L2 b16 masked bf16", L2_BATCH, L_SEQ, L_SEQ, bert_h, False,
         bert_lens, torch.bfloat16),
        ("bert b16 bf16", L2_BATCH, L_SEQ, L_SEQ, bert_h, False, None,
         torch.bfloat16),
        ("bert b16 masked f32", L2_BATCH, L_SEQ, L_SEQ, bert_h, False,
         bert_lens, torch.float32),
        ("bert long_4096 b8 masked bf16", 8, 2 * L_SEQ, 2 * L_SEQ, bert_h,
         False, (L_SEQ, 2 * L_SEQ), torch.bfloat16),
        ("causal 2048 b8 bf16", 8, S_WINDOW, S_WINDOW, h, True, None,
         torch.bfloat16),
        ("causal offset 1024x2048 f32", BATCH, 1024, S_WINDOW, h, True,
         None, torch.float32),
    ):
        name, b, sq, sk, heads, causal, lens, dtype = args
        cases += flash_bwd_cases(name, b, sq, sk, heads, d, causal, lens,
                                 device, rng, dtype)
    cases += flash_bwd_cases("off-grid 1000, kv_len 0 row", BATCH, 1000,
                             1000, h, d, False, (500, 1000), device, rng,
                             torch.float32, zero_row=True)
    # kernel #8 at ResNet-50's four conv3 sites (batch 256, bf16; the
    # 14x14 site first: R/probe launches it most), and one float32 case
    for name, (b, c, hh, k), dtype in (
            ("conv3 14x14 b256", (R2_BATCH, 256, 14, 1024), torch.bfloat16),
            ("conv3 56x56 b256", (R2_BATCH, 64, 56, 256), torch.bfloat16),
            ("conv3 28x28 b256", (R2_BATCH, 128, 28, 512), torch.bfloat16),
            ("conv3 7x7 b256", (R2_BATCH, 512, 7, 2048), torch.bfloat16),
            ("conv3 14x14 b64 f32", (64, 256, 14, 1024), torch.float32)):
        cases.append(conv1x1_case(name, b, c, hh, k, device, rng, dtype))
    # the bf16 tensor-core backward at D 128 (q and dO as register
    # fragments over 32-key tiles), beside D 64 above: 4 heads of 128 at
    # T2's shape, 6 heads of 128 at BERT-base L2's
    cases.append(bwd_case("encoder d128 b128 bf16", T2_BATCH, SEQ, SEQ, 4,
                          128, False, train, device, rng, torch.bfloat16))
    cases += flash_bwd_cases("bert L2 d128 b16 masked bf16", L2_BATCH, L_SEQ,
                             L_SEQ, 6, 128, False, bert_lens, device, rng,
                             torch.bfloat16)
    # added last, so that the cases above keep their inputs: #1 in bf16 at
    # Sq = 1, at T2's shape with 4 heads of 128, and a causal batch whose
    # image 0 has key_len 0 (the mean of V over every key); #8 at odd
    # batches, whose pixel tiles cross images at unaligned rows
    cases += [
        mha_case("mha_decode 1x256 bf16", BATCH, 1, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng, torch.bfloat16),
        mha_case("train encoder d128 b128 bf16", T2_BATCH, SEQ, SEQ, 4, 128,
                 False, train, device, rng, torch.bfloat16),
        mha_case("causal key_len 0 b128 bf16", T2_BATCH, SEQ, SEQ, h, d,
                 True, train, device, rng, torch.bfloat16, empty_first=True),
        conv1x1_case("conv3 14x14 b37", 37, 256, 14, 1024, device, rng,
                     torch.bfloat16),
        conv1x1_case("conv3 7x7 b37", 37, 512, 7, 2048, device, rng,
                     torch.bfloat16),
    ]
    # added last, so that the cases above keep their inputs: #7 at phase
    # S's real lengths (prompts of 1024-2048 plus up to 32 new tokens) in
    # both dtypes, and #6 in bf16
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cases.append(paged_case(
            f"paged decode S {tag}", S_SLOTS, pool, S_BLOCK,
            (S_PROMPTS[0], S_PROMPTS[1] + NEW_TOKENS), h, d, device, rng,
            dtype))
    cases.append(decode_case("flash_decode 1x2048 bf16", BATCH, 2048, h, d,
                             (512, 1056), device, rng, torch.bfloat16))
    timer = Timer(device)
    for c in cases:
        fns = c.pop("fns")
        kernel, plain, library = fns() if callable(fns) else fns
        reps = c.pop("reps", None)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if "err" in c:
            err = c.pop("err")(out, ref, c["dtype"], c.pop("zero_row"))
        else:
            err = _max_err(out, ref, c["dtype"])
        del out, ref
        if not err <= c["tol"]:
            raise AssertionError(f"{c['kernel']} {c['case']}: max error "
                                 f"{err} > {c['tol']}")
        c["max_abs_err"] = err
        if c["kernel"] in ("flash_decode", "flash_decode_paged"):
            ops = device_ops_of_one_call(kernel)
            names = KERNELS[c["kernel"]]["device_names"]
            if len(ops) != 1 or not any(n in ops[0] for n in names):
                raise AssertionError(f"{c['kernel']} {c['case']}: one call "
                                     f"ran {ops}, not one launch of {names}")
        c["ms"] = timer.ms(kernel, reps)
        c["device_ms"] = timer.device_ms(
            kernel, KERNELS[c["kernel"]]["device_names"], reps)
        c["plain_ms"] = timer.ms(plain, reps)
        c["library_ms"] = timer.ms(library, reps)
        composite = c.pop("composite", None)
        if composite is not None:
            c["composite_ms"] = timer.ms(composite, reps)
        del kernel, plain, library, composite
        dtype = c.pop("dtype")
        t_bytes = c["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = c["flop"] / PEAK_FLOP_PER_S[dtype] * 1e3
        c["bound_ms"] = max(t_bytes, t_ops)
        c["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        # bf16 rate on the device time: the function's FLOP, and (#2)
        # what its kernels compute
        on_card = c["device_ms"] or c["ms"]
        exec_flop = c.pop("exec_flop", c["flop"])
        c["tflops"] = (c["flop"] / on_card / 1e9
                       if dtype == torch.bfloat16 else None)
        rate = ("" if c["tflops"] is None else
                f"{c['tflops']:.1f} TFLOP/s"
                + (f" ({exec_flop / on_card / 1e9:.1f} computed)"
                   if exec_flop != c["flop"] else "") + "  ")
        log(f"  {c['kernel']:13s} {c['case']:24s} [{c['shape']}] "
            f"err {err:.2e}  kernel {c['ms'] * 1e3:9.1f} us (device "
            f"{_us(c['device_ms'])})  plain "
            f"{c['plain_ms'] * 1e3:9.1f} us  library "
            f"{c['library_ms'] * 1e3:9.1f} us  "
            + (f"composite {c['composite_ms'] * 1e3:9.1f} us  "
               if "composite_ms" in c else "")
            + rate + f"bound "
            f"{c['bound_ms'] * 1e3:7.1f} us ({c['bound_by']}: "
            f"{c['flop'] / 1e9:.3f} GFLOP, {c['bytes'] / 1e6:.1f} MB)")
        torch.cuda.empty_cache()
    del timer
    return cases


# ------------------------------------------------------------ main path


def make_feed(rng, prefix_len, prefix_range, vocab):
    src = rng.randint(2, vocab, size=(BATCH, SRC_LEN)).astype(np.int64)
    trg = rng.randint(2, vocab, size=(BATCH, prefix_len + TF_STEPS))
    feed = {
        "src_ids": src,
        "src_lens": rng.randint(128, SRC_LEN + 1, size=BATCH).astype(np.int64),
        "trg_ids": trg[:, :prefix_len].astype(np.int64),
        "prefix_lens": rng.randint(prefix_range[0], prefix_range[1] + 1,
                                   size=BATCH).astype(np.int64),
    }
    return feed, trg.astype(np.int64)


def teacher_forced(gen, feed, trg):
    """Prefill logits, then TF_STEPS steps each fed the target token at the
    row's cursor: [prefill, step 1, ...] as float32 tensors."""
    _, states, lengths, logits = gen._prefill(feed)
    out = [logits.float().clone()]
    for _ in range(TF_STEPS):
        tok = trg[np.arange(BATCH), lengths]
        logits, states = gen._step(tok, lengths, states, feed)
        lengths = lengths + 1
        out.append(logits.float().clone())
    return out


def profile_calls(fn, n, top=5, kernels=()):
    """n calls of fn under torch.profiler: host ms per call, the card's
    busy ms per call (union of its operations), the idle share, the
    kernels that take most of the card's time (ms per call) and, for each
    name of `kernels` (keys of KERNELS), its device ms per call and share
    of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    if not spans:
        return None   # the profiler saw no device activity
    per_kernel = {}
    for name, a, b in spans:
        per_kernel[name[:90]] = per_kernel.get(name[:90], 0.0) + (b - a)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_us(spans)
    mine = {}
    for name in kernels:
        us = sum(b - a for k, a, b in spans
                 if any(d in k for d in KERNELS[name]["device_names"]))
        mine[name] = {"ms_per_step": round(us / n / 1e3, 4),
                      "share": round(us / busy, 4)}
    return {"steps": n, "step_ms": wall_us / n / 1e3,
            "busy_ms_per_step": busy / n / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "top_kernels_ms_per_step": [[k, round(v / n / 1e3, 4)]
                                        for k, v in ranked],
            "kernels": mine}


def profile_decode_steps(gen, feed, tok, lengths, states, n_steps,
                         kernels=()):
    """Greedy Generator steps under the profiler (profile_calls)."""
    carry = {"tok": tok, "lengths": lengths, "states": states}

    def one():
        logits, carry["states"] = gen._step(carry["tok"], carry["lengths"],
                                            carry["states"], feed)
        carry["lengths"] = carry["lengths"] + 1
        carry["tok"] = torch.argmax(logits, -1).cpu().numpy()

    return profile_calls(one, n_steps, kernels=kernels)


def run_phase(name, spec, scope, card):
    from paddle_tpu_torch import CUDAPlace, decode, flags
    from paddle_tpu_torch.ops.cuda import flash_decode, mha_block

    prefix_len, prefix_range, max_len = PHASES[name]
    rng = np.random.RandomState(SEED + ord(name))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feed, trg = make_feed(rng, prefix_len, prefix_range, vocab)
    gen = decode.Generator(spec, scope=scope, place=CUDAPlace(0))
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    # uncounted warm-up: CUDA loads each kernel on its first launch, which
    # would otherwise land in the first phase's generate time
    gen.generate(feed, 2)

    # the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mha_block.launches = 0
    flash_decode.launches = 0
    g0 = graph_stats()
    t0 = time.perf_counter()
    tokens = gen.generate(feed, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = {"mha_block": mha_block.launches,
              "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    graphs = graph_stats(g0)

    if not (tokens.dtype == np.int64 and tokens.ndim == 2
            and tokens.shape[0] == BATCH and 1 <= tokens.shape[1] <= NEW_TOKENS
            and ((tokens >= 0) & (tokens < vocab)).all()):
        raise AssertionError(f"phase {name}: bad tokens {tokens.shape} "
                             f"{tokens.dtype}")
    steps = tokens.shape[1] - 1
    if name == "A":   # prefill: encoder + cross; step: self + cross (mha)
        expect = {"mha_block": 2 * n_layer + 2 * n_layer * steps,
                  "flash_decode": 0}
    else:             # prefill: encoder + causal prefix + cross
        expect = {"mha_block": 3 * n_layer + n_layer * steps,
                  "flash_decode": n_layer * steps}
    if counts != expect:
        raise AssertionError(f"phase {name}: launches {counts}, the gate "
                             f"predicts {expect} for {steps} steps")

    # timed breakdown (uncounted): prefill, then greedy steps from it
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, states, lengths, logits = gen._prefill(feed)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    tok = torch.argmax(logits, -1).cpu().numpy()
    n_steps = min(16, max_len - int(lengths.max()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        logits, states = gen._step(tok, lengths, states, feed)
        lengths = lengths + 1
        tok = torch.argmax(logits, -1).cpu().numpy()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    profile_steps = profile_decode_steps(
        gen, feed, tok, lengths, states, min(8, max_len - int(lengths.max())),
        kernels=("mha_block",) + (("flash_decode",) if name == "B" else ()))

    # kernel tiers vs the composite, same feeds
    kern = teacher_forced(gen, feed, trg)
    flags.set("flash_attention", "0")
    try:
        comp = teacher_forced(gen, feed, trg)
        comp_tokens = gen.generate(feed, NEW_TOKENS)
    finally:
        flags.reset("flash_attention")
    errs = [(a - b).abs().max().item() for a, b in zip(kern, comp)]
    width = min(tokens.shape[1], comp_tokens.shape[1])
    agree = float((tokens[:, :width] == comp_tokens[:, :width]).mean())
    if not max(errs) <= LOGITS_TOL:
        raise AssertionError(f"phase {name}: kernel tiers vs composite "
                             f"logits differ by {errs} > {LOGITS_TOL}")

    result = {
        "phase": name, "batch": BATCH, "src_len": SRC_LEN,
        "prefix_len": prefix_len, "prefix_lens": list(prefix_range),
        "max_len": max_len, "tokens": list(tokens.shape),
        "launches": counts, "generate_s": gen_s,
        "tokens_per_s": tokens.size / gen_s,
        "prefill_ms": statistics.median(prefill_ms), "step_ms": step_ms,
        "step_profile": profile_steps, "graphs": graphs,
        "peak_mem_mib": peak / 2 ** 20,
        "logits_max_abs_diff_vs_composite": errs,
        "greedy_agreement_vs_composite": agree, "card": card,
    }
    log(f"  phase {name}: {tokens.shape[0]}x{tokens.shape[1]} tokens in "
        f"{gen_s:.3f} s ({result['tokens_per_s']:.1f} tokens/s), prefill "
        f"{result['prefill_ms']:.2f} ms, {step_ms:.3f} ms/step, peak "
        f"{result['peak_mem_mib']:.0f} MiB  [{card}]")
    log(f"    launches {counts}; logits vs composite {errs}; greedy "
        f"agreement {agree:.3f}; CUDA graphs in generate {graphs}")
    log_profile(profile_steps)
    if name == "A":
        result["scheduler"], sched_counts = serve_dense(spec, scope, feed,
                                                        card)
        counts = {k: counts.get(k, 0) + n for k, n in sched_counts.items()}
    return result, counts


def log_profile(prof):
    if prof is not None:
        log(f"    profiled steps: {prof['step_ms']:.3f} ms/step, card busy "
            f"{prof['busy_ms_per_step']:.3f} ms/step, idle share "
            f"{prof['idle_share']:.3f}; top kernels "
            f"{prof['top_kernels_ms_per_step']}")
        if prof["kernels"]:
            log(f"    port kernels (ms/step, share of busy): "
                f"{prof['kernels']}")


def drive_main_path(card):
    """Phase 4: transformer-base served through decode.Generator, greedy
    (A, B) and beam search (Beam)."""
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.models import transformer

    cfg = transformer.base()
    scope = Scope()   # one model serves every phase, S included
    results, launches = [], {}
    for name, (prefix_len, _, max_len) in PHASES.items():
        spec = decode_spec(cfg, prefix_len, max_len)
        res, counts = run_phase(name, spec, scope, card)
        results.append(res)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    res, counts = phase_beam(card, scope)
    results.append(res)
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    return results, launches, scope


def phase_beam(card, scope):
    """Beam search through decode.Generator.generate(method="beam") on
    transformer.base() in float32, at phase A's feeds (batch 8, 256-token
    sources, prefixes of 1-8 in a 256-slot cache) with beam_size BEAM_K:
    the step program runs at 8 x BEAM_K rows, captured, with #1
    (mha_decode) for its self- and cross-attention.  Beam 1 must give
    greedy's tokens; beam BEAM_K's tokens and scores must equal the same
    search with mode="interpret" (every program replayed eagerly, on the
    card; scores within BEAM_TOL), best beam first.  Launches: 2 #1 a
    layer for the prefill and 2 a layer a step."""
    from paddle_tpu_torch import CUDAPlace, decode
    from paddle_tpu_torch.models import transformer

    prefix_len, prefix_range, max_len = PHASES["A"]
    spec = decode_spec(transformer.base(), prefix_len, max_len)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feed, _ = make_feed(np.random.RandomState(SEED + ord("A")), prefix_len,
                        prefix_range, vocab)
    place = CUDAPlace(0)
    gen = decode.Generator(spec, scope=scope, place=place)
    greedy = gen.generate(feed, NEW_TOKENS, eos_id=-1)
    one, _ = gen.generate(feed, NEW_TOKENS, method="beam", beam_size=1,
                          eos_id=-1)
    if not np.array_equal(one[:, 0], greedy):
        raise AssertionError("phase Beam: beam 1 differs from greedy")
    gen.generate(feed, 2, method="beam", beam_size=BEAM_K, eos_id=-1)

    # the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    tokens, scores = gen.generate(feed, NEW_TOKENS, method="beam",
                                  beam_size=BEAM_K, eos_id=-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    steps = tokens.shape[-1] - 1
    expect = dict.fromkeys(SERVING_KERNELS, 0)
    expect["mha_block"] = 2 * n_layer * (1 + steps)
    if counts != expect:
        raise AssertionError(f"phase Beam: launches {counts}, the gate "
                             f"predicts {expect} for {steps} steps")
    if tokens.shape != (BATCH, BEAM_K, NEW_TOKENS) \
            or not (np.diff(scores, axis=1) <= 0).all():
        raise AssertionError(f"phase Beam: tokens {tokens.shape}, scores "
                             f"{scores.tolist()}")
    eager = decode.Generator(spec, scope=scope, place=place,
                             mode="interpret")
    t0 = time.perf_counter()
    e_tokens, e_scores = eager.generate(feed, NEW_TOKENS, method="beam",
                                        beam_size=BEAM_K, eos_id=-1)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    err = float(np.abs(scores - e_scores).max())
    if not (np.array_equal(tokens, e_tokens) and err <= BEAM_TOL):
        raise AssertionError(f"phase Beam: captured vs interpret tokens "
                             f"equal {np.array_equal(tokens, e_tokens)}, "
                             f"scores {err}")
    res = {"phase": "Beam", "batch": BATCH, "beam_size": BEAM_K,
           "rows": BATCH * BEAM_K, "src_len": SRC_LEN, "max_len": max_len,
           "tokens": list(tokens.shape), "launches": counts,
           "generate_s": wall, "tokens_per_s": BATCH * NEW_TOKENS / wall,
           "beam_tokens_per_s": BATCH * BEAM_K * NEW_TOKENS / wall,
           "interpret_generate_s": eager_wall,
           "scores_max_abs_diff_vs_interpret": err, "graphs": graphs,
           "peak_mem_mib": peak / 2 ** 20, "beam1_equals_greedy": True,
           "card": card}
    log(f"  phase Beam: {BATCH}x{BEAM_K} beams x {NEW_TOKENS} tokens in "
        f"{wall:.3f} s ({res['tokens_per_s']:.1f} tokens/s of the best "
        f"beam, {res['beam_tokens_per_s']:.1f} over every beam; "
        f"mode=\"interpret\" {eager_wall:.3f} s), scores vs interpret "
        f"{err}, beam 1 = greedy, launches {counts}, CUDA graphs {graphs}, "
        f"peak {res['peak_mem_mib']:.0f} MiB  [{card}]")
    return res, counts


def decode_spec(cfg, prefix_len, max_len, **windows):
    """build_decode at SRC_LEN, every startup seeded; `windows` are
    verify_len / chunk_len."""
    from paddle_tpu_torch.models import transformer

    spec = transformer.build_decode(cfg, src_len=SRC_LEN,
                                    prefix_len=prefix_len, max_len=max_len,
                                    **windows)
    for startup in (spec.prefill_startup, spec.step_startup,
                    spec.verify_startup, spec.chunk_startup,
                    spec.encode_startup):
        if startup is not None:
            startup.random_seed = SEED
    return spec


# ------------------------------------------------- serving.Scheduler


SERVING_KERNELS = ("mha_block", "flash_decode", "flash_decode_paged",
                   "flash_attention_fwd")


def launch_counts():
    from paddle_tpu_torch.ops.cuda import (flash_attention, flash_decode,
                                           flash_decode_paged, mha_block)

    return {"mha_block": mha_block.launches,
            "flash_decode": flash_decode.launches,
            "flash_decode_paged": flash_decode_paged.launches,
            "flash_attention_fwd": flash_attention.launches}


def graph_stats(since=None):
    """The CUDA graphs captured (and the seconds spent capturing them),
    replayed and warmed up eagerly since `since` (a graph_stats() dict) or
    since the last reset."""
    from paddle_tpu_torch.framework import cuda_graph

    now = dict(cuda_graph.STATS)
    if since is not None:
        now = {k: v - since[k] for k, v in now.items()}
    now["capture_s"] = round(now["capture_s"], 4)
    return now


def _top2_gap(gen, feed, tokens, t):
    """The sequential Generator's top-2 logit gap where it emits tokens[t],
    teacher-forced on tokens[:t]."""
    _, states, lengths, logits = gen._prefill(feed)
    for tok in tokens[:t]:
        logits, states = gen._step(np.asarray([tok]), lengths, states, feed)
        lengths = lengths + 1
    top = torch.topk(logits.float().reshape(-1), 2).values
    return (top[0] - top[1]).item()


def check_served(phase, reqs, feeds, gen, new_tokens):
    """Every request done, with the sequential batch-1 Generator's tokens
    for its feed.  A divergence is recorded in DIVERGED with its first
    step and the top-2 logit gap there (ROADMAP.md C4)."""
    refs = {}
    for i, (req, feed) in enumerate(zip(reqs, feeds, strict=True)):
        if req.status != "done" or len(req.tokens) != new_tokens:
            raise AssertionError(f"phase {phase}: request {i} {req.status} "
                                 f"with {len(req.tokens)} tokens: "
                                 f"{req.error}")
        key = id(feed)
        if key not in refs:
            refs[key] = gen.generate(feed, new_tokens, eos_id=-1)[0].tolist()
        want = refs[key]
        if req.tokens != want:
            t = next(j for j, (a, b) in enumerate(zip(req.tokens, want))
                     if a != b)
            DIVERGED.append({"phase": phase, "request": i, "step": t,
                             "got": req.tokens[t], "want": want[t],
                             "top2_gap": _top2_gap(gen, feed, want, t)})
            log(f"    DIVERGED {DIVERGED[-1]}")
    return sum(r.tokens == refs[id(f)] for r, f in zip(reqs, feeds))


def serve_dense(spec, scope, feed, card):
    """Phase A's feeds through serving.Scheduler at its default
    paged_kv=False: the host BlockPool, a dense gather of every table a
    step.  Launches: 2 per layer per prefill batch (encoder, cross) and 2
    per layer per step (mha_decode over the 256-slot cache and the
    source)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving

    place = CUDAPlace(0)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    feeds = [{k: v[i:i + 1] for k, v in feed.items()} for i in range(BATCH)]
    sched = serving.Scheduler(spec, scope=scope, place=place,
                              max_batch=BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    reqs = [sched.submit(f, NEW_TOKENS, eos_id=-1) for f in feeds]
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    c = sched.counters
    expect = dict.fromkeys(SERVING_KERNELS, 0)
    expect["mha_block"] = 2 * n_layer * (c["prefill_batches"] + c["steps"])
    if counts != expect:
        raise AssertionError(f"phase A/scheduler: launches {counts}, the "
                             f"gate predicts {expect} for {c['steps']} "
                             f"steps and {c['prefill_batches']} prefills")
    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served("A/scheduler", reqs, feeds, gen, NEW_TOKENS)
    sched.pool.assert_quiesced()
    res = {"paged_kv": False, "requests": len(reqs), "launches": counts,
           "steps": c["steps"], "prefill_batches": c["prefill_batches"],
           "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
           "graphs": graphs, "peak_mem_mib": peak / 2 ** 20,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"    scheduler (paged_kv=False): {len(reqs)}x{NEW_TOKENS} tokens, "
        f"{res['tokens_per_s']:.1f} tokens/s, {c['steps']} steps, launches "
        f"{counts}; CUDA graphs {graphs}, peak "
        f"{res['peak_mem_mib']:.0f} MiB; {equal}/{len(reqs)} requests equal "
        f"the sequential Generator  [{card}]")
    return res, counts


class Recorder:
    """Drives sched.step() and keeps, for every iteration, its host ms,
    its end on the host clock, the deltas of the scheduler's counters, the
    tokens each of `reqs` emitted in it (step() ends on the argmax's copy
    to the host, so the time is the iteration's) and how many programs it
    ran at a signature seen for the first or second time (an eager
    warm-up or a CUDA graph capture)."""

    KEYS = ("steps", "spec_rounds", "draft_steps", "prefill_batches",
            "chunk_passes", "replays", "adopted")

    def __init__(self, sched, reqs=()):
        self.sched, self.reqs, self.log = sched, reqs, []

    def __call__(self):
        c = self.sched.counters
        before = {k: c[k] for k in self.KEYS}
        toks = [len(r.tokens) for r in self.reqs]
        g0 = graph_stats()
        t0 = time.perf_counter()
        did = self.sched.step()
        t1 = time.perf_counter()
        g = graph_stats(g0)
        rec = {k: c[k] - before[k] for k in self.KEYS}
        rec.update(ms=(t1 - t0) * 1e3, end=t1, emitted=[
            len(r.tokens) - n for r, n in zip(self.reqs, toks)],
            first_time=g["captures"] + g["warmups"])
        self.log.append(rec)
        return did

    def until(self, key, n):
        """Step until `key` has grown by n in total."""
        while sum(r[key] for r in self.log) < n:
            self()

    def pure(self, key):
        """Iterations that did one `key` and no prefill, chunk pass or
        replay."""
        others = {"prefill_batches", "chunk_passes", "replays",
                  "adopted"} - {key}
        return [r for r in self.log
                if r[key] == 1 and not any(r[k] for k in others)]


def _request_feeds(rng, n, vocab):
    """n single-request feeds: 256-token sources (ragged 128-256) and
    2048-token prompt windows with ragged prompts of 1024-2048 tokens."""
    return [{
        "src_ids": rng.randint(2, vocab, size=(1, SRC_LEN)).astype(np.int64),
        "src_lens": np.asarray([rng.randint(128, SRC_LEN + 1)], np.int64),
        "trg_ids": rng.randint(2, vocab, size=(1, S_WINDOW)).astype(np.int64),
        "prefix_lens": np.asarray(
            [rng.randint(S_PROMPTS[0], S_PROMPTS[1] + 1)], np.int64),
    } for _ in range(n)]


def warm_up(sched, groups, new_tokens=3):
    """Uncounted traffic of the counted run's shapes, on other prompts:
    each group of feeds is submitted at once and served to the end, so
    that every program signature it reaches runs once eagerly and, seen
    again, is captured.  Then the prefix registry is evicted, the pool
    must be empty, and the scheduler's counters and samples start from 0.
    Returns the graphs captured and warmed up, and their seconds."""
    g0 = graph_stats()
    t0 = time.perf_counter()
    for group in groups:
        for f in group:
            sched.submit(f, new_tokens, eos_id=-1)
        sched.run_until_idle()
    torch.cuda.synchronize()
    sched.pool.assert_quiesced()
    for k in sched.counters:
        sched.counters[k] = 0
    sched.counters["peak_occupancy"] = 0.0
    sched._ttft_samples.clear()
    sched._chunk_samples.clear()
    sched.pool.hits = sched.pool.misses = sched.pool.evictions = 0
    out = graph_stats(g0)
    out["wall_s"] = round(time.perf_counter() - t0, 3)
    return out


def phase_s(card, scope):
    """The Scheduler with paged_kv=True on transformer.base().

    Traffic (16 requests of 32 tokens, 15 distinct prompts): wave 1 is
    prompts 0-6; prompt 0 again after wave 1's 2nd decode step (a prefix
    hit, two tokens behind the rest); wave 2, prompts 7-14, after the 4th
    (admitted when wave 1 finishes, while the repeat still decodes); after
    the 6th, request 3 is evicted and replays (prefill, then its own
    tokens teacher-forced).

    Launches, from the scheduler's own counts: per decode step (replay
    steps included) 6 flash_decode_paged (self-attention through the
    block tables) and 6 mha_block (mha_decode over the 256-token source);
    per prefill batch 6 flash_attention_fwd (causal 2048x2048 decoder
    self-attention: its score tile is over mha_block's budget) and 12
    mha_block (encoder 256x256, cross 2048x256)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving
    from paddle_tpu_torch.models import transformer

    spec = decode_spec(transformer.base(), S_WINDOW, S_MAX_LEN)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feeds = _request_feeds(np.random.RandomState(SEED + ord("S")), 15, vocab)
    place = CUDAPlace(0)
    sched = serving.Scheduler(spec, scope=scope, place=place,
                              max_batch=S_SLOTS, block_size=S_BLOCK,
                              paged_kv=True)
    tick = Recorder(sched)
    order = []

    def submit(i):
        order.append(feeds[i])
        return sched.submit(feeds[i], NEW_TOKENS, eos_id=-1)

    warm = _request_feeds(np.random.RandomState(_phase_seed("S/warm")), 18,
                          vocab)
    warmed = warm_up(sched, [warm[:8], warm[8:16], warm[16:17],
                             warm[17:]])

    # the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    reqs = [submit(i) for i in range(7)]
    tick.until("steps", 2)
    reqs.append(submit(0))
    tick.until("steps", 4)
    reqs += [submit(i) for i in range(7, 15)]
    tick.until("steps", 6)
    if reqs[3].status != "running":
        raise AssertionError(f"phase S: request 3 is {reqs[3].status}")
    sched.preempt(reqs[3], evict=True)
    while tick():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats()

    steps, batches = st["steps"], st["prefill_batches"]
    expect = {"mha_block": n_layer * (steps + 2 * batches),
              "flash_decode": 0,
              "flash_decode_paged": n_layer * steps,
              "flash_attention_fwd": n_layer * batches}
    if counts != expect:
        raise AssertionError(f"phase S: launches {counts}, the gate "
                             f"predicts {expect} for {steps} steps and "
                             f"{batches} prefill batches")
    if st["pool"]["prefix_hits"] < 1 or st["replays"] < 1:
        raise AssertionError(f"phase S: prefix hits "
                             f"{st['pool']['prefix_hits']}, replays "
                             f"{st['replays']}")
    mid_flight = (min(r.first_token_t for r in reqs[8:])
                  < max(r.finish_t for r in reqs[:8]))
    if not mid_flight:
        raise AssertionError("phase S: wave 2 was not admitted while wave "
                             "1 decoded")

    # a few decode steps of 8 prefix hits under the profiler (uncounted)
    for i in range(7, 15):
        sched.submit(feeds[i], S_PROFILED + 2, eos_id=-1)
    tick()
    prof = profile_calls(tick, S_PROFILED,
                         kernels=("flash_decode_paged", "mha_block"))
    sched.run_until_idle()
    parity = capture_parity(sched, feeds[7:15])
    sched.run_until_idle()
    pool_end = sched.pool.assert_quiesced()

    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served("S", reqs, order, gen, NEW_TOKENS)
    decode_ms = [r["ms"] for r in tick.pure("steps")]
    prefill_ms = [r["ms"] for r in tick.pure("prefill_batches")]
    res = {"phase": "S", "paged_kv": True, "requests": len(reqs),
           "new_tokens": NEW_TOKENS, "src_len": SRC_LEN, "window": S_WINDOW,
           "prompt_lens": list(S_PROMPTS), "max_len": S_MAX_LEN,
           "block_size": S_BLOCK, "max_batch": S_SLOTS,
           "num_blocks": sched.pool.num_blocks, "launches": counts,
           "steps": steps, "prefill_batches": batches,
           "prefix_hits": st["pool"]["prefix_hits"],
           "replays": st["replays"], "preemptions": st["preemptions"],
           "wall_s": wall, "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
           "ttft_ms": st["ttft_ms"],
           "decode_step_ms": statistics.median(decode_ms),
           "decode_steps_timed": len(decode_ms),
           "prefill_iteration_ms": prefill_ms,
           "step_profile": prof, "peak_mem_mib": peak / 2 ** 20,
           "graphs": graphs, "warm_up": warmed, "capture_parity": parity,
           "peak_occupancy": st["peak_occupancy"], "pool_end": pool_end,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase S: {len(reqs)}x{NEW_TOKENS} tokens in {wall:.3f} s "
        f"({res['tokens_per_s']:.1f} tokens/s), TTFT {st['ttft_ms']}, "
        f"{res['decode_step_ms']:.3f} ms per decode step (median of "
        f"{len(decode_ms)}), prefill iterations "
        f"{[round(ms, 2) for ms in prefill_ms]} ms, peak "
        f"{res['peak_mem_mib']:.0f} MiB, pool "
        f"occupancy peak {st['peak_occupancy']:.3f} of "
        f"{sched.pool.num_blocks} blocks  [{card}]")
    log(f"    {steps} steps, {batches} prefill batches, prefix hits "
        f"{st['pool']['prefix_hits']}, replays {st['replays']}; launches "
        f"{counts}; CUDA graphs {graphs} (warm-up traffic before: "
        f"{warmed}); {equal}/{len(reqs)} requests equal the sequential "
        f"Generator")
    log_profile(prof)
    log(f"    capture parity at one step signature (8 rows): {parity}")
    return res, counts


def capture_parity(sched, feeds):
    """S's paged step at one signature (8 prefix hits decoding), run as
    the Scheduler runs it (a replay of its captured graph) and as an eager
    replay of the same program's ops on the same feed: the logits' max abs
    difference (expected 0; fails above PARITY_TOL) and each run's launch
    counts (must be equal).  Both runs append the same rows at the same
    cursors, so the pool is left as one run leaves it."""
    from paddle_tpu_torch.framework.executor import program_as_function

    for f in feeds:
        sched.submit(f, 6, eos_id=-1)
    for _ in range(4):
        sched.step()
    batch = list(sched._active)
    if len(batch) != len(feeds):
        raise AssertionError(f"phase S: {len(batch)} of {len(feeds)} "
                             "requests decoding for the parity check")
    spec = sched.spec
    fetch = spec.step_fetches()
    feed = sched._window_feed(
        spec, batch, np.asarray([r._last_tok for r in batch]),
        [r._cursor for r in batch], sched._carried + sched._const,
        "_states", sched._paged, tag="step")
    eager = program_as_function(sched._paged_step_program(),
                                sched._gen.scope, fetch, sched.device,
                                mode="interpret")

    def counted(run):
        before = launch_counts()
        with torch.inference_mode():
            outs = run()
        torch.cuda.synchronize()
        after = launch_counts()
        return outs, {k: after[k] - before[k] for k in after}

    with torch.inference_mode():
        for _ in range(3):   # at this signature: warm-up, capture, replay
            sched._run_paged_exec(feed, fetch)
    g0 = graph_stats()
    cap, cap_counts = counted(lambda: sched._run_paged_exec(feed, fetch))
    replayed = graph_stats(g0)
    ref, ref_counts = counted(lambda: dict(zip(fetch, eager(feed))))
    err = (cap[spec.step_logits].float()
           - ref[spec.step_logits].float()).abs().max().item()
    res = {"rows": len(batch), "max_abs_diff": err,
           "captured_launches": cap_counts, "eager_launches": ref_counts,
           "replayed": replayed["replays"] == 1
           and replayed["captures"] == 0}
    if not (err <= PARITY_TOL and cap_counts == ref_counts
            and res["replayed"]):
        raise AssertionError(f"phase S: capture parity {res}")
    return res


# ------------------------------- the Scheduler's spec, chunk, handoff paths

SPEC_K = 4                    # phase V's verify window
C_CHUNK = 512                 # phases C and H: chunk window rows
C_SHORT = (256, 512)          # phase C's monolithic prompts
H_BLOCK = 32                  # phase H's decode tier: another block size
V_PROFILED = 4                # rounds (V) or iterations (C) profiled


def _phase_seed(name):
    return SEED + sum(map(ord, name))


def _labelled(label, fn):
    """fn inside a profiler range, the card synchronised on both sides, so
    that the kernels it launched run inside the range."""
    from torch.profiler import record_function

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        with record_function(label):
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
        return out

    return run


def profile_labelled(drive, n, patches):
    """n calls of drive() under torch.profiler with `patches` (a list of
    (object, attribute, label)) wrapped by _labelled: host ms and card
    busy ms per call, the idle share, and for each label the card busy
    ms per call of the kernels that started inside its ranges.  The
    wrappers' synchronisations lengthen the host time, so host numbers
    come from unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for (obj, attr, label), (_, _, fn) in zip(patches, saved):
        setattr(obj, attr, _labelled(label, fn))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                drive()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    labels = {label for _, _, label in patches}
    # the ranges themselves appear on the device timeline too (the
    # profiler's annotation spans): count the operations only
    spans = [sp for sp in device_spans(prof) if sp[0] not in labels]
    if not spans:
        return None   # the profiler saw no device activity
    out = {"calls": n, "busy_ms_per_call": busy_us(spans) / n / 1e3,
           "idle_share": 1.0 - busy_us(spans) / wall_us, "labels": {}}
    for _, _, label in patches:
        ranges = [(e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == label]
        mine = [sp for sp in spans if any(a <= sp[1] < b for a, b in ranges)]
        per_kernel = {}
        for name, a, b in mine:
            per_kernel[name[:80]] = per_kernel.get(name[:80], 0.0) + (b - a)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
        out["labels"][label] = {
            "ranges": len(ranges), "device_ops": len(mine),
            "busy_ms_per_call": busy_us(mine) / n / 1e3,
            "top_ms_per_call": [[k, round(v / n / 1e3, 4)] for k, v in top]}
    return out


def _label_ms(prof):
    return {k: round(v["busy_ms_per_call"], 4)
            for k, v in prof["labels"].items()}


def _v_expect(c, n_layer, d_layer):
    """Phase V's launches from the scheduler's counters: a plain step
    (replays included) runs #7 and #1 (mha_decode over the source) in
    every target layer, a draft step in every draft layer; the verify
    window runs none (its self-attention is the paged composite, its
    Sq = 4 cross-attention is off #1's grid and under the flash tier's
    floor); a prefill batch runs #3 (causal 2048) and two #1 (encoder,
    cross) per layer of the target and of the draft."""
    plain = c["steps"] - c["spec_rounds"]
    step = n_layer * plain + d_layer * c["draft_steps"]
    return {"mha_block": step + 2 * (n_layer + d_layer)
            * c["prefill_batches"],
            "flash_decode": 0, "flash_decode_paged": step,
            "flash_attention_fwd": (n_layer + d_layer)
            * c["prefill_batches"]}


def phase_v(card, scope, leg):
    """Speculative decoding through serving.Scheduler(spec_decode=True)
    on transformer.base() over the device pool: build_decode(verify_len=
    4), spec_k 4, 8 requests of 32 tokens with prompts of 1024-2048.
    leg "trunc": build_draft(tier="trunc"), 3 decoder layers on the
    target's scope; leg "self": the draft is a second build_decode of the
    target's configuration, so every proposal is accepted.

    Traffic: prompts 0-6; prompt 0 again after the 1st round (a prefix
    hit); after the 2nd round request 3 is evicted and replays (target and
    draft teacher-forced in lockstep)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving
    from paddle_tpu_torch.models import transformer

    name = f"V/{leg}"
    cfg = transformer.base()
    spec = decode_spec(cfg, S_WINDOW, S_MAX_LEN, verify_len=SPEC_K)
    if leg == "trunc":
        draft, _ = transformer.build_draft(cfg, src_len=SRC_LEN,
                                           prefix_len=S_WINDOW,
                                           max_len=S_MAX_LEN, tier="trunc",
                                           scope=scope)
    else:
        draft = decode_spec(cfg, S_WINDOW, S_MAX_LEN)
    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    d_layer = sum(1 for s in draft.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feeds = _request_feeds(np.random.RandomState(_phase_seed(name)), 7,
                           vocab)
    place = CUDAPlace(0)
    sched = serving.Scheduler(spec, scope=scope, place=place,
                              max_batch=S_SLOTS, block_size=S_BLOCK,
                              paged_kv=True, spec_decode=True, spec_k=SPEC_K,
                              draft_spec=draft)
    reqs, order = [], []
    tick = Recorder(sched, reqs)

    def submit(i):
        order.append(feeds[i])
        reqs.append(sched.submit(feeds[i], NEW_TOKENS, eos_id=-1))

    # the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    for i in range(7):
        submit(i)
    tick.until("spec_rounds", 1)
    submit(0)
    tick.until("spec_rounds", 2)
    if reqs[3].status != "running":
        raise AssertionError(f"phase {name}: request 3 is {reqs[3].status}")
    sched.preempt(reqs[3], evict=True)
    while tick():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats()
    expect = _v_expect(st, n_layer, d_layer)
    if counts != expect:
        raise AssertionError(f"phase {name}: launches {counts}, the gate "
                             f"predicts {expect} for {st['steps']} steps, "
                             f"{st['spec_rounds']} rounds, "
                             f"{st['draft_steps']} draft steps and "
                             f"{st['prefill_batches']} prefill batches")
    if st["pool"]["prefix_hits"] < 1 or st["replays"] < 1:
        raise AssertionError(f"phase {name}: prefix hits "
                             f"{st['pool']['prefix_hits']}, replays "
                             f"{st['replays']}")
    rounds = tick.pure("spec_rounds")
    per_row = [n for r in rounds for n in r["emitted"] if n]
    if leg == "self":
        # every proposal accepted: a request's first round emits spec_k
        # tokens; a full acceptance leaves the draft one row behind, so
        # each later round spends a draft step on that row and emits
        # spec_k - 1 (until the budget's last round)
        if st["spec_accepted"] != st["spec_proposed"]:
            DIVERGED.append({"phase": name, "accepted": st["spec_accepted"],
                             "proposed": st["spec_proposed"]})
            log(f"    DIVERGED {DIVERGED[-1]}")

    # a few rounds of 8 prefix hits under the profiler (uncounted): card
    # busy split into the draft steps and the verify window
    for i in range(7):
        sched.submit(feeds[i], 2 * V_PROFILED * SPEC_K + 2, eos_id=-1)
    sched.submit(feeds[0], 2 * V_PROFILED * SPEC_K + 2, eos_id=-1)
    sched.step()
    prof = profile_labelled(sched.step, V_PROFILED, [
        (sched, "_run_draft_step", "draft"),
        (sched, "_run_verify", "verify")])
    # and unlabelled (no synchronising wrapper): the idle share
    plain = profile_calls(sched.step, V_PROFILED // 2)
    sched.run_until_idle()
    pool_end = sched.pool.assert_quiesced()

    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served(name, reqs, order, gen, NEW_TOKENS)
    round_ms = [r["ms"] for r in rounds]
    res = {"phase": name, "paged_kv": True, "spec_k": SPEC_K,
           "draft_layers": d_layer, "requests": len(reqs),
           "new_tokens": NEW_TOKENS, "window": S_WINDOW,
           "prompt_lens": list(S_PROMPTS), "max_len": S_MAX_LEN,
           "block_size": S_BLOCK, "max_batch": S_SLOTS, "launches": counts,
           "steps": st["steps"], "spec_rounds": st["spec_rounds"],
           "draft_steps": st["draft_steps"],
           "prefill_batches": st["prefill_batches"],
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           "acceptance": st["spec_accepted"] / max(1, st["spec_proposed"]),
           "spec_tokens": st["spec_tokens"],
           "tokens_per_row_round": sum(per_row) / max(1, len(per_row)),
           "tokens_per_row_round_hist": {
               str(k): per_row.count(k) for k in sorted(set(per_row))},
           "first_round_tokens": rounds[0]["emitted"] if rounds else None,
           "prefix_hits": st["pool"]["prefix_hits"],
           "replays": st["replays"], "wall_s": wall,
           "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
           "ttft_ms": st["ttft_ms"],
           "round_ms": statistics.median(round_ms) if round_ms else None,
           "rounds_timed": len(round_ms), "round_profile": prof,
           "round_profile_unlabelled": plain, "graphs": graphs,
           "peak_mem_mib": peak / 2 ** 20, "pool_end": pool_end,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase {name}: {len(reqs)}x{NEW_TOKENS} tokens in {wall:.3f} s "
        f"({res['tokens_per_s']:.1f} tokens/s), {st['spec_rounds']} rounds, "
        f"accepted {st['spec_accepted']}/{st['spec_proposed']} "
        f"({res['acceptance']:.3f}), {res['tokens_per_row_round']:.3f} "
        f"tokens per row and round {res['tokens_per_row_round_hist']}, "
        f"{res['round_ms']} ms per round (median of {len(round_ms)}), TTFT "
        f"{st['ttft_ms']}, peak {res['peak_mem_mib']:.0f} MiB  [{card}]")
    log(f"    {st['steps']} target launches, {st['draft_steps']} draft steps, "
        f"{st['prefill_batches']} prefill batches, prefix hits "
        f"{st['pool']['prefix_hits']}, replays {st['replays']}; launches "
        f"{counts}; CUDA graphs {graphs}; {equal}/{len(reqs)} requests "
        f"equal the sequential Generator")
    log_profile(plain)
    if prof is not None:
        log(f"    profiled rounds (8 rows): card busy "
            f"{prof['busy_ms_per_call']:.3f} ms per round, idle share "
            f"{prof['idle_share']:.3f} (synchronised wrappers); of it "
            f"{_label_ms(prof)} ms per round; {prof['labels']}")
    return res, counts


def _c_expect(c, n_layer):
    """Phases C and H: a prefill batch runs #3 (causal 2048) and two #1 per
    layer; a chunked request one encode pass (#1 over the source in every
    layer); a chunk window #1 (its 512x256 cross-attention) in every layer
    and no other kernel (its ramp self-attention is the paged composite);
    a decode step #7 and #1 (mha_decode) in every layer."""
    return {"mha_block": n_layer * (2 * c["prefill_batches"] + c["chunked"]
                                    + c["chunk_passes"] + c["steps"]),
            "flash_decode": 0, "flash_decode_paged": n_layer * c["steps"],
            "flash_attention_fwd": n_layer * c["prefill_batches"]}


def _add(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def phase_c(card, scope, spec):
    """Chunked prefill through serving.Scheduler(prefill_chunk=512) on
    transformer.base() over the device pool.  Four requests with prompts
    of 256-512 tokens take the monolithic prefill (#3) and decode; after
    their 2nd decode step four with prompts of 1024-2048 arrive and run
    2-4 chunk windows each, one per loop iteration after the decode step.
    The second long request is exported after its first window and
    imported into a second Scheduler, where it re-chunks from 0."""
    from paddle_tpu_torch import CUDAPlace, decode, serving

    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    rng = np.random.RandomState(_phase_seed("C"))
    short = _request_feeds(rng, 4, vocab)
    for f in short:
        f["prefix_lens"] = np.asarray([rng.randint(C_SHORT[0],
                                                   C_SHORT[1] + 1)], np.int64)
    long = _request_feeds(rng, 4, vocab)
    place = CUDAPlace(0)

    def scheduler():
        return serving.Scheduler(spec, scope=scope, place=place,
                                 max_batch=S_SLOTS, block_size=S_BLOCK,
                                 paged_kv=True, prefill_chunk=C_CHUNK)

    a = scheduler()
    # the paged rewrite of the chunk window is built on its first use, and
    # each program is run eagerly, then captured, at its first two calls
    # of a signature: warm these one-time host costs up on other prompts,
    # so that they stay out of the gaps
    a._chunk_step_program()
    warm = _request_feeds(np.random.RandomState(_phase_seed("C/warm")), 12,
                          vocab)
    for f in warm[:4] + warm[6:10]:
        f["prefix_lens"] = np.asarray([rng.randint(C_SHORT[0],
                                                   C_SHORT[1] + 1)], np.int64)
    # (16 tokens: the short prompts still decode when the long ones
    # graduate, so that the steps reach the 8-row bucket)
    warmed = warm_up(a, [warm[:6], warm[6:]], new_tokens=16)
    reqs = []
    tick = Recorder(a, reqs)

    # the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    reqs += [a.submit(f, NEW_TOKENS, eos_id=-1) for f in short]
    tick.until("steps", 2)
    arrive = len(tick.log)
    reqs += [a.submit(f, NEW_TOKENS, eos_id=-1, request_id=f"long{i}")
             for i, f in enumerate(long)]
    tick.until("chunk_passes", 2)
    moving = reqs[5]
    if moving not in a._prefilling or moving._chunk_pos <= 0:
        raise AssertionError("phase C: request long1 is not mid-prefill")
    record = next(r for r in a.export_requests()
                  if r["request_id"] == "long1")
    moving.cancel()
    while tick():
        pass
    b = scheduler()
    (moved,) = b.import_requests([record])
    b.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st, st_b = a.stats(), b.stats()
    expect = _add(_c_expect(st, n_layer), _c_expect(st_b, n_layer))
    if counts != expect:
        raise AssertionError(f"phase C: launches {counts}, the gate "
                             f"predicts {expect} for {st}, {st_b}")
    if moving.status != "cancelled" or st["chunked"] != 4 \
            or st_b["chunked"] != 1:
        raise AssertionError(f"phase C: long1 {moving.status}, chunked "
                             f"{st['chunked']} + {st_b['chunked']}")
    # decode gaps: host time between the ends of consecutive iterations
    # that ran a decode step, from the long arrivals until the last
    # chunked prompt graduated
    last_pass = max(i for i, r in enumerate(tick.log) if r["chunk_passes"])
    stepped = [r for r in tick.log[arrive:last_pass + 2] if r["steps"]]
    gaps = [(b_["end"] - a_["end"]) * 1e3
            for a_, b_ in zip(stepped, stepped[1:])]
    # a gap whose iteration ran a program at a new signature (eagerly, or
    # capturing it)
    first_time = [bool(r["first_time"]) for r in stepped[1:]]
    pass_ms = a.stats()["prefill_chunk_ms"]

    # chunk passes of two fresh long prompts under the profiler
    # (uncounted): card busy per pass
    fresh = _request_feeds(rng, 2, vocab)
    for f in fresh:
        a.submit(f, 2, eos_id=-1)
    a.step()
    prof = profile_labelled(a.step, V_PROFILED, [(a, "_run_chunk", "chunk")])
    # and unlabelled (no synchronising wrapper): the idle share
    for f in _request_feeds(rng, 2, vocab):
        a.submit(f, 2, eos_id=-1)
    a.step()
    plain = profile_calls(a.step, 2)
    a.run_until_idle()
    pool_end = a.pool.assert_quiesced()
    b.pool.assert_quiesced()

    gen = decode.Generator(spec, scope=scope, place=place)
    served = [r for r in reqs if r is not moving] + [moved]
    fed = [f for r, f in zip(reqs, short + long) if r is not moving] \
        + [long[1]]
    equal = check_served("C", served, fed, gen, NEW_TOKENS)
    ttft_long = sorted((r.first_token_t - r.submit_t) * 1e3
                       for r in reqs[4:] if r is not moving)
    res = {"phase": "C", "paged_kv": True, "chunk": C_CHUNK,
           "requests": len(served), "new_tokens": NEW_TOKENS,
           "short_prompts": list(C_SHORT), "long_prompts": list(S_PROMPTS),
           "launches": counts, "steps": st["steps"] + st_b["steps"],
           "prefill_batches": st["prefill_batches"],
           "chunked": st["chunked"] + st_b["chunked"],
           "chunk_passes": st["chunk_passes"] + st_b["chunk_passes"],
           "chunk_pass_ms": pass_ms,
           "decode_gap_ms_max": max(gaps), "decode_gap_ms": gaps,
           "decode_gap_first_time": first_time,
           "decode_gap_ms_max_steady": max(
               [g for g, f in zip(gaps, first_time) if not f], default=None),
           "decode_step_ms": statistics.median(
               r["ms"] for r in tick.pure("steps")),
           "ttft_ms": st["ttft_ms"], "ttft_long_ms": ttft_long,
           "wall_s": wall, "peak_mem_mib": peak / 2 ** 20,
           "pass_profile": prof, "pass_profile_unlabelled": plain,
           "graphs": graphs, "warm_up": warmed, "pool_end": pool_end,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase C: {len(served)}x{NEW_TOKENS} tokens in {wall:.3f} s, "
        f"{res['chunk_passes']} chunk passes of {C_CHUNK} rows "
        f"({pass_ms} ms), longest decode gap "
        f"{res['decode_gap_ms_max']:.2f} ms (gaps "
        f"{[round(g, 2) for g in gaps]}), decode step "
        f"{res['decode_step_ms']:.3f} ms, TTFT {st['ttft_ms']}, long "
        f"prompts' TTFT {[round(t, 1) for t in ttft_long]} ms, peak "
        f"{res['peak_mem_mib']:.0f} MiB  [{card}]")
    log(f"    launches {counts}; CUDA graphs {graphs} (warm-up traffic "
        f"before: {warmed}); gaps whose iteration ran a program at a new "
        f"signature: {first_time}; {equal}/{len(served)} requests equal the "
        f"sequential Generator (one exported mid-prefill)")
    log_profile(plain)
    if prof is not None:
        log(f"    profiled chunk passes: card busy "
            f"{prof['busy_ms_per_call']:.3f} ms each, idle share "
            f"{prof['idle_share']:.3f} (synchronised wrappers); of it "
            f"{_label_ms(prof)} ms; {prof['labels']}")
    return res, counts


def phase_h(card, scope, spec):
    """The two-tier handoff: a prefill-tier Scheduler (prefill_chunk=512,
    blocks of 16) runs four prompts of 1024-2048 tokens with
    prefill_only=True; a decode-tier Scheduler with blocks of 32 resumes
    each from its handoff record (kv_payload, recorded_tokens)."""
    from paddle_tpu_torch import CUDAPlace, decode, serving

    n_layer = sum(1 for s in spec.states if s.feed.startswith("cache_k_"))
    vocab = spec.prefill_program.global_block().var("src_word_emb").shape[0]
    feeds = _request_feeds(np.random.RandomState(_phase_seed("H")), 4, vocab)
    place = CUDAPlace(0)
    pre = serving.Scheduler(spec, scope=scope, place=place,
                            max_batch=S_SLOTS, block_size=S_BLOCK,
                            paged_kv=True, prefill_chunk=C_CHUNK)
    dec = serving.Scheduler(spec, scope=scope, place=place,
                            max_batch=S_SLOTS, block_size=H_BLOCK,
                            paged_kv=True)
    spans = {"export": [], "adopt": []}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    pre.pool.export_rows = timed("export", pre.pool.export_rows)
    dec.pool.adopt_rows = timed("adopt", dec.pool.adopt_rows)

    # the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    g0 = graph_stats()
    t0 = time.perf_counter()
    handles = [pre.submit(f, NEW_TOKENS, eos_id=-1, prefill_only=True)
               for f in feeds]
    pre.run_until_idle()
    moved, payload_bytes = [], []
    for h in handles:
        if h.status != "prefilled":
            raise AssertionError(f"phase H: {h.status} {h.error}")
        rec = h.handoff
        payload_bytes.append(
            sum(v.nbytes for v in rec["kv"].values())
            + sum(v.nbytes for v in rec["states"].values()))
        moved.append(dec.submit(
            serving.decode_feed(rec["feed"]), rec["max_new_tokens"],
            eos_id=rec["eos_id"], recorded_tokens=rec["tokens"],
            kv_payload={"cursor": rec["cursor"], "rows": rec["kv"],
                        "states": rec["states"],
                        "last_tok": rec["last_tok"],
                        "n_tokens": rec["n_tokens"]}))
    dec.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    graphs = graph_stats(g0)
    peak = torch.cuda.max_memory_allocated()
    st_p, st_d = pre.stats(), dec.stats()
    expect = _add(_c_expect(st_p, n_layer), _c_expect(st_d, n_layer))
    if counts != expect:
        raise AssertionError(f"phase H: launches {counts}, the gate "
                             f"predicts {expect} for {st_p}, {st_d}")
    if st_p["handoffs"] != len(feeds) or st_d["adopted"] != len(feeds):
        raise AssertionError(f"phase H: {st_p['handoffs']} handoffs, "
                             f"{st_d['adopted']} adopted")
    pre.pool.assert_quiesced()
    pool_end = dec.pool.assert_quiesced()
    gen = decode.Generator(spec, scope=scope, place=place)
    equal = check_served("H", moved, feeds, gen, NEW_TOKENS)
    res = {"phase": "H", "prefill_block_size": S_BLOCK,
           "decode_block_size": H_BLOCK, "chunk": C_CHUNK,
           "requests": len(moved), "launches": counts,
           "chunk_passes": st_p["chunk_passes"], "steps": st_d["steps"],
           "payload_bytes": payload_bytes,
           "prompt_rows": [int(f["prefix_lens"][0]) for f in feeds],
           "export_ms": spans["export"], "adopt_ms": spans["adopt"],
           "ttft_ms": st_p["ttft_ms"], "wall_s": wall, "pool_end": pool_end,
           "graphs": graphs, "peak_mem_mib": peak / 2 ** 20,
           "requests_equal_to_sequential": equal, "card": card}
    log(f"  phase H: {len(moved)} requests handed off ({st_p['chunk_passes']} "
        f"chunk passes on the prefill tier, {st_d['steps']} steps on the "
        f"decode tier), payload "
        f"{[round(n / 2 ** 20, 2) for n in payload_bytes]} MiB for "
        f"{res['prompt_rows']} rows, export "
        f"{[round(ms, 2) for ms in spans['export']]} ms, adopt "
        f"{[round(ms, 2) for ms in spans['adopt']]} ms, prefill-tier TTFT "
        f"{st_p['ttft_ms']}  [{card}]")
    log(f"    launches {counts}; CUDA graphs {graphs}, peak "
        f"{res['peak_mem_mib']:.0f} MiB; {equal}/{len(moved)} requests equal "
        f"the sequential Generator")
    return res, counts


def c10_line(phases, card):
    """ROADMAP C10's check, on a line of its own: phase C's longest gap
    between decode steps against phase S's longest monolithic prefill
    iteration (7-8 prompts), in the same run."""
    by = {p["phase"]: p for p in phases if "phase" in p}
    gap = by["C"]["decode_gap_ms_max"]
    steady = by["C"]["decode_gap_ms_max_steady"]
    prefill = max(by["S"]["prefill_iteration_ms"])
    log(f"  C10: phase C's longest decode gap {gap:.2f} ms (without the "
        f"iterations that ran a program at a new signature: {steady} ms) "
        f"vs phase S's longest monolithic prefill iteration {prefill:.2f} "
        f"ms: {'bounded' if gap < prefill else 'NOT bounded'}  [{card}]")


def drive_scheduler_paths(card, scope):
    """Phases V (trunc, self), C and H on the one model of [4] and [5]."""
    from paddle_tpu_torch.models import transformer

    results, launches = [], {}
    for leg in ("trunc", "self"):
        res, counts = phase_v(card, scope, leg)
        results.append(res)
        launches = _add(launches, counts)
        torch.cuda.empty_cache()
    spec = decode_spec(transformer.base(), S_WINDOW, S_MAX_LEN,
                       chunk_len=C_CHUNK)
    for phase in (phase_c, phase_h):
        res, counts = phase(card, scope, spec)
        results.append(res)
        launches = _add(launches, counts)
        torch.cuda.empty_cache()
    return results, launches


# ------------------------------------------------------------- training


def flops_per_token(cfg):
    """Forward + backward matmul FLOPs per (src + trg) token pair: the
    formula of bench.py's _transformer_flops_per_token, copied."""
    d, ffn, L, V, S = (cfg.d_model, cfg.d_inner, cfg.n_layer,
                       cfg.trg_vocab_size, cfg.max_length)
    enc_layer = 4 * d * d + 2 * d * ffn
    dec_layer = 8 * d * d + 2 * d * ffn  # self + cross attention
    n_matmul = L * (enc_layer + dec_layer) / 2  # per-stream average
    logits = d * V / 2  # only the decoder stream pays the softmax matmul
    attn = 1.5 * L * 2 * S * d
    return 6.0 * (n_matmul + logits) + 3.0 * 2.0 * attn


def build_training(cfg, use_amp, use_src_lens):
    """transformer.build + Adam(1e-4), as bench.py builds it."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    with program_guard(main, startup), unique_name.guard():
        loss, _ = transformer.build(cfg, seq_len=SEQ,
                                    use_src_lens=use_src_lens)
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        _, params_grads = optimizer.Adam(
            learning_rate=1e-4, multi_precision=use_amp).minimize(loss)
    return main, startup, loss, params_grads


def _persistables(scope, program):
    return {v.name: scope.find_var(v.name).clone()
            for v in program.list_vars() if v.persistable}


def _restore(scope, snapshot):
    """Copy the snapshot into the scope's own tensors: a captured step
    binds every persistable where it lies, and one that moved would be
    copied into its graph at every call."""
    for name, value in snapshot.items():
        scope.find_var(name).copy_(value)


def _interpret_step(eager, main, scope, feed, loss):
    """One step by the interpreter in a scratch scope holding a copy of
    `scope`'s persistables and run counter: [loss].  The allocator caches
    blocks per stream, and the jit path's warm-up runs on a side stream:
    the cache is released on both sides of the step, so that the two
    streams' caches never sit on the card together."""
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.framework.executor import _RNG_COUNTER_NAME

    torch.cuda.empty_cache()
    scratch = Scope()
    for name, value in _persistables(scope, main).items():
        scratch.set_var(name, value)
    scratch.set_var(_RNG_COUNTER_NAME, scope.find_var(_RNG_COUNTER_NAME))
    losses, _ = run_steps(eager, main, scratch, feed, loss, 1)
    del scratch
    torch.cuda.empty_cache()
    return losses


def jit_vs_interpret(phase, exe, main, scope, feed, loss, n):
    """n steps on the default path (`exe`, jit), each run first by the
    interpreter in a scratch scope from the same persistables and run
    counter; the losses must agree within rtol 1e-5 (expected 0).
    Returns (jit losses, interpret losses)."""
    from paddle_tpu_torch import Executor

    eager = Executor(exe.device, mode="interpret")
    jit, ref = [], []
    for _ in range(n):
        ref += _interpret_step(eager, main, scope, feed, loss)
        jit += run_steps(exe, main, scope, feed, loss, 1)[0]
    if not np.allclose(jit, ref, rtol=JIT_RTOL, atol=0):
        raise AssertionError(f"{phase}: jit losses {jit} vs interpret {ref}")
    return jit, ref


def captured_graphs(phase, exe, feed):
    """The graphs `exe` captured: (graphs, arguments bound).  Raises if
    none was captured, or if a graph copies in at every call an argument
    that is not a feed (a persistable that moved)."""
    from paddle_tpu_torch.framework.cuda_graph import CapturedSegment

    n_graphs = n_bound = 0
    for plan in exe._cache.values():
        for seg in plan:
            fn = getattr(seg, "fn", None)
            if not isinstance(fn, CapturedSegment):
                continue
            for g in fn._graphs.values():
                copied = {seg.in_names[i] for i, _, _ in g.copied} - set(feed)
                if copied:
                    raise AssertionError(
                        f"{phase}: segment {fn.label} copies {sorted(copied)} "
                        "in at every call")
                n_graphs += 1
                n_bound += len(g.bound)
    if not n_graphs:
        raise AssertionError(f"{phase}: no step was captured")
    return n_graphs, n_bound


def capture_fields(before, prof, ms_per_step):
    """A training phase's CUDA graphs since `before` (captured, seconds,
    graph-pool MiB, replays, eager warm-ups), the card's busy ms a step
    and the idle share, profiled and as 1 - card / host."""
    gs = graph_stats(before)
    busy = prof["busy_ms_per_step"] if prof else None
    return {"graphs_captured": gs["captures"], "capture_s": gs["capture_s"],
            "graph_pool_mib": gs["pool_bytes"] / 2 ** 20,
            "replays": gs["replays"], "warmups": gs["warmups"],
            "card_busy_ms_per_step": busy,
            "idle_share_profiled": prof["idle_share"] if prof else None,
            "idle_share_unprofiled": (1.0 - busy / ms_per_step
                                      if busy else None),
            "peak_mem_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "peak_reserved_mib": torch.cuda.max_memory_reserved() / 2 ** 20}


def log_capture(phase, res):
    log(f"    {phase} captured: {res['graphs_captured']} graphs "
        f"({res['capture_s']} s, pool {res['graph_pool_mib']:.0f} MiB), "
        f"{res['replays']} replays, {res['warmups']} warm-ups; card busy "
        f"{res['card_busy_ms_per_step']} ms/step, idle share profiled "
        f"{res['idle_share_profiled']}, unprofiled "
        f"{res['idle_share_unprofiled']}; peak {res['peak_mem_mib']:.0f} "
        f"MiB allocated, {res['peak_reserved_mib']:.0f} MiB reserved")


def _train_feed(cfg, batch, seed, ragged, device):
    from paddle_tpu_torch.models import transformer

    feed = transformer.synthetic_batch(batch, cfg, seq_len=SEQ, seed=seed)
    if ragged:
        feed["src_lens"] = np.random.RandomState(seed).randint(
            SEQ // 2, SEQ + 1, size=batch).astype(np.int64)
    # staged on the card once, as bench.py stages its batch
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def run_steps(exe, main, scope, feed, loss, n, fetch_grads=()):
    """n training steps; returns the losses and the first step's grads."""
    losses, grads = [], None
    for i in range(n):
        fetch = [loss] + (list(fetch_grads) if i == 0 else [])
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
        losses.append(float(outs[0].float().reshape(-1)[0]))
        if i == 0:
            grads = outs[1:]
    return losses, grads


def _counts():
    from paddle_tpu_torch.ops.cuda import mha_block

    return {"mha_block": mha_block.launches,
            "mha_block_bwd": mha_block.bwd_launches}


def _zero_counts():
    from paddle_tpu_torch.ops.cuda import (bn_relu_conv1x1, flash_attention,
                                           flash_decode, flash_decode_paged,
                                           mha_block)

    mha_block.launches = mha_block.bwd_launches = flash_decode.launches = 0
    flash_decode_paged.launches = flash_attention.launches = 0
    flash_attention.bwd_dq_launches = flash_attention.bwd_dkv_launches = 0
    bn_relu_conv1x1.launches = 0


def _grad_diff(names, got, want):
    """(max over params of max |got - want| / max |want|, that param, the
    L2 ratio over all grads).  A relu mask flipped by a last-bit
    difference upstream moves single entries of the weights that feed the
    relu, which the max sees and the L2 ratio barely does."""
    rel, worst = max((
        (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30), n)
        for n, a, b in zip(names, got, want, strict=True))
    l2 = (sum((a - b).double().square().sum().item()
              for a, b in zip(got, want))
          / sum(b.double().square().sum().item() for b in want)) ** 0.5
    return rel, worst, l2


def phase_t1(card, device):
    """float32, batch 16, ragged source lengths: kernels vs composite."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(max_length=SEQ, dropout=0.0)
    main, startup, loss, params_grads = build_training(cfg, False, True)
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    feed = _train_feed(cfg, T1_BATCH, SEED + 1, True, device)
    grads = [g.name for _, g in params_grads]

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses, g_kernel = run_steps(exe, main, scope, feed, loss, T1_STEPS,
                                 grads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    expect = {"mha_block": n_attn * T1_STEPS,
              "mha_block_bwd": n_attn * T1_STEPS}
    if counts != expect:
        raise AssertionError(f"T1: launches {counts}, expected {expect}")

    _restore(scope, start)
    flags.set("flash_attention", "0")
    try:
        comp, g_comp = run_steps(exe, main, scope, feed, loss, T1_STEPS,
                                 grads)
    finally:
        flags.reset("flash_attention")
    if not (np.all(np.isfinite(losses))
            and np.allclose(losses, comp, rtol=LOSS_RTOL_F32, atol=0)):
        raise AssertionError(f"T1: losses {losses} vs composite {comp}")
    # the first step once more on the kernels: how far the step's own
    # run-to-run differences go (index_add_ sums with atomics)
    _restore(scope, start)
    _, g_again = run_steps(exe, main, scope, feed, loss, 1, grads)
    rel, worst, l2 = _grad_diff(grads, g_kernel, g_comp)
    rerun, _, _ = _grad_diff(grads, g_again, g_kernel)
    # each step twice from the same state and run counter: the captured
    # graph's replay and the interpreter
    _restore(scope, start)
    jit, ref = jit_vs_interpret("T1", exe, main, scope, feed, loss, T1_STEPS)
    graphs, bound = captured_graphs("T1", exe, feed)
    res = {"phase": "T1", "dtype": "float32", "batch": T1_BATCH, "seq": SEQ,
           "steps": T1_STEPS, "launches": counts, "losses": losses,
           "composite_losses": comp, "max_rel_grad_diff": rel,
           "max_rel_grad_diff_param": worst, "l2_rel_grad_diff": l2,
           "rerun_max_rel_grad_diff": rerun, "jit_losses": jit,
           "interpret_losses": ref, "graphs": graphs, "bound_args": bound,
           "ms_per_step": wall / T1_STEPS * 1e3, "card": card}
    log(f"  T1 float32 batch {T1_BATCH}: losses {losses}; composite {comp}; "
        f"largest relative grad difference {rel:.3e} ({worst}), L2 "
        f"{l2:.3e}, kernels rerun {rerun:.3e}; launches {counts}; "
        f"{res['ms_per_step']:.1f} ms/step; jit {jit} = interpret {ref}; "
        f"{graphs} graphs, {bound} arguments bound  [{card}]")
    return res, counts


def phase_t2(card, device):
    """bench.py's transformer configuration: batch 128, seq 256, bf16 AMP,
    Adam(1e-4, multi_precision=True)."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(max_length=SEQ, dropout=0.0)
    main, startup, loss, _ = build_training(cfg, True, False)
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _train_feed(cfg, T2_BATCH, SEED + 2, False, device)

    start = _persistables(scope, main)
    flags.set("flash_attention", "0")
    try:
        (comp_first,), _ = run_steps(exe, main, scope, feed, loss, 1)
    finally:
        flags.reset("flash_attention")
    _restore(scope, start)
    del start
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    _zero_counts()
    before = graph_stats()
    torch.cuda.reset_peak_memory_stats()
    # the first step runs eagerly, the second is captured, later ones replay
    warm, _ = run_steps(exe, main, scope, feed, loss, T2_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, T2_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), T2_PROFILED,
        top=8, kernels=("mha_block", "mha_block_bwd"))
    counts = _counts()
    n_steps = T2_WARMUP + T2_STEPS + T2_PROFILED
    expect = {"mha_block": n_attn * n_steps,
              "mha_block_bwd": n_attn * n_steps}
    if counts != expect:
        raise AssertionError(f"T2: launches {counts}, expected {expect}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"T2: losses {losses}")
    if abs(losses[0] - comp_first) > LOSS_RTOL_BF16 * abs(comp_first):
        raise AssertionError(f"T2: first loss {losses[0]} vs composite "
                             f"{comp_first}")
    graphs, bound = captured_graphs("T2", exe, feed)
    tokens_per_s = 2 * T2_BATCH * SEQ * T2_STEPS / wall   # src + trg
    res = {"phase": "T2", "dtype": "bfloat16 AMP", "batch": T2_BATCH,
           "seq": SEQ, "warmup": T2_WARMUP, "steps": T2_STEPS,
           "launches": counts, "losses": losses,
           "composite_first_loss": comp_first,
           "tokens_per_s": tokens_per_s, "ms_per_step": wall / T2_STEPS * 1e3,
           "mfu": tokens_per_s * flops_per_token(cfg) /
           PEAK_FLOP_PER_S[torch.bfloat16],
           "flops_per_token": flops_per_token(cfg), "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    log(f"  T2 bf16 AMP batch {T2_BATCH}: {tokens_per_s:.1f} tokens/s, "
        f"{res['ms_per_step']:.2f} ms/step, MFU {res['mfu']:.4f}; losses "
        f"{losses}; composite first {comp_first}; launches {counts}  "
        f"[{card}]")
    log_capture("T2", res)
    log_profile(prof)
    return res, counts


def _mask_elements(main, batch):
    """Elements of every dropout mask of one step at `batch`."""
    block = main.global_block()
    return sum(int(np.prod([batch if d == -1 else d for d in
                            block.var(op.output("Mask")[0]).shape]))
               for op in block.ops if op.type == "dropout")


def phase_t2drop(card, device):
    """Transformer-base at its published configuration (dropout 0.1) in
    T2's step: batch 128, seq 256, bf16 AMP, Adam(1e-4,
    multi_precision=True), captured.  Every step also fetches the first
    dropout's mask.  The eager warm-up and the capture each equal the
    interpreter's step from the same state and run counter; the last two
    replays draw different masks, 0.9 of each kept."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(max_length=SEQ)
    main, startup, loss, _ = build_training(cfg, True, False)
    ops = main.global_block().ops
    n_attn = sum(op.type == "fused_attention" for op in ops)
    n_drop = sum(op.type == "dropout" for op in ops)
    mask = next(op.output("Mask")[0] for op in ops if op.type == "dropout")
    scope, exe = Scope(), Executor(CUDAPlace(0))
    eager = Executor(CUDAPlace(0), mode="interpret")
    exe.run(startup, scope=scope)
    feed = _train_feed(cfg, T2_BATCH, SEED + 6, False, device)
    masks = []

    def step():
        out, m = exe.run(main, feed=feed, fetch_list=[loss, mask],
                         scope=scope, return_numpy=False)
        masks[:] = masks[-1:] + [m]
        return float(out.float().reshape(-1)[0])

    torch.cuda.synchronize()
    _zero_counts()
    before = graph_stats()
    torch.cuda.reset_peak_memory_stats()
    # the eager warm-up and the capture, each after the interpreter's step
    # from the same persistables and run counter in a scratch scope
    warm, ref = [], []
    for _ in range(T2_WARMUP):
        ref += _interpret_step(eager, main, scope, feed, loss)
        warm.append(step())
    if not np.allclose(warm, ref, rtol=JIT_RTOL, atol=0):
        raise AssertionError(f"T2/drop: jit losses {warm} vs interpret {ref}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(T2_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profile_calls(step, T2_PROFILED, top=8,
                         kernels=("mha_block", "mha_block_bwd"))
    res = capture_fields(before, prof, wall / T2_STEPS * 1e3)
    counts = _counts()
    n_steps = 2 * T2_WARMUP + T2_STEPS + T2_PROFILED
    expect = {"mha_block": n_attn * n_steps,
              "mha_block_bwd": n_attn * n_steps}
    if counts != expect:
        raise AssertionError(f"T2/drop: launches {counts}, expected {expect}")
    if torch.equal(masks[0], masks[1]):
        raise AssertionError("T2/drop: two consecutive replays drew the "
                             "same mask")
    kept = [float((m != 0).float().mean()) for m in masks]
    if max(abs(k - 0.9) for k in kept) > KEEP_TOL:
        raise AssertionError(f"T2/drop: kept shares {kept}, expected 0.9")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"T2/drop: losses {losses}")
    graphs, bound = captured_graphs("T2/drop", exe, feed)
    tokens_per_s = 2 * T2_BATCH * SEQ * T2_STEPS / wall
    res.update({
        "phase": "T2/drop", "dtype": "bfloat16 AMP", "dropout": cfg.dropout,
        "batch": T2_BATCH, "seq": SEQ, "warmup": T2_WARMUP,
        "steps": T2_STEPS, "launches": counts, "losses": losses,
        "interpret_losses": ref, "dropouts_per_step": n_drop,
        "mask_elements_per_step": _mask_elements(main, T2_BATCH),
        "kept_share": kept, "tokens_per_s": tokens_per_s,
        "ms_per_step": wall / T2_STEPS * 1e3,
        "mfu": tokens_per_s * flops_per_token(cfg) /
        PEAK_FLOP_PER_S[torch.bfloat16], "graphs": graphs,
        "bound_args": bound, "profile": prof, "card": card})
    log(f"  T2/drop bf16 AMP batch {T2_BATCH}, dropout {cfg.dropout} "
        f"({n_drop} dropouts, {res['mask_elements_per_step']} mask elements "
        f"a step): {tokens_per_s:.1f} tokens/s, {res['ms_per_step']:.2f} "
        f"ms/step, MFU {res['mfu']:.4f}; losses {losses}; warm-up and "
        f"capture vs interpret {ref}; kept shares of the last two masks "
        f"{kept}, they differ; launches {counts}  [{card}]")
    log_capture("T2/drop", res)
    log_profile(prof)
    return res, counts


def drive_training(card, device):
    """Phase 6: transformer.base() trained through Executor.run (T1, T2;
    main() runs T2/drop after them)."""
    results, launches = [], {}
    for phase in (phase_t1, phase_t2):
        res, counts = phase(card, device)
        results.append(res)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 "training path")
    return results, launches


# ------------------------------------------------ BERT at 2048 tokens


def bert_flops_per_token(cfg, seq):
    """Forward + backward matmul FLOPs per input token: the formula of
    bench.py's _bert_flops_per_token, copied."""
    h, f, L, v, m = (cfg.hidden, cfg.ffn, cfg.layers, cfg.vocab_size,
                     cfg.max_predictions)
    per_layer = 8 * h * h + 4 * h * f + 4 * seq * h  # qkv+out, ffn, scores+ctx
    mlm = (m / seq) * (2 * h * h + 2 * h * v)  # transform + tied logits
    pooler = 2 * h * h / seq
    return 3.0 * (L * per_layer + mlm + pooler)


def build_bert(cfg, use_amp):
    """bert.build(use_input_mask=True) + Adam(1e-4), as bench.py builds
    its long_2048_masked leg."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import bert

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    with program_guard(main, startup), unique_name.guard():
        loss = bert.build(cfg, use_input_mask=True)[0]
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        optimizer.Adam(learning_rate=1e-4,
                       multi_precision=use_amp).minimize(loss)
    return main, startup, loss


def _bert_setup(batch, use_amp, seed, device):
    """BERT-base at L_SEQ tokens (dropout 0): the program, its startup run
    on the card, the starting persistables and a staged ragged batch."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(max_positions=L_SEQ, dropout=0.0)
    main, startup, loss = build_bert(cfg, use_amp)
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = bert.synthetic_batch(batch, cfg, seed=seed, use_input_mask=True)
    feed = {k: torch.as_tensor(v, device=device) for k, v in feed.items()}
    return cfg, main, loss, n_attn, scope, exe, feed


def _bert_counts():
    from paddle_tpu_torch.ops.cuda import flash_attention, mha_block

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention.bwd_dq_launches,
            "flash_attention_bwd_dkv": flash_attention.bwd_dkv_launches,
            "mha_block": mha_block.launches,
            "mha_block_bwd": mha_block.bwd_launches}


def _bert_expect(n_attn, steps):
    """Per step and attention: #3 in the forward and again in the grad
    (out and lse recomputed), #4 and #5 once; no mha_block."""
    return {"flash_attention_fwd": 2 * n_attn * steps,
            "flash_attention_bwd_dq": n_attn * steps,
            "flash_attention_bwd_dkv": n_attn * steps,
            "mha_block": 0, "mha_block_bwd": 0}


def _real_tokens(feed):
    return int(feed["input_mask"].float().sum().item())


def phase_l1(card, device):
    """float32, batch 2, ragged masks: kernels vs composite."""
    from paddle_tpu_torch import flags

    cfg, main, loss, n_attn, scope, exe, feed = _bert_setup(
        L1_BATCH, False, SEED + 3, device)
    start = _persistables(scope, main)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses, _ = run_steps(exe, main, scope, feed, loss, L1_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _bert_counts()
    expect = _bert_expect(n_attn, L1_STEPS)
    if counts != expect:
        raise AssertionError(f"L1: launches {counts}, expected {expect}")
    _restore(scope, start)
    flags.set("flash_attention", "0")
    try:
        comp, _ = run_steps(exe, main, scope, feed, loss, L1_STEPS)
    finally:
        flags.reset("flash_attention")
    if not (np.all(np.isfinite(losses))
            and np.allclose(losses, comp, rtol=LOSS_RTOL_F32, atol=0)):
        raise AssertionError(f"L1: losses {losses} vs composite {comp}")
    _restore(scope, start)
    jit, ref = jit_vs_interpret("L1", exe, main, scope, feed, loss, L1_STEPS)
    graphs, bound = captured_graphs("L1", exe, feed)
    res = {"phase": "L1", "dtype": "float32", "batch": L1_BATCH,
           "seq": L_SEQ, "steps": L1_STEPS, "real_tokens": _real_tokens(feed),
           "launches": counts, "losses": losses, "composite_losses": comp,
           "jit_losses": jit, "interpret_losses": ref, "graphs": graphs,
           "bound_args": bound,
           "ms_per_step": wall / L1_STEPS * 1e3, "card": card}
    log(f"  L1 float32 batch {L1_BATCH}: losses {losses}; composite {comp}; "
        f"launches {counts}; {res['ms_per_step']:.1f} ms/step; jit {jit} = "
        f"interpret {ref}; {graphs} graphs, {bound} arguments bound  "
        f"[{card}]")
    return res, counts


def phase_l2(card, device):
    """bench.py's long_2048_masked leg: batch 16, bf16 AMP,
    Adam(1e-4, multi_precision=True)."""
    from paddle_tpu_torch import flags

    cfg, main, loss, n_attn, scope, exe, feed = _bert_setup(
        L2_BATCH, True, SEED + 4, device)
    start = _persistables(scope, main)
    flags.set("flash_attention", "0")
    try:
        (comp_first,), _ = run_steps(exe, main, scope, feed, loss, 1)
    finally:
        flags.reset("flash_attention")
    _restore(scope, start)
    del start
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    _zero_counts()
    before = graph_stats()
    torch.cuda.reset_peak_memory_stats()
    warm, _ = run_steps(exe, main, scope, feed, loss, L2_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, L2_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), L2_PROFILED,
        top=8, kernels=("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"))
    counts = _bert_counts()
    expect = _bert_expect(n_attn, L2_WARMUP + L2_STEPS + L2_PROFILED)
    if counts != expect:
        raise AssertionError(f"L2: launches {counts}, expected {expect}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"L2: losses {losses}")
    if abs(losses[0] - comp_first) > LOSS_RTOL_BF16 * abs(comp_first):
        raise AssertionError(f"L2: first loss {losses[0]} vs composite "
                             f"{comp_first}")
    graphs, bound = captured_graphs("L2", exe, feed)
    tokens_per_s = L2_BATCH * L_SEQ * L2_STEPS / wall   # bench.py:331
    fpt = bert_flops_per_token(cfg, L_SEQ)
    res = {"phase": "L2", "dtype": "bfloat16 AMP", "batch": L2_BATCH,
           "seq": L_SEQ, "warmup": L2_WARMUP, "steps": L2_STEPS,
           "real_tokens": _real_tokens(feed), "launches": counts,
           "losses": losses, "composite_first_loss": comp_first,
           "tokens_per_s": tokens_per_s, "ms_per_step": wall / L2_STEPS * 1e3,
           "mfu": tokens_per_s * fpt / PEAK_FLOP_PER_S[torch.bfloat16],
           "flops_per_token": fpt, "graphs": graphs, "bound_args": bound,
           "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    log(f"  L2 bf16 AMP batch {L2_BATCH} x {L_SEQ}: {tokens_per_s:.1f} "
        f"tokens/s, {res['ms_per_step']:.2f} ms/step, MFU "
        f"{res['mfu']:.4f}; losses {losses}; composite first {comp_first}; "
        f"launches {counts}  [{card}]")
    log_capture("L2", res)
    log_profile(prof)
    return res, counts


def drive_bert(card, device):
    """Phase 7: BERT-base pretrained at 2048 tokens through Executor.run."""
    results, launches = [], {}
    for phase in (phase_l1, phase_l2):
        res, counts = phase(card, device)
        results.append(res)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
    return results, launches


# ------------------------------------------------------ ResNet-50 training


def build_resnet(use_amp, lr):
    """resnet.build(dataset="imagenet", fused_loss=True) + Momentum(lr, 0.9,
    multi_precision=use_amp), AMP cast before minimize, as bench.py builds
    its resnet50 leg."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import resnet

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    with program_guard(main, startup), unique_name.guard():
        loss = resnet.build(dataset="imagenet", fused_loss=True)[0]
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        _, params_grads = optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            multi_precision=use_amp).minimize(loss)
    return main, startup, loss, params_grads


def _resnet_feed(batch, seed):
    """bench.py's draws (bench.py:466-470): img randn, then label."""
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 3, R_HW, R_HW).astype(np.float32),
            "label": rng.randint(0, R_CLASSES, (batch, 1)).astype(np.int64)}


def _port_kernel_counts():
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc

    counts = launch_counts()
    counts.update(_bert_counts())
    counts["bn_relu_conv1x1"] = brc.launches
    return counts


def phase_r1(card, device):
    """float32, batch 8: Momentum steps on the card and the same steps on
    the port's CPU path from the same weights; every forward conv runs
    with cuDNN's TF32 off."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope

    main, startup, loss, params_grads = build_resnet(False, R1_LR)
    n_conv = sum(op.type == "conv2d" for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    start = _persistables(scope, main)
    feed = _resnet_feed(R1_BATCH, SEED + 5)
    grads = [g.name for _, g in params_grads]
    seen, real_conv = [], torch.nn.functional.conv2d

    def spy(x, *args, **kw):
        seen.append((x.dtype, torch.backends.cudnn.allow_tf32))
        return real_conv(x, *args, **kw)

    torch.nn.functional.conv2d = spy
    before = graph_stats()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, g_card = run_steps(exe, main, scope, feed, loss, R1_STEPS,
                                   grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.nn.functional.conv2d = real_conv
    # a replay runs no Python: the convs are seen in the steps that ran
    # their ops (eager warm-ups and captures), the replays run those
    gs = graph_stats(before)
    eager = gs["warmups"] + gs["captures"]
    if len(seen) != n_conv * eager or eager + gs["replays"] != R1_STEPS \
            or any(dt != torch.float32 or tf32 for dt, tf32 in seen):
        raise AssertionError(f"R1: {len(seen)} forward convs, expected "
                             f"{n_conv * eager} ({gs}), all float32 with "
                             f"cudnn.allow_tf32 off: {set(seen)}")
    cpu_scope = Scope()
    for name, value in start.items():
        cpu_scope.set_var(name, value.cpu())
    del start
    t0 = time.perf_counter()
    cpu_losses, g_cpu = run_steps(Executor(CPUPlace()), main, cpu_scope,
                                  feed, loss, R1_STEPS, grads)
    cpu_wall = time.perf_counter() - t0
    if not (np.all(np.isfinite(losses)) and np.allclose(
            losses, cpu_losses, rtol=R1_LOSS_RTOL, atol=0)):
        raise AssertionError(f"R1: card losses {losses} vs CPU {cpu_losses}")
    rel, worst, l2 = _grad_diff(grads, [g.cpu() for g in g_card], g_cpu)
    jit, ref = jit_vs_interpret("R1", exe, main, scope, feed, loss, R1_STEPS)
    graphs, bound = captured_graphs("R1", exe, feed)
    res = {"phase": "R1", "dtype": "float32", "batch": R1_BATCH,
           "steps": R1_STEPS, "lr": R1_LR, "losses": losses,
           "cpu_losses": cpu_losses, "max_rel_grad_diff": rel,
           "max_rel_grad_diff_param": worst, "l2_rel_grad_diff": l2,
           "forward_convs_tf32_off": len(seen), "jit_losses": jit,
           "interpret_losses": ref, "graphs": graphs, "bound_args": bound,
           "ms_per_step": wall / R1_STEPS * 1e3,
           "cpu_ms_per_step": cpu_wall / R1_STEPS * 1e3, "card": card}
    log(f"  R1 float32 batch {R1_BATCH}: card losses {losses}; CPU "
        f"{cpu_losses}; step-1 grads vs CPU: largest relative difference "
        f"{rel:.3e} ({worst}), L2 {l2:.3e}; {len(seen)} forward convs with "
        f"TF32 off; {res['ms_per_step']:.1f} ms/step (CPU "
        f"{res['cpu_ms_per_step']:.0f}); jit {jit} = interpret {ref}; "
        f"{graphs} graphs, {bound} arguments bound  [{card}]")
    return res


def _f32_forward_loss(scope, feed, device):
    """The loss of a float32 forward (resnet.build, no optimizer) over the
    same weights and batch: the bf16 parameters read as float32."""
    from paddle_tpu_torch import (CUDAPlace, Executor, Program, Scope,
                                  program_guard, unique_name)
    from paddle_tpu_torch.models import resnet

    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        loss = resnet.build(dataset="imagenet", fused_loss=True)[0]
    f32 = Scope()
    for v in main.list_vars():
        if v.persistable:
            f32.set_var(v.name, scope.find_var(v.name).float())
    (out,) = Executor(CUDAPlace(0)).run(main, feed=feed, fetch_list=[loss],
                                        scope=f32, return_numpy=False)
    return float(out.float().reshape(-1)[0])


def phase_r2(card, device):
    """bench.py's resnet50 step: batch 256, bf16 AMP, Momentum(0.1, 0.9,
    multi_precision=True); no kernel of the port runs in it."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope

    main, startup, loss, _ = build_resnet(True, 0.1)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {k: torch.as_tensor(v, device=device)
            for k, v in _resnet_feed(R2_BATCH, 0).items()}
    ref_first = _f32_forward_loss(scope, feed, device)
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    _zero_counts()
    before = graph_stats()
    torch.cuda.reset_peak_memory_stats()
    warm, _ = run_steps(exe, main, scope, feed, loss, R2_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, R2_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), R2_PROFILED,
        top=10)
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"R2: the ResNet step launched port kernels "
                             f"{counts}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"R2: losses {losses}")
    if abs(losses[0] - ref_first) > LOSS_RTOL_BF16 * abs(ref_first):
        raise AssertionError(f"R2: first loss {losses[0]} vs the float32 "
                             f"forward's {ref_first}")
    graphs, bound = captured_graphs("R2", exe, feed)
    img_s = R2_BATCH * R2_STEPS / wall
    res = {"phase": "R2", "dtype": "bfloat16 AMP", "batch": R2_BATCH,
           "warmup": R2_WARMUP, "steps": R2_STEPS, "losses": losses,
           "f32_forward_first_loss": ref_first, "images_per_s": img_s,
           "ms_per_step": wall / R2_STEPS * 1e3,
           "mfu": img_s * 3.0 * RESNET50_FWD_FLOPS /
           PEAK_FLOP_PER_S[torch.bfloat16], "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    log(f"  R2 bf16 AMP batch {R2_BATCH}: {img_s:.1f} img/s, "
        f"{res['ms_per_step']:.2f} ms/step, MFU {res['mfu']:.4f}; losses "
        f"{losses}; float32 forward {ref_first}  [{card}]")
    log_capture("R2", res)
    log_profile(prof)
    return res, (main, scope, exe, feed, loss)


def conv3_sites(main):
    """(batch_norm, relu, conv2d) of every bottleneck's conv3: a 1x1 conv
    reading the relu of a batch norm of a 3x3 conv (conv2)."""
    block = main.global_block()
    producer = {}
    for op in block.ops:
        for n in op.output_arg_names:
            producer.setdefault(n, op)
    sites = []
    for op in block.ops:
        if op.type != "conv2d" or tuple(
                block.var(op.input("Filter")[0]).shape[2:]) != (1, 1):
            continue
        relu = producer.get(op.input("Input")[0])
        bn = relu is not None and relu.type == "relu" and producer.get(
            relu.input("X")[0])
        conv2 = bn and bn.type == "batch_norm" and producer.get(
            bn.input("X")[0])
        if conv2 and conv2.type == "conv2d" and tuple(
                block.var(conv2.input("Filter")[0]).shape[2:]) == (3, 3):
            sites.append((bn, relu, op))
    return sites


def _bn_relu_conv(bn, relu, conv, scope, y, device):
    """The port's own batch_norm + relu + conv2d lowerings on y."""
    from paddle_tpu_torch.ops import registry

    def run(op, inputs):
        return registry.run_forward(registry.get_runtime_info(op.type),
                                    inputs, op.attrs, out_names=op.outputs,
                                    device=device)

    ins = {p: [scope.find_var(op_in) for op_in in bn.input(p)]
           for p in ("Scale", "Bias", "Mean", "Variance")}
    act = run(bn, dict(ins, X=[y]))["Y"][0]
    act = run(relu, {"X": [act]})["Out"][0]
    return run(conv, {"Input": [act], "Filter": [
        scope.find_var(conv.input("Filter")[0])]})["Output"][0]


def phase_rprobe(card, device, main, scope, exe, feed, loss):
    """Kernel #8 at the 16 conv3 sites of R2's step: each site's y (conv2's
    output), the BN's saved statistics and affine folded into scale' =
    gamma * rstd and bias' = beta - mu * scale', conv3's filter as [C, K];
    #8's output against the port's own batch_norm + relu + conv2d of that
    y."""
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc

    sites = conv3_sites(main)
    if len(sites) != R_SITES:
        raise AssertionError(f"R/probe: {len(sites)} conv3 sites, expected "
                             f"{R_SITES}")
    fetch = [loss]
    for bn, _, _ in sites:
        fetch += [bn.input("X")[0], bn.output("SavedMean")[0],
                  bn.output("SavedVariance")[0]]
    outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)
    torch.cuda.synchronize()
    _zero_counts()
    errs, shapes = [], []
    for i, (bn, relu, conv) in enumerate(sites):
        y, mu, rstd = outs[1 + 3 * i: 4 + 3 * i]
        gamma = scope.find_var(bn.input("Scale")[0]).float()
        beta = scope.find_var(bn.input("Bias")[0]).float()
        s_ = (gamma * rstd.float()).contiguous()
        b_ = (beta - mu.float() * s_).contiguous()
        filt = scope.find_var(conv.input("Filter")[0])
        w = filt.reshape(filt.shape[0], filt.shape[1]).t().contiguous()
        z = brc.bn_relu_conv1x1(y.contiguous(), s_, b_, w)
        ref = _bn_relu_conv(bn, relu, conv, scope, y, device)
        torch.cuda.synchronize()
        errs.append(_conv1x1_err(z, ref, torch.bfloat16, False))
        shapes.append(f"{tuple(y.shape)}->{filt.shape[0]}")
        del z, ref
    launches = brc.launches
    if launches != R_SITES:
        raise AssertionError(f"R/probe: {launches} #8 launches, expected "
                             f"{R_SITES}")
    if not max(errs) <= BF16_TOL:
        raise AssertionError(f"R/probe: #8 vs batch_norm + relu + conv2d: "
                             f"errors {errs} > {BF16_TOL}")
    res = {"phase": "R/probe", "sites": R_SITES, "launches": launches,
           "max_rel_err": max(errs), "errs": errs, "shapes": shapes,
           "card": card}
    log(f"  R/probe: {R_SITES} conv3 sites of R2's step, #8 vs the port's "
        f"batch_norm + relu + conv2d: largest error {max(errs):.2e} of the "
        f"output's largest magnitude; {launches} launches  [{card}]")
    return res, launches


def drive_resnet(card, device):
    """Phase 8: ResNet-50 trained through Executor.run (R1, R2), kernel #8
    on R2's conv3 sites (R/probe), then the conv1x1 probe."""
    from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc
    from paddle_tpu_torch.tools import conv1x1_fuse_probe

    results = [phase_r1(card, device)]
    torch.cuda.empty_cache()
    res, state = phase_r2(card, device)
    results.append(res)
    res, site_launches = phase_rprobe(card, device, *state)
    results.append(res)
    del state
    torch.cuda.empty_cache()
    log(f"  conv1x1 probe (python -m paddle_tpu_torch.tools."
        f"conv1x1_fuse_probe) [{card}]")
    _zero_counts()
    probe = conv1x1_fuse_probe.main(["--reps", "10"])
    probe_launches = brc.launches
    results.append({"phase": "R/conv1x1_probe", "launches": probe_launches,
                    "shapes": probe, "card": card})
    torch.cuda.empty_cache()
    return results, {"bn_relu_conv1x1": site_launches + probe_launches}


# ------------------------------------------------------ GoogLeNet training


def build_googlenet(use_amp):
    """googlenet.build(with_aux=True) + Momentum(0.01, 0.9,
    multi_precision=use_amp), random_seed 1, AMP cast before minimize, as
    bench.py's _setup builds its googlenet leg."""
    from paddle_tpu_torch import (Program, amp, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import googlenet

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 1
    with program_guard(main, startup), unique_name.guard():
        loss = googlenet.build(with_aux=True)[0]
        if use_amp:
            amp.cast_model_to_bf16(main, startup)
        optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                           multi_precision=use_amp).minimize(loss)
    return main, startup, loss


def _googlenet_feed(batch):
    """bench.py's draws (bench.py:531-536): RandomState(0), img randn, then
    label."""
    rng = np.random.RandomState(0)
    return {"img": rng.randn(batch, 3, R_HW, R_HW).astype(np.float32),
            "label": rng.randint(0, R_CLASSES, (batch, 1)).astype(np.int64)}


def _g_f32_check(device):
    """The float32 `clone(for_test=True)` forward loss at batch 8 on the
    card and on the port's CPU path, from the same weights."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, Executor, Scope

    main, startup, loss = build_googlenet(False)
    test = main.clone(for_test=True)
    scope = Scope()
    Executor(CUDAPlace(0)).run(startup, scope=scope)
    feed = _googlenet_feed(G_CHECK_BATCH)
    (on_card,) = Executor(CUDAPlace(0)).run(test, feed=feed,
                                            fetch_list=[loss], scope=scope)
    cpu_scope = Scope()
    for name, value in _persistables(scope, test).items():
        cpu_scope.set_var(name, value.cpu())
    (on_cpu,) = Executor(CPUPlace()).run(test, feed=feed, fetch_list=[loss],
                                         scope=cpu_scope)
    on_card, on_cpu = float(on_card.ravel()[0]), float(on_cpu.ravel()[0])
    if not (np.isfinite(on_card) and abs(on_card - on_cpu)
            <= G_LOSS_RTOL * abs(on_cpu)):
        raise AssertionError(f"G: float32 test loss on the card {on_card} vs "
                             f"the CPU's {on_cpu}")
    return on_card, on_cpu


def phase_g(card, device):
    """bench.py's googlenet leg: batch 128, bf16 AMP, Momentum(0.01, 0.9,
    multi_precision=True), captured; no kernel of the port runs in it.
    Then the float32 test forward, card vs CPU."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope
    from paddle_tpu_torch.framework.core_types import dtype_to_torch

    main, startup, loss = build_googlenet(True)
    n_drop = sum(op.type == "dropout" for op in main.global_block().ops)
    scope, exe = Scope(), Executor(CUDAPlace(0))
    exe.run(startup, scope=scope)
    block = main.global_block()
    # staged on the card once, in the declared dtypes (img is bf16 under
    # AMP, as bench.py casts it)
    feed = {k: torch.as_tensor(v, device=device).to(
                dtype_to_torch(block.var(k).dtype))
            for k, v in _googlenet_feed(G_BATCH).items()}

    torch.cuda.synchronize()
    _zero_counts()
    before = graph_stats()
    torch.cuda.reset_peak_memory_stats()
    warm, _ = run_steps(exe, main, scope, feed, loss, G_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, G_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profile_calls(
        lambda: run_steps(exe, main, scope, feed, loss, 1), G_PROFILED,
        top=10)
    counts = _port_kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"G: the GoogLeNet step launched port kernels "
                             f"{counts}")
    losses = warm + timed
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"G: losses {losses}")
    graphs, bound = captured_graphs("G", exe, feed)
    res = {"phase": "G", "dtype": "bfloat16 AMP", "batch": G_BATCH,
           "warmup": G_WARMUP, "steps": G_STEPS, "dropouts": n_drop,
           "losses": losses, "images_per_s": G_BATCH * G_STEPS / wall,
           "ms_per_step": wall / G_STEPS * 1e3, "graphs": graphs,
           "bound_args": bound, "profile": prof, "card": card}
    res.update(capture_fields(before, prof, res["ms_per_step"]))
    del scope, exe, feed
    torch.cuda.empty_cache()
    res["f32_test_loss"], res["f32_test_loss_cpu"] = _g_f32_check(device)
    log(f"  G bf16 AMP batch {G_BATCH}: {res['images_per_s']:.1f} img/s, "
        f"{res['ms_per_step']:.2f} ms/step; losses {losses}; float32 test "
        f"forward at batch {G_CHECK_BATCH}: card {res['f32_test_loss']}, "
        f"CPU {res['f32_test_loss_cpu']}  [{card}]")
    log_capture("G", res)
    log_profile(prof)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    # float32 matmuls (the `mul` op, the plain versions, the composite)
    # must not round through TF32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is on")
    import paddle_tpu_torch  # noqa: F401  (fails alone, outside a checkout)
    from paddle_tpu_torch.ops.cuda import _build

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[1] device {kind} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    info = _build.build()
    log(f"[2] built {sorted(info)} in {time.perf_counter() - t0:.1f} s wall")
    for name, rec in info.items():
        log(f"  {name}: nvcc {rec['seconds']:.1f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")
    laps = [time.perf_counter()]

    def lap(step):
        laps.append(time.perf_counter())
        log(f"  {step} took {laps[-1] - laps[-2]:.1f} s wall")

    log(f"[3] kernels vs plain versions at the main path's shapes [{card}]")
    cases = check_kernels(device)
    lap("[3]")

    log(f"[4] serving: transformer.base() through decode.Generator, then "
        f"serving.Scheduler [{card}]")
    phases, launches, scope = drive_main_path(card)
    lap("[4]")

    log(f"[5] serving: transformer.base() through serving.Scheduler over "
        f"the device pool: phase S, then speculative decoding (V/trunc, "
        f"V/self), chunked prefill (C) and the two-tier handoff (H) [{card}]")
    res, counts = phase_s(card, scope)
    phases.append(res)
    more, more_counts = drive_scheduler_paths(card, scope)
    phases += more
    counts = _add(counts, more_counts)
    c10_line(phases, card)
    del scope
    torch.cuda.empty_cache()
    lap("[5]")

    log(f"[6] training: transformer.base() through Executor.run on the "
        f"jit path (T1, T2, T2/drop) [{card}]")
    training, train_launches = drive_training(card, device)
    lap("[6] T1, T2")
    res, drop_launches = phase_t2drop(card, device)
    training.append(res)
    train_launches = _add(train_launches, drop_launches)
    torch.cuda.empty_cache()
    lap("[6] T2/drop")

    log(f"[7] pretraining: BERT-base at {L_SEQ} tokens through "
        f"Executor.run [{card}]")
    bert_runs, bert_launches = drive_bert(card, device)
    training += bert_runs
    lap("[7]")

    log(f"[8] training: ResNet-50 through Executor.run, kernel #8 on its "
        f"conv3 sites, the conv1x1 probe [{card}]")
    resnet_runs, resnet_launches = drive_resnet(card, device)
    training += resnet_runs
    lap("[8]")

    log(f"[9] training: GoogLeNet through Executor.run [{card}]")
    training.append(phase_g(card, device))
    torch.cuda.empty_cache()
    lap("[9] G")
    for more in (counts, train_launches, bert_launches, resnet_launches):
        for k, n in more.items():
            launches[k] = launches.get(k, 0) + n
    never = [k for k in KERNELS if not launches.get(k)]
    if never:
        raise AssertionError(f"kernels {never} never launched on a path")

    log(f"  all phases took {laps[-1] - laps[0]:.1f} s wall")
    log("[10] results")
    log(json.dumps({"phases": phases}))
    log(json.dumps({"training": training}))
    if DIVERGED:
        log(f"FAILED: {len(DIVERGED)} served requests differ from the "
            f"sequential Generator: {json.dumps(DIVERGED)}")
        return 1
    kernels = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]   # the shape the main path launches most
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_us": head["bound_ms"] * 1e3,
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            "cases": [{k: c[k] for k in ("case", "shape", "max_abs_err", "ms",
                                         "device_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "flop", "bytes",
                                         "tflops")}
                      for c in mine],
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
