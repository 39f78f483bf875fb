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
     in float32 and batch 128 in bfloat16) against its plain PyTorch
     version on the card (float32: max abs error <= 1e-4; bfloat16: 2e-2,
     of the output's largest magnitude for the backward), then timed with
     CUDA events, L2 flushed before every launch: kernel, plain version,
     and the library yardstick the port never calls
     (F.scaled_dot_product_attention with an equivalent mask, and for the
     backward its autograd backward alone), beside the least time the card
     could take (bytes over 3.35 TB/s, or FLOP over 67 TFLOP/s for float32
     and 989 TFLOP/s for bfloat16 inputs);
  4. serving: decode.Generator(...).generate, greedy, on
     transformer.base() with seeded random weights, in two phases
     (A: translation, 256-token sources and short prefixes; B: a long
     cache, 1024-token prefixes in a 2048-slot cache).  Each phase's
     kernel launch counts are set to 0 just before generate and read just
     after, and must equal what the gate predicts.  Then the same feeds
     through the composite tier (flash_attention "0"): prefill and
     teacher-forced step logits must agree within 1e-3;
  5. training: transformer.build + Adam(1e-4) through Executor.run on
     transformer.base() (dropout 0, seq 256, random tokens from a seed).
     T1, float32, batch 16, ragged source lengths 128-256: 4 steps with
     the launch counts set to 0 before and 18 forward and 18 backward
     mha_block launches a step after; the same 4 steps from the same
     weights through the composite must give the same losses (rtol
     1e-4).  T2, bench.py's transformer configuration (batch 128, bf16
     AMP, Adam multi_precision): 2 warm-up and 5 timed steps, tokens/s,
     ms per step, card busy time and idle share, peak memory and MFU;
     its first loss must match the composite's within 2e-2;
  6. one {"kernels": [...]} line, the card's name and power limit, and
     last the {"ok": true, "device": ...} line.

Exits non-zero, printing no result, when there is no CUDA device or when
any check fails.
"""

from __future__ import annotations

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

KERNELS = {
    "mha_block": {
        "source": "paddle_tpu_torch/csrc/mha_block.cu",
        "replaces": "paddle_tpu/ops/pallas/mha_block.py:109",
        "device_names": ("mha_fwd_kernel",),
    },
    "mha_block_bwd": {
        "source": "paddle_tpu_torch/csrc/mha_block_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/mha_block.py:120",
        "device_names": ("mha_bwd_dq_kernel", "mha_bwd_dkv_kernel"),
    },
    "flash_decode": {
        "source": "paddle_tpu_torch/csrc/flash_decode.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:630",
        "device_names": ("decode_split_kernel", "decode_merge_kernel"),
    },
}


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

    def ms(self, fn):
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def device_ms(self, fn, names):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(self.reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        mine = [s for s in device_spans(prof)
                if any(n in s[0] for n in names)]
        if not mine:
            return None   # the profiler saw no device activity
        return sum(b - a for _, a, b in mine) / self.reps / 1e3


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


def _live(b, sq, sk, causal, key_len):
    """Live (query, key) pairs and live key rows per image, as the kernels
    visit them: keys past key_len and above the causal diagonal are
    skipped."""
    kl = [sk] * b if key_len is None else key_len.tolist()
    if causal:
        off = sk - sq
        pairs = [sum(min(r + off + 1, n) for r in range(sq)) for n in kl]
        rows = [min(sk, n) for n in kl]
    else:
        pairs = [sq * min(sk, n) for n in kl]
        rows = [min(sk, n) for n in kl]
    return sum(pairs), sum(rows)


def _shape(b, sq, sk, hd, causal, lens, dtype):
    return (f"q {b}x{sq}x{hd} k {b}x{sk}x{hd}{' causal' if causal else ''}"
            f"{'' if lens is None else f' key_len {lens[0]}-{lens[1]}'}"
            f" {str(dtype).replace('torch.', '')}")


def mha_case(name, b, sq, sk, h, d, causal, lens, device, rng,
             dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               .to(dtype) for s in (sq, sk, sk))
    key_len = None if lens is None else _lengths(rng, *lens, b, device)
    pairs, rows = _live(b, sq, sk, causal, key_len)
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
    return dict(kernel="mha_block", case=name, fns=(kernel, plain, library),
                shape=_shape(b, sq, sk, h * d, causal, lens, dtype),
                dtype=dtype, tol=TOL if dtype == torch.float32 else BF16_TOL,
                flop=4 * d * h * pairs, bytes=nbytes)


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
                flop=5 * 2 * d * h * pairs, bytes=nbytes)


def decode_case(name, b, sk, h, d, lens, device, rng):
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               for s in (1, sk, sk))
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
                      f"kv_len {lens[0]}-{lens[1]} float32",
                dtype=torch.float32, tol=TOL,
                flop=4 * d * h * live,
                bytes=4 * h * d * (2 * b + 2 * live)
                + kv_len.numel() * kv_len.element_size())


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
    timer = Timer(device)
    for c in cases:
        kernel, plain, library = c.pop("fns")
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = _max_err(out, ref, c["dtype"])
        del out, ref
        if not err <= c["tol"]:
            raise AssertionError(f"{c['kernel']} {c['case']}: max error "
                                 f"{err} > {c['tol']}")
        c["max_abs_err"] = err
        c["ms"] = timer.ms(kernel)
        c["device_ms"] = timer.device_ms(
            kernel, KERNELS[c["kernel"]]["device_names"])
        c["plain_ms"] = timer.ms(plain)
        c["library_ms"] = timer.ms(library)
        t_bytes = c["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = c["flop"] / PEAK_FLOP_PER_S[c.pop("dtype")] * 1e3
        c["bound_ms"] = max(t_bytes, t_ops)
        c["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {c['kernel']:13s} {c['case']:24s} [{c['shape']}] "
            f"err {err:.2e}  kernel {c['ms'] * 1e3:9.1f} us (device "
            f"{_us(c['device_ms'])})  plain "
            f"{c['plain_ms'] * 1e3:9.1f} us  library "
            f"{c['library_ms'] * 1e3:9.1f} us  bound "
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


def profile_decode_steps(gen, feed, tok, lengths, states, n_steps):
    """Greedy steps under torch.profiler: host time per step, the card's
    busy time per step (union of its operations) and idle share, and the
    kernels that take most of the card's time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, states = gen._step(tok, lengths, states, feed)
            lengths = lengths + 1
            tok = torch.argmax(logits, -1).cpu().numpy()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    if not spans:
        return None   # the profiler saw no device activity
    per_kernel = {}
    for name, a, b in spans:
        per_kernel[name[:90]] = per_kernel.get(name[:90], 0.0) + (b - a)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    busy = busy_us(spans)
    return {"steps": n_steps, "step_ms": wall_us / n_steps / 1e3,
            "busy_ms_per_step": busy / n_steps / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "top_kernels": [[k, round(v / n_steps, 1)] for k, v in top]}


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
    t0 = time.perf_counter()
    tokens = gen.generate(feed, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = {"mha_block": mha_block.launches,
              "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()

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
    profile_steps = profile_decode_steps(gen, feed, tok, lengths, states,
                                         min(8, max_len - int(lengths.max())))

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
        "step_profile": profile_steps,
        "peak_mem_mib": peak / 2 ** 20,
        "logits_max_abs_diff_vs_composite": errs,
        "greedy_agreement_vs_composite": agree, "card": card,
    }
    log(f"  phase {name}: {tokens.shape[0]}x{tokens.shape[1]} tokens in "
        f"{gen_s:.3f} s ({result['tokens_per_s']:.1f} tokens/s), prefill "
        f"{result['prefill_ms']:.2f} ms, {step_ms:.3f} ms/step, peak "
        f"{result['peak_mem_mib']:.0f} MiB  [{card}]")
    log(f"    launches {counts}; logits vs composite {errs}; greedy "
        f"agreement {agree:.3f}")
    if profile_steps is not None:
        log(f"    profiled steps: {profile_steps['step_ms']:.3f} ms/step, card "
            f"busy {profile_steps['busy_ms_per_step']:.3f} ms/step, idle "
            f"share {profile_steps['idle_share']:.3f}; top kernels "
            f"{profile_steps['top_kernels']}")
    return result, counts


def drive_main_path(card):
    """Phase 4: transformer-base served through decode.Generator."""
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.models import transformer

    cfg = transformer.base()
    scope = Scope()   # one model serves both phases
    results, launches = [], {"mha_block": 0, "flash_decode": 0}
    for name, (prefix_len, _, max_len) in PHASES.items():
        spec = transformer.build_decode(cfg, src_len=SRC_LEN,
                                        prefix_len=prefix_len,
                                        max_len=max_len)
        spec.prefill_startup.random_seed = SEED
        spec.step_startup.random_seed = SEED
        res, counts = run_phase(name, spec, scope, card)
        results.append(res)
        for k, n in counts.items():
            launches[k] += n
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 "serving path")
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
    for name, value in snapshot.items():
        scope.set_var(name, value.clone())


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
    from paddle_tpu_torch.ops.cuda import flash_decode, mha_block

    mha_block.launches = mha_block.bwd_launches = flash_decode.launches = 0


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
    res = {"phase": "T1", "dtype": "float32", "batch": T1_BATCH, "seq": SEQ,
           "steps": T1_STEPS, "launches": counts, "losses": losses,
           "composite_losses": comp, "max_rel_grad_diff": rel,
           "max_rel_grad_diff_param": worst, "l2_rel_grad_diff": l2,
           "rerun_max_rel_grad_diff": rerun,
           "ms_per_step": wall / T1_STEPS * 1e3, "card": card}
    log(f"  T1 float32 batch {T1_BATCH}: losses {losses}; composite {comp}; "
        f"largest relative grad difference {rel:.3e} ({worst}), L2 "
        f"{l2:.3e}, kernels rerun {rerun:.3e}; launches {counts}; "
        f"{res['ms_per_step']:.1f} ms/step  [{card}]")
    return res, counts


def profile_steps(exe, main, scope, feed, loss, n):
    """Training steps under torch.profiler: host ms per step, the card's
    busy ms per step (union of its operations), the idle share and the
    kernels that take most of the card's time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(exe, main, scope, feed, loss, n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    if not spans:
        return None   # the profiler saw no device activity
    per_kernel = {}
    for name, a, b in spans:
        per_kernel[name[:90]] = per_kernel.get(name[:90], 0.0) + (b - a)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    busy = busy_us(spans)
    return {"steps": n, "step_ms": wall_us / n / 1e3,
            "busy_ms_per_step": busy / n / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "top_kernels_ms_per_step": [[k, round(v / n / 1e3, 3)]
                                        for k, v in top]}


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
    warm, _ = run_steps(exe, main, scope, feed, loss, T2_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed, _ = run_steps(exe, main, scope, feed, loss, T2_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prof = profile_steps(exe, main, scope, feed, loss, T2_PROFILED)
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
    tokens_per_s = 2 * T2_BATCH * SEQ * T2_STEPS / wall   # src + trg
    res = {"phase": "T2", "dtype": "bfloat16 AMP", "batch": T2_BATCH,
           "seq": SEQ, "warmup": T2_WARMUP, "steps": T2_STEPS,
           "launches": counts, "losses": losses,
           "composite_first_loss": comp_first,
           "tokens_per_s": tokens_per_s, "ms_per_step": wall / T2_STEPS * 1e3,
           "mfu": tokens_per_s * flops_per_token(cfg) /
           PEAK_FLOP_PER_S[torch.bfloat16],
           "flops_per_token": flops_per_token(cfg),
           "peak_mem_mib": peak / 2 ** 20, "profile": prof, "card": card}
    log(f"  T2 bf16 AMP batch {T2_BATCH}: {tokens_per_s:.1f} tokens/s, "
        f"{res['ms_per_step']:.2f} ms/step, MFU {res['mfu']:.4f}, peak "
        f"{res['peak_mem_mib']:.0f} MiB; losses {losses}; composite first "
        f"{comp_first}; launches {counts}  [{card}]")
    if prof is not None:
        log(f"    profiled steps: {prof['step_ms']:.2f} ms/step, card busy "
            f"{prof['busy_ms_per_step']:.2f} ms/step, idle share "
            f"{prof['idle_share']:.3f}; top kernels "
            f"{prof['top_kernels_ms_per_step']}")
    return res, counts


def drive_training(card, device):
    """Phase 5: transformer.base() trained through Executor.run."""
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

    log(f"[3] kernels vs plain versions at the main path's shapes [{card}]")
    cases = check_kernels(device)

    log(f"[4] serving: transformer.base() through decode.Generator "
        f"[{card}]")
    phases, launches = drive_main_path(card)

    log(f"[5] training: transformer.base() through Executor.run [{card}]")
    training, train_launches = drive_training(card, device)
    for k, n in train_launches.items():
        launches[k] = launches.get(k, 0) + n

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
                                         "bound_by", "flop", "bytes")}
                      for c in mine],
        })
    log("[6] results")
    log(json.dumps({"phases": phases}))
    log(json.dumps({"training": training}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
