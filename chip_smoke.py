#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of the JAX package.  Phases, none of which
catches its own failure:

  1. the card: name, count, power limit;
  2. build both kernels from paddle_tpu_torch/csrc (one nvcc per source,
     started together) and print nvcc's -Xptxas -v report;
  3. each kernel at the main path's shapes (transformer-base: d_model 512,
     8 heads of 64, float32, batch 8) against its plain PyTorch version on
     the card (max abs error <= 1e-4), then timed with CUDA events, L2
     flushed before every launch: kernel, plain version, and
     F.scaled_dot_product_attention with an equivalent mask as the library
     yardstick (the port never calls it), beside the least time the card
     could take (bytes over 3.35 TB/s or float32 FLOP over 67 TFLOP/s);
  4. the main path: decode.Generator(...).generate, greedy, on
     transformer.base() with seeded random weights, in two phases
     (A: translation, 256-token sources and short prefixes; B: a long
     cache, 1024-token prefixes in a 2048-slot cache).  Each phase's
     kernel launch counts are set to 0 just before generate and read just
     after, and must equal what the gate predicts.  Then the same feeds
     through the composite tier (flash_attention "0"): prefill and
     teacher-forced step logits must agree within 1e-3;
  5. one {"kernels": [...]} line, the card's name and power limit, and
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
PEAK_F32_FLOP_PER_S = 67e12   # H100 SXM float32, outside the tensor cores
TOL = 1e-4                    # kernel vs plain version, float32
LOGITS_TOL = 1e-3             # kernel tiers vs composite, end to end
TF_STEPS = 4                  # teacher-forced steps compared

KERNELS = {
    "mha_block": {
        "source": "paddle_tpu_torch/csrc/mha_block.cu",
        "replaces": "paddle_tpu/ops/pallas/mha_block.py:109",
        "device_names": ("mha_fwd_kernel",),
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


def mha_case(name, b, sq, sk, h, d, causal, lens, device, rng):
    g = torch.Generator(device=device).manual_seed(int(rng.randint(1 << 30)))
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=device)
               for s in (sq, sk, sk))
    key_len = None if lens is None else _lengths(rng, *lens, b, device)
    # live (query, key) pairs and key rows per image, as the kernel visits
    # them: keys past key_len and above the causal diagonal are skipped
    kl = [sk] * b if key_len is None else key_len.tolist()
    if causal:
        off = sk - sq
        pairs = [sum(min(r + off + 1, n) for r in range(sq)) for n in kl]
        rows = [min(sk, n) for n in kl]
    else:
        pairs = [sq * n for n in kl]
        rows = kl
    flop = 4 * d * h * sum(pairs)
    nbytes = 4 * h * d * (2 * b * sq + 2 * sum(rows)) + (
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
                shape=f"q {b}x{sq}x{h * d} k {b}x{sk}x{h * d}"
                      f"{' causal' if causal else ''}"
                      f"{'' if lens is None else f' key_len {lens[0]}-{lens[1]}'}",
                flop=flop, bytes=nbytes)


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
                      f"kv_len {lens[0]}-{lens[1]}",
                flop=4 * d * h * live,
                bytes=4 * h * d * (2 * b + 2 * live)
                + kv_len.numel() * kv_len.element_size())


def check_kernels(device):
    """Phase 3: every kernel of the path at the path's shapes."""
    rng = np.random.RandomState(SEED)
    h, d = 8, 64
    cases = [
        mha_case("mha_decode 1x256", BATCH, 1, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
        mha_case("encoder 256x256", BATCH, SRC_LEN, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
        mha_case("causal prefix 1024x1024", BATCH, 1024, 1024, h, d, True,
                 None, device, rng),
        mha_case("cross 1024x256", BATCH, 1024, SRC_LEN, h, d, False,
                 (128, SRC_LEN), device, rng),
        decode_case("flash_decode 1x2048", BATCH, 2048, h, d, (512, 1056),
                    device, rng),
    ]
    timer = Timer(device)
    for c in cases:
        kernel, plain, library = c.pop("fns")
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (err <= TOL and torch.isfinite(out).all()):
            raise AssertionError(f"{c['kernel']} {c['case']}: max abs error "
                                 f"{err} > {TOL}")
        c["max_abs_err"] = err
        c["ms"] = timer.ms(kernel)
        c["device_ms"] = timer.device_ms(
            kernel, KERNELS[c["kernel"]]["device_names"])
        c["plain_ms"] = timer.ms(plain)
        c["library_ms"] = timer.ms(library)
        t_bytes = c["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = c["flop"] / PEAK_F32_FLOP_PER_S * 1e3
        c["bound_ms"] = max(t_bytes, t_ops)
        c["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {c['kernel']:12s} {c['case']:24s} [{c['shape']}] "
            f"err {err:.2e}  kernel {c['ms'] * 1e3:9.1f} us (device "
            f"{_us(c['device_ms'])})  plain "
            f"{c['plain_ms'] * 1e3:9.1f} us  sdpa {c['library_ms'] * 1e3:9.1f}"
            f" us  bound {c['bound_ms'] * 1e3:7.1f} us ({c['bound_by']}: "
            f"{c['flop'] / 1e9:.3f} GFLOP, {c['bytes'] / 1e6:.1f} MB)")
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
    results, launches = [], {k: 0 for k in KERNELS}
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
            raise AssertionError(f"kernel {k} never launched on the main "
                                 "path")
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

    log(f"[4] main path: transformer.base() through decode.Generator "
        f"[{card}]")
    phases, launches = drive_main_path(card)

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
    log("[5] results")
    log(json.dumps({"phases": phases}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
