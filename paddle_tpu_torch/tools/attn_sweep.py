"""Attention-tier crossover sweep on the card: the measurement behind the
attention gate's thresholds.

The port's counterpart of tools/attn_sweep.py's training sweep.  For each
sequence length S and each of {causal, masked}, it times what one
training step runs for one attention in each tier, forward plus
backward, with CUDA events:

  - composite: `attention_reference` and autograd's backward through it;
  - mha_block: kernel #1, then the grad op's kernel #2 (the grad runs no
    forward);
  - flash: kernel #3, then the grad op's #3 again (out and lse
    recomputed: the grad takes no Out), #4 and #5.

A tier is timed wherever its kernels take the shape
(`mha_block.supported`, `flash_attention.supported`), the single-block
tier past the gate's score-tile budget too: that budget is the JAX
kernel's TPU VMEM limit, kept in the gate so that both packages route
alike, and the CUDA kernel streams keys.  Each row also names the tier
the gate picks with its flags as they are (`gate`).  It prints the JAX
tool's JSON: the rows, and per (causal, masked) variant the fastest tier
at each S.  It sets no flag default: re-gating is a decision about the
flags the gate reads (attn_vmem_score_budget, attn_flash_min_scores),
which are trace-affecting and shared with the JAX package's routing.

    python -m paddle_tpu_torch.tools.attn_sweep [--seqs 256,512,...]
        [--batch 8] [--heads 12] [--head-dim 64] [--dtype bfloat16]
        [--steps 10] [--out FILE]

It needs a card, and refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import flags
from ..ops import attention_ops as ao
from ..ops.cuda import flash_attention as fa
from ..ops.cuda import mha_block


def _ms(fn, steps, device):
    """Mean ms of fn() over `steps` calls after two warm-up calls, by CUDA
    events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def _tiers(q, k, v, w, heads, causal, seq_len):
    """{tier: fn() running its forward and its grad op's backward}, with
    the single-block tier's score budget lifted."""
    bias = (ao._seq_len_bias(seq_len, q.shape[0], k.shape[1])
            if seq_len is not None else None)

    def composite():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            out = ao.attention_reference(*leaves, bias, num_heads=heads,
                                         causal=causal, scale=0.0)
            return torch.autograd.grad(out, leaves, w)

    def mha():
        mha_block.mha_attention(q, k, v, heads, causal, 0.0,
                                key_len=seq_len)
        return mha_block.mha_block_bwd(q, k, v, w, heads, causal, 0.0,
                                       key_len=seq_len)

    def flash():
        fa.flash_attention(q, k, v, heads, causal, 0.0, kv_len=seq_len)
        out, lse = fa.flash_attention_lse(q, k, v, heads, causal, 0.0,
                                          kv_len=seq_len)
        return fa.flash_attention_bwd(q, k, v, out, lse, w, heads, causal,
                                      0.0, kv_len=seq_len)

    tiers = {"composite": composite}
    budget = flags.get("attn_vmem_score_budget")
    flags.set("attn_vmem_score_budget", 1 << 62)
    try:
        if mha_block.supported(q, k, heads, causal):
            tiers["mha_block"] = mha
    finally:
        flags.set("attn_vmem_score_budget", budget)
    if fa.supported(q, k, heads, causal):
        tiers["flash"] = flash
    return tiers


def sweep(seqs, batch, heads, head_dim, dtype, steps, device):
    rng = np.random.RandomState(0)
    rows = []
    hd = heads * head_dim
    for s in seqs:
        def draw():
            return torch.as_tensor(rng.randn(batch, s, hd).astype(
                np.float32)).to(device=device, dtype=dtype)

        q, k, v, w = draw(), draw(), draw(), draw()
        seq_len = torch.as_tensor(rng.randint(s // 2, s + 1, (batch,)),
                                  dtype=torch.int32, device=device)
        for causal, masked in ((False, False), (True, False), (False, True),
                               (True, True)):
            row = {"seq": s, "causal": causal, "masked": masked,
                   "batch": batch, "heads": heads, "head_dim": head_dim,
                   "dtype": str(dtype).replace("torch.", ""),
                   "gate": ao._backend_choice(q, k, heads, causal, False,
                                              masked)[0],
                   "ms": {}}
            for name, fn in _tiers(q, k, v, w, heads, causal,
                                   seq_len if masked else None).items():
                try:
                    row["ms"][name] = round(_ms(fn, steps, device), 3)
                except (RuntimeError, ValueError) as e:   # OOM, a refusal
                    row["ms"][name] = f"error: {str(e)[:80]}"
                torch.cuda.empty_cache()
            rows.append(row)
            print(f"S={s} causal={causal} masked={masked} gate="
                  f"{row['gate']}: " + " ".join(f"{n}={m}" for n, m in row["ms"].items()),
                  file=sys.stderr)
    return rows


def crossover(rows):
    """Per (causal, masked) variant: the fastest tier at each S, the table
    the gate's thresholds must reproduce."""
    table = {}
    for row in rows:
        key = f"causal={row['causal']},masked={row['masked']}"
        numeric = {n: m for n, m in row["ms"].items()
                   if isinstance(m, (int, float))}
        if not numeric:
            continue
        best = min(numeric, key=numeric.get)
        table.setdefault(key, []).append(
            {"seq": row["seq"], "best": best, "ms": numeric})
    return table


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except OSError:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seqs", default="256,512,1024,2048,4096")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="write the JSON here (default stdout)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_sweep: no CUDA device")
    device = torch.device("cuda")
    gate_flags = {n: flags.get(n) for n in ("attn_vmem_score_budget",
                                            "attn_flash_min_scores")}
    rows = sweep([int(x) for x in args.seqs.split(",")], args.batch,
                 args.heads, args.head_dim, getattr(torch, args.dtype),
                 args.steps, device)
    doc = {
        "device": torch.cuda.get_device_name(0),
        "card": _card(),
        "mode": "train",
        "gate_flags": gate_flags,
        "rows": rows,
        "crossover": crossover(rows),
    }
    text = json.dumps(doc, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)


if __name__ == "__main__":
    main()
