"""Rank-side cases of the port's mesh tests: each function runs on every
rank of a `paddle_tpu_torch.parallel.world.World` (tests/
test_torch_parallel_executor.py, tests/test_torch_ring_attention.py,
tests/test_torch_mesh_cuda.py) and returns plain numbers.  No JAX here:
the ranks import only the port.

Every case builds its program in the port with the same layers calls
as the JAX test it twins, carries the given weights in with
`convert.load_params`, and feeds each rank its own rows of the same
global batches."""

from __future__ import annotations

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, flags, layers, testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.parallel import (BuildStrategy, ParallelExecutor,
                                       make_mesh, memory, shard)

CPU = pt.CPUPlace()
DIM, CLASSES = 16, 10


def build_mlp(opt="sgd", tp_annotate=False):
    """tests/test_parallel_executor.py's `_build` (opt "sgd") and
    tests/test_zero.py's (opt "adam"), in the port."""
    x = layers.data(name="x", shape=[DIM], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="int64")
    h = layers.fc(input=x, size=32, act="relu")
    pred = layers.fc(input=h, size=CLASSES, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=pred, label=y))
    if opt == "sgd":
        pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    else:
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    if tp_annotate:
        blk = pt.default_main_program().global_block()
        for name, var in blk.vars.items():
            if var.persistable and var.shape and len(var.shape) == 2 \
                    and var.shape[1] == 32:
                shard(var, None, "tp")
    return loss


def build_transformer(cfg_kw):
    loss, _ = PT.build(PT.TransformerConfig(**cfg_kw))
    pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _program(model, **kw):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = (build_mlp(**kw) if model == "mlp"
                else build_transformer(kw["cfg"]))
    return main, startup, loss


def train(model, weights, feeds, mesh=None, strategy=None, build=None,
          flash=None):
    """Losses of len(feeds) steps from `weights` (name -> numpy): through
    ParallelExecutor on `mesh` ({axis: size}) with each rank's rows, or
    on one device (mesh None).  Also returns this rank's optimizer-state
    bytes after the last step."""
    with testing.fresh_programs():
        if flash is not None:
            flags.set("flash_attention", flash)
        try:
            main, startup, loss = _program(model, **(build or {}))
            scope = pt.Scope()
            with pt.scope_guard(scope):
                convert.load_params(scope, weights, CPU, [main])
                if mesh is None:
                    exe = pt.Executor(CPU)
                    run = lambda f: exe.run(main, feed=f, fetch_list=[loss])
                else:
                    bs = BuildStrategy()
                    for k, v in (strategy or {}).items():
                        setattr(bs, k, v)
                    pe = ParallelExecutor(
                        loss_name=loss.name, main_program=main,
                        build_strategy=bs,
                        mesh=make_mesh(place=CPU, **mesh))
                    run = lambda f: pe.run(
                        feed={k: pe.local_batch(v) for k, v in f.items()},
                        fetch_list=[loss.name])
                losses = [float(np.asarray(run(f)[0]).reshape(-1)[0])
                          for f in feeds]
                return {"losses": losses,
                        "opt_bytes": memory.optimizer_state_bytes(scope,
                                                                  main),
                        "mode": None if mesh is None else pe.executor_mode}
        finally:
            flags.reset("flash_attention")


def ring(q, k, v, g, causal, lens, flash=None):
    """ring_attention on an sp mesh of the whole world (q, k, v the full
    [B, S, H*D] arrays, the same on every rank): the output, and the
    grads for the cotangent g by ring_attention_grad and by autograd
    through ring_attention; the ring body taken."""
    from paddle_tpu_torch.parallel import ring_attention as ra

    n = torch.distributed.get_world_size()
    if flash is not None:
        flags.set("flash_attention", flash)
    try:
        mesh = make_mesh(place=CPU, sp=n)
        q, k, v, g = (torch.as_tensor(x) for x in (q, k, v, g))
        sl = None if lens is None else torch.as_tensor(lens)
        h = 1 if q.shape[-1] == 64 else 2
        out = ra.ring_attention(q, k, v, mesh, num_heads=h, causal=causal,
                                seq_len=sl)
        grads = ra.ring_attention_grad(q, k, v, g, mesh, num_heads=h,
                                       causal=causal, seq_len=sl)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            y = ra.ring_attention(*leaves, mesh, num_heads=h, causal=causal,
                                  seq_len=sl)
            (y.full_tensor() * g).sum().backward()
        body = ra._ring_kernel_mode(q, k, h, q.shape[1] // n)
        return {"out": out.full_tensor().numpy(),
                "grads": [x.full_tensor().numpy() for x in grads],
                "autograd": [x.grad.numpy() for x in leaves],
                "flash_body": body is not None}
    finally:
        flags.reset("flash_attention")


def card_attention(mesh_axes, seq, causal, lens):
    """fused_attention's DTensor branches on the card, against the same
    tier on one device over the whole tensors: on a tp mesh each rank runs
    the gate's kernel (#1/#2 at this shape) on its local heads; on an sp
    mesh the ring runs #3 per rotation and #4/#5 in its backward.  Returns
    the max abs errors of max(1, |ref|) and this rank's launches."""
    from paddle_tpu_torch.ops import attention_ops as A
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import mha_block
    from paddle_tpu_torch.parallel import spmd

    place = pt.CUDAPlace(0)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(place=place, **mesh_axes)
    g = torch.Generator().manual_seed(11)
    b, h, d = 2, 8, 64
    q, k, v, dout = (torch.randn((b, seq, h * d), generator=g).to(dev)
                     for _ in range(4))
    sl = None if lens is None else torch.tensor(lens, device=dev)
    kw = dict(num_heads=h, causal=causal, scale=0.0)
    want = A._apply_attention(q, k, v, None, seq_len=sl, **kw)
    want_g = A._attention_grad(q, k, v, None, sl, dout, h, causal, 0.0,
                               False)[:3]
    counts = lambda: (mha_block.launches, mha_block.bwd_launches,
                      fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    before = counts()
    heads = "tp" in mesh_axes
    pl = [spmd._dt().Shard(2) if heads else spmd._dt().Replicate()]
    dq, dk, dv, dd = (spmd.distribute(x, mesh, pl) for x in (q, k, v, dout))
    dsl = None if sl is None else spmd.distribute(
        sl, mesh, [spmd._dt().Replicate()])
    with mesh:
        out = A._apply_attention(dq, dk, dv, None, seq_len=dsl, **kw)
        grads = A._attention_grad_mesh(dq, dk, dv, None, dsl, dd, h, causal,
                                       0.0, False)[:3]
    after = counts()
    errs = [float((x.full_tensor() - w).abs().max()) / max(
        1.0, float(w.abs().max()))
        for x, w in zip([out] + list(grads), [want] + list(want_g))]
    return {"errors": errs,
            "launches": [a - b_ for a, b_ in zip(after, before)]}


def train_staged(*args, **kwargs):
    """`train` with DTensor's functional collectives run by
    comm.stage_cuda_collectives' staged kernels (registered for the CPU
    here, as the card's under gloo): the same losses, the calls counted."""
    from paddle_tpu_torch.parallel import comm

    comm.stage_cuda_collectives("cpu")
    comm.reset_stats()
    out = train(*args, **kwargs)
    out["stats"] = dict(comm.STATS)
    return out
