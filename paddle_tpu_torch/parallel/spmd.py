"""The Executor's mesh mode: a Program's ops on DTensors, one process per
rank (the port's counterpart of compiling a block under GSPMD,
paddle_tpu/framework/executor.py's `mesh=`).

The scope holds every persistable and every feed as a DTensor over the
mesh (`torch.distributed.tensor`), in the placements `sharding_for_var`
resolves from its dist_attr.  Each op's lowering runs on those DTensors
under `implicit_replication` (a plain tensor an op makes, a constant or
an arange, counts as replicated), so DTensor's sharding rules propagate
the layouts and issue the collectives GSPMD would: a replicated
parameter's gradient over a batch-sharded input comes out a partial sum,
which is all-reduced (or reduce-scattered) where the optimizer reads it.
A persistable an op writes is put back into its declared placements
before it is stored (`pin`), as the JAX executor pins persistables at a
segment boundary.  On the card under gloo those collectives are staged
through host buffers (`comm.stage_cuda_collectives`).

The cases DTensor cannot run as they are, each taken explicitly:

  - `fused_attention` / `fused_attention_grad`: the attention kernels
    launch through ctypes on `data_ptr()`.  ops/attention_ops.py routes a
    DTensor call either to the sequence-parallel ring (a live `sp` axis:
    parallel/ring_attention.py, on the local sequence blocks) or to
    `local_attention` / `local_attention_grad` here: q, k and v are
    redistributed to one layout (batch over the data axes, heads over
    `tp` where q's heads are sharded, everything else replicated), the
    op runs on the local blocks with the LOCAL head count, and the
    results are wrapped back in that layout.
  - `lookup_table_grad`: its scatter-add writes into a plain zeros
    tensor.  Run on the local rows (Ids and Out@GRAD batch-sharded over
    the data axes, the rest replicated): the local W@GRAD is a partial
    sum over the data axes.
  - `softmax_with_cross_entropy` (and its grad): the class dim (a
    vocab-sharded `logits_proj`, `tp_rules()`) is replicated before the
    op (an all-gather), so the loss is the global one; the batch stays
    sharded.
  - the optimizer update ops (`sgd`, `momentum`, `adam`, ...): every
    param-shaped input is taken to the layout of the update's state
    (the first param-shaped accumulator, else the param), so ZeRO's
    sharded moments update in place on their shards; the updated param
    is all-gathered back into its own layout by `pin`.

Any other op DTensor has no rule for raises with the op's name: there is
no fallback.

Feeds follow the JAX package's multi-controller contract
(parallel_executor.py:84-90): each rank feeds the rows its data-axis
coordinate owns (`local_batch` cuts them from a global batch), and ranks
that differ only on tp or sp feed the same rows.  A batch whose rows do
not split evenly over the data axes (an epoch's ragged last batch) is
gathered whole onto every rank and runs replicated, as the JAX
package's `stage_feed` degrades it.  Fetches come back whole, as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .sharding import _live_data_axes, sharding_for_var

_OPTIMIZER_OPS = ("sgd", "momentum", "adam", "adamax", "adagrad",
                  "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
                  "lars_momentum")


def _dt():
    from torch.distributed import tensor as dt
    from torch.distributed.tensor import experimental  # noqa: F401

    return dt


def is_dtensor(x):
    return isinstance(x, _dt().DTensor)


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= int(s)
    return tuple(reversed(stride))


def wrap(local, mesh, placements, shape):
    """A DTensor of global `shape` from this rank's block `local` (made
    contiguous: the DTensor's strides are the contiguous ones of `shape`,
    and its view rules take the block to match)."""
    shape = tuple(int(s) for s in shape)
    return _dt().DTensor.from_local(local.contiguous(), mesh.torch_mesh,
                                    placements,
                                    run_check=False, shape=torch.Size(shape),
                                    stride=_contiguous_stride(shape))


def replicated(mesh):
    return [_dt().Replicate() for _ in mesh.axis_names]


def layout_of(x, mesh):
    """x's placements with a partial sum taken as replicated (the layout a
    result handed back in x's place is given)."""
    if not is_dtensor(x):
        return replicated(mesh)
    return [_dt().Replicate() if p.is_partial() else p
            for p in x.placements]


def to_layout(x, mesh, placements):
    """x (a DTensor, or a plain tensor taken as replicated) in
    `placements`."""
    if not is_dtensor(x):
        x = wrap(x, mesh, replicated(mesh), x.shape)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh.torch_mesh, placements)
    return x


def local_slice(full, mesh, placements):
    """This rank's block of the full tensor `full` under `placements`
    (DTensor's own split: mesh dims in order, each Shard an even chunk)."""
    t = full
    for m, p in enumerate(placements):
        if p.is_shard():
            n = mesh.axis_sizes[m]
            if t.shape[p.dim] % n:
                raise ValueError(
                    f"dim {p.dim} of size {t.shape[p.dim]} does not split "
                    f"over the {n} ranks of mesh axis "
                    f"{mesh.axis_names[m]!r}")
            t = torch.chunk(t, n, dim=p.dim)[mesh.coordinate(
                mesh.axis_names[m])]
    return t.contiguous()


def distribute(full, mesh, placements):
    """The full tensor `full`, the same on every rank ("local is global":
    a seeded startup or `convert.load_params`), as a DTensor: each rank
    keeps its own block, and nothing is sent."""
    return wrap(local_slice(full, mesh, placements), mesh, placements,
                full.shape)


def pin(value, mesh, placements):
    """A value about to be stored, in its declared placements."""
    if placements is None or not isinstance(value, torch.Tensor):
        return value
    return to_layout(value, mesh, placements)


def full_value(v):
    """The whole value of a DTensor (a collective: every rank fetches the
    same names in the same order), or `v` itself."""
    return v.full_tensor() if is_dtensor(v) else v


# ---------------------------------------------------------------------------
# feeds
# ---------------------------------------------------------------------------


def _data_dims(mesh):
    return [mesh.dim(a) for a in _live_data_axes(mesh)]


def data_index(mesh):
    """(this rank's index over the live data axes, their extent)."""
    idx, n = 0, 1
    for m in _data_dims(mesh):
        idx = idx * mesh.axis_sizes[m] + mesh.coordinate(mesh.axis_names[m])
        n *= mesh.axis_sizes[m]
    return idx, n


def local_batch(mesh, value):
    """The rows of a global batch that this rank feeds: the global batch
    split over the live data axes as `np.array_split` splits it (the
    first ranks take one more row when it does not divide)."""
    idx, n = data_index(mesh)
    return np.array_split(np.asarray(value), n)[idx]


def stage_feeds(mesh, program, feeds):
    """{name: this rank's rows} -> {name: DTensor}: batch-sharded over the
    live data axes when every rank's rows of the feed are as many, then
    in the placements the var resolves to; else (a ragged batch) gathered
    whole and replicated.  One exchange of the row counts a run; a 0-d
    feed is the same on every rank."""
    from . import comm

    dims = _data_dims(mesh)
    batched = [n for n, t in feeds.items() if t.dim() > 0]
    counts = (comm.all_gather_ints([feeds[n].shape[0] for n in batched],
                                   device=mesh.device)
              if dims and batched else None)
    # ranks in row-major mesh order; the data ranks are those at
    # coordinate 0 of every other axis, taken in data-index order
    coords = np.unravel_index(np.arange(mesh.size), mesh.axis_sizes)
    others = [m for m in range(len(mesh.axis_sizes)) if m not in dims]
    data_ranks = sorted(
        (r for r in range(mesh.size)
         if all(coords[m][r] == 0 for m in others)),
        key=lambda r: tuple(coords[m][r] for m in dims))
    out = {}
    for name, t in feeds.items():
        var = program.global_block().vars.get(name)
        pl = (sharding_for_var(var, mesh, is_feed=True)
              if var is not None else None)
        if counts is None or t.dim() == 0:
            x = wrap(t, mesh, replicated(mesh), t.shape)
        else:
            j = batched.index(name)
            rows = [counts[r][j] for r in data_ranks]
            if len(set(rows)) == 1:
                x = wrap(t, mesh, _rows_layout(mesh),
                         (rows[0] * len(rows),) + tuple(t.shape[1:]))
            else:
                # the ragged batch: every rank's rows in world order, then
                # the data ranks' rows in data order, replicated
                sizes = [counts[r][j] for r in range(mesh.size)]
                everything = comm.all_gather_rows(t, sizes)
                starts = np.cumsum([0] + sizes)
                whole = torch.cat([everything[starts[r]:starts[r] + sizes[r]]
                                   for r in data_ranks])
                x = wrap(whole, mesh, replicated(mesh), whole.shape)
                pl = None
        out[name] = x if pl is None else to_layout(x, mesh, pl)
    return out


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def _rows_layout(mesh):
    """Batch over the data axes (dim 0), everything else replicated."""
    dt = _dt()
    dims = _data_dims(mesh)
    return [dt.Shard(0) if m in dims else dt.Replicate()
            for m in range(len(mesh.axis_names))]


def _rows_or_whole(mesh, v):
    """_rows_layout when the value is batch-sharded over the data axes
    now, else replicated (a ragged batch was fed whole)."""
    want = _rows_layout(mesh)
    if is_dtensor(v) and all(
            (p.is_shard(0) if w.is_shard() else True)
            for p, w in zip(v.placements, want)):
        return want
    return replicated(mesh)


def _lookup_table_grad(op, read, rng, device, mesh):
    from ..framework.executor import _run_op

    dt = _dt()
    wname = op.input("W")[0]
    w = read(wname)
    rows = _rows_or_whole(mesh, read(op.input("Ids")[0]))
    partial = [dt.Partial() if p.is_shard() else dt.Replicate()
               for p in rows]
    # W is read for its shape, dtype and device only: a zero-stride view
    # of the right global shape stands for it
    stand_in = torch.zeros((), dtype=w.dtype, device=device).expand(
        tuple(w.shape))
    batch = set(op.input("Ids")) | set(op.input("Out@GRAD"))

    def local_read(n):
        if n == wname:
            return stand_in
        v = read(n)
        return to_layout(v, mesh, rows).to_local() if n in batch else v

    outs = _run_op(op, local_read, rng, device)
    return {p: [None if t is None else wrap(t, mesh, partial, w.shape)
                for t in vals] for p, vals in outs.items()}


def _class_replicated(op, read, rng, device, mesh):
    """softmax_with_cross_entropy(_grad): rows stay sharded, the class dim
    is gathered."""
    from ..framework.executor import _run_op

    dt = _dt()

    def rows_read(n):
        v = read(n)
        if not is_dtensor(v):
            return v
        pl = [p if p.is_shard(0) else dt.Replicate() for p in v.placements]
        return to_layout(v, mesh, pl)

    with dt.experimental.implicit_replication():
        return _run_op(op, rows_read, rng, device)


def _optimizer_update(op, read, rng, device, mesh):
    from ..framework.executor import _run_op

    dt = _dt()
    param = read(op.input("Param")[0])
    shape = tuple(param.shape)
    target = None
    for p, names in op.inputs.items():
        if p in ("Param", "Grad") or not names:
            continue
        v = read(names[0])
        if is_dtensor(v) and tuple(v.shape) == shape:
            target = list(v.placements)
            break
    if target is None:
        target = (list(param.placements) if is_dtensor(param)
                  else replicated(mesh))

    def state_read(n):
        v = read(n)
        if isinstance(v, torch.Tensor) and tuple(v.shape) == shape:
            return to_layout(v, mesh, target)
        return v

    with dt.experimental.implicit_replication():
        return _run_op(op, state_read, rng, device)


RULES = {"lookup_table_grad": _lookup_table_grad,
         "softmax_with_cross_entropy": _class_replicated,
         "softmax_with_cross_entropy_grad": _class_replicated}
RULES.update({t: _optimizer_update for t in _OPTIMIZER_OPS})


def make_run_op(mesh):
    """The mesh mode's `_run_op(op, read, rng, device)`."""
    from ..framework.executor import _run_op

    dt = _dt()

    def run_op(op, read, rng, device):
        rule = RULES.get(op.type)
        try:
            if rule is not None:
                return rule(op, read, rng, device, mesh)
            with dt.experimental.implicit_replication():
                return _run_op(op, read, rng, device)
        except Exception as e:
            raise RuntimeError(
                f"op {op.type!r} failed on {mesh!r} (DTensor inputs): "
                f"{type(e).__name__}: {e}") from e

    return run_op


# ---------------------------------------------------------------------------
# attention on local heads (ops/attention_ops.py's DTensor branch)
# ---------------------------------------------------------------------------


def attention_layout(mesh, q, num_heads, seq_axis=None):
    """(placements for q/k/v, placements for the [B] lengths, the divisor
    of the head count) of an attention op's inputs on `mesh`: batch over
    the mesh dims where q is batch-sharded (when the batch splits), heads
    over the dims where q's heads are sharded (when they split), the
    sequence over `seq_axis` (the ring's), everything else replicated."""
    dt = _dt()
    qp = (list(q.placements) if is_dtensor(q) else replicated(mesh))
    qkv, lens = [], []
    bdiv = hdiv = 1
    for m, name in enumerate(mesh.axis_names):
        n = mesh.axis_sizes[m]
        p = qp[m]
        if name == seq_axis:
            qkv.append(dt.Shard(1))
            lens.append(dt.Replicate())
        elif p.is_shard(0) and q.shape[0] % (bdiv * n) == 0:
            bdiv *= n
            qkv.append(dt.Shard(0))
            lens.append(dt.Shard(0))
        elif p.is_shard(2) and num_heads % (hdiv * n) == 0:
            hdiv *= n
            qkv.append(dt.Shard(2))
            lens.append(dt.Replicate())
        else:
            qkv.append(dt.Replicate())
            lens.append(dt.Replicate())
    return qkv, lens, hdiv


def _bias_layout(mesh, bias, qkv, grad=False):
    """Placements of an additive [B|1, H|1, Sq, Sk] bias that match q's
    layout: a dim of size 1 broadcasts (replicated; its grad a partial
    sum over the dims that split it)."""
    dt = _dt()
    out = []
    for p in qkv:
        if p.is_shard(0) or p.is_shard(2):
            d = 0 if p.is_shard(0) else 1
            if bias.shape[d] == 1:
                out.append(dt.Partial() if grad else dt.Replicate())
            else:
                out.append(dt.Shard(d))
        else:
            out.append(dt.Replicate())
    return out


def local_attention(fn, q, k, v, bias, seq_len, num_heads, mesh):
    """fn(q, k, v, bias, seq_len, num_heads) on this rank's blocks, with
    the local head count; the output in q's layout."""
    qkv, lens, hdiv = attention_layout(mesh, q, num_heads)
    ql, kl, vl = (to_layout(x, mesh, qkv).to_local() for x in (q, k, v))
    bl = (None if bias is None else
          to_layout(bias, mesh, _bias_layout(mesh, bias, qkv)).to_local())
    sl = None if seq_len is None else to_layout(seq_len, mesh,
                                                lens).to_local()
    out = fn(ql, kl, vl, bl, sl, num_heads // hdiv)
    return wrap(out, mesh, qkv, q.shape)


def local_attention_grad(fn, q, k, v, bias, seq_len, dout, num_heads, mesh):
    """fn(q, k, v, bias, seq_len, dout, num_heads) -> (dq, dk, dv, dbias)
    on this rank's blocks; the grads in the layouts of their inputs (a
    broadcast bias dim's grad a partial sum)."""
    qkv, lens, hdiv = attention_layout(mesh, q, num_heads)
    ql, kl, vl, dl = (to_layout(x, mesh, qkv).to_local()
                      for x in (q, k, v, dout))
    bl = (None if bias is None else
          to_layout(bias, mesh, _bias_layout(mesh, bias, qkv)).to_local())
    sl = None if seq_len is None else to_layout(seq_len, mesh,
                                                lens).to_local()
    dq, dk, dv, db = fn(ql, kl, vl, bl, sl, dl, num_heads // hdiv)
    grads = [wrap(g, mesh, qkv, x.shape)
             for g, x in ((dq, q), (dk, k), (dv, v))]
    if db is not None:
        grads.append(wrap(db, mesh, _bias_layout(mesh, bias, qkv, grad=True),
                          bias.shape))
    else:
        grads.append(None)
    return grads
