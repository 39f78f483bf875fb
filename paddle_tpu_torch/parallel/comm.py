"""Collectives of the port's mesh runtime: the backend rule, the ring's
neighbour exchange, and the host staging that gloo needs for tensors on
the card.  A port-only module (the JAX package leaves every collective to
XLA).

One process runs each rank.  The backend rule lives here
(`backend_for`): NCCL when every rank has a card of its own (world size
at most `torch.cuda.device_count()`), gloo otherwise — on the CPU, and
when several ranks share one card (NCCL refuses two ranks on one
device).

Under gloo, collectives of tensors on the card are staged through pinned
host buffers here: the tensors are copied to the host, the collective
runs there over gloo, and the result is copied back.  That covers this
module's own collectives (the ring's `ring_shift`, the feeds' row
exchange) and, through `stage_cuda_collectives`, the functional
collectives DTensor issues for a redistribution (`_c10d_functional`'s
all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
all_to_all_single, broadcast: their CUDA kernels are replaced by staged
ones, because the stock ones crash the process with gloo on the card in
torch 2.11 while gloo's plain collectives work).  The bytes staged each
way are counted in `STATS["host_staged_bytes"]`.  Compute never leaves
the card, and a collective that fails raises: nothing carries on on the
CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["STATS", "backend_for", "backend_of", "reset_stats", "ring_shift",
           "all_gather_ints", "all_gather_rows", "stage_cuda_collectives"]

# host_staged_bytes: bytes copied card -> host and host -> card around a
# gloo collective; staged_collectives: DTensor's functional collectives
# run staged; ring_shifts: neighbour exchanges (one per ring rotation);
# collective_calls: calls of this module's own collectives
STATS = {"host_staged_bytes": 0, "staged_collectives": 0, "ring_shifts": 0,
         "collective_calls": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def backend_for(world_size, device_type):
    """"nccl" when every rank has a card of its own, else "gloo"."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _backend(group):
    return str(dist.get_backend(group)).lower()


def backend_of(group=None):
    """The backend name of `group` (default: the world's)."""
    return _backend(group)


def _staged(tensors, group):
    """True when `tensors` lie on the card and the group runs gloo."""
    return (any(t.device.type == "cuda" for t in tensors)
            and _backend(group) == "gloo")


def _host_empty(shape, dtype, like):
    """A host buffer, pinned when `like` lies on the card."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=like.device.type == "cuda")


def _to_host(t):
    """A host copy of `t` (pinned), complete when this returns."""
    buf = _host_empty(t.shape, t.dtype, t)
    buf.copy_(t)
    STATS["host_staged_bytes"] += t.numel() * t.element_size()
    return buf


def _to_card(buf, device):
    out = buf.to(device, non_blocking=True)
    STATS["host_staged_bytes"] += buf.numel() * buf.element_size()
    return out


def ring_shift(tensors, group):
    """Send each tensor to the next rank of `group` (its index + 1, mod the
    group size) and return the tensors received from the previous one, of
    the same shapes and dtypes: one rotation of a ring."""
    STATS["ring_shifts"] += 1
    STATS["collective_calls"] += 1
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    tensors = [t.contiguous() for t in tensors]
    staged = _staged(tensors, group)
    if staged:
        send = [_to_host(t) for t in tensors]
        recv = [_host_empty(t.shape, t.dtype, t) for t in tensors]
    else:
        send = tensors
        recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for s, r in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        return [_to_card(r, t.device) for r, t in zip(recv, tensors)]
    return recv


def all_gather_ints(values, group=None, device=None):
    """Every rank's list of ints (all lists of one length), as a list of
    lists in rank order."""
    STATS["collective_calls"] += 1
    n = dist.get_world_size(group)
    dev = device if device is not None and _backend(group) == "nccl" \
        else torch.device("cpu")
    mine = torch.tensor(list(values), dtype=torch.int64, device=dev)
    out = torch.empty((n * mine.numel(),), dtype=torch.int64, device=dev)
    _all_gather_single(out, mine, group)
    return out.reshape(n, -1).cpu().tolist()


def all_gather_rows(t, sizes, group=None):
    """Concatenate every rank's `t` along dim 0, in rank order, where rank
    r holds sizes[r] rows (the other dims alike): each pads to the longest
    and the padding is dropped after the gather."""
    STATS["collective_calls"] += 1
    n = dist.get_world_size(group)
    longest = max(sizes)
    pad = torch.zeros((longest,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    pad[:t.shape[0]] = t
    staged = _staged([pad], group)
    if staged:
        pad = _to_host(pad)
    out = torch.empty((n * longest,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=pad.device)
    _all_gather_single(out, pad, group)
    if staged:
        out = _to_card(out, t.device)
    return torch.cat([out[r * longest: r * longest + sizes[r]]
                      for r in range(n)])


def _all_gather_single(out, t, group):
    # all_gather_single is the newer name of all_gather_into_tensor
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, t, group=group)


def _reduce_scatter_single(out, t, op, group):
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, t, op=op, group=group)


# ---------------------------------------------------------------------------
# DTensor's functional collectives, staged (gloo on the card)
# ---------------------------------------------------------------------------

_STAGED_LIB = []


def _reduce_op(name):
    """(the gloo ReduceOp, divide by the group size after): gloo has no
    AVG, so an average is a sum divided."""
    name = name.lower()
    if name == "avg":
        return dist.ReduceOp.SUM, True
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}[name], False


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


def _staged_all_reduce(t, reduce_op, group_name):
    STATS["staged_collectives"] += 1
    pg = _group(group_name)
    op, avg = _reduce_op(reduce_op)
    buf = _to_host(t.contiguous())
    dist.all_reduce(buf, op=op, group=pg)
    if avg:
        buf /= dist.get_world_size(pg)
    return _to_card(buf, t.device)


def _staged_all_reduce_(t, reduce_op, group_name):
    return t.copy_(_staged_all_reduce(t, reduce_op, group_name))


def _staged_all_gather(t, group_size, group_name):
    STATS["staged_collectives"] += 1
    pg = _group(group_name)
    buf = _to_host(t.contiguous())
    out = _host_empty((t.shape[0] * group_size,) + tuple(t.shape[1:]),
                      t.dtype, t)
    _all_gather_single(out, buf, pg)
    return _to_card(out, t.device)


def _staged_reduce_scatter(t, reduce_op, group_size, group_name):
    STATS["staged_collectives"] += 1
    pg = _group(group_name)
    op, avg = _reduce_op(reduce_op)
    buf = _to_host(t.contiguous())
    out = _host_empty((t.shape[0] // group_size,) + tuple(t.shape[1:]),
                      t.dtype, t)
    _reduce_scatter_single(out, buf, op, pg)
    if avg:
        out /= group_size
    return _to_card(out, t.device)


def _staged_all_to_all(t, output_split_sizes, input_split_sizes,
                       group_name):
    STATS["staged_collectives"] += 1
    pg = _group(group_name)
    buf = _to_host(t.contiguous())
    rows = (sum(output_split_sizes) if output_split_sizes
            else t.shape[0])
    out = _host_empty((rows,) + tuple(t.shape[1:]), t.dtype, t)
    dist.all_to_all_single(out, buf, list(output_split_sizes) or None,
                           list(input_split_sizes) or None, group=pg)
    return _to_card(out, t.device)


def _staged_broadcast(t, src, group_name):
    STATS["staged_collectives"] += 1
    pg = _group(group_name)
    buf = _to_host(t.contiguous())
    dist.broadcast(buf, dist.get_global_rank(pg, src), group=pg)
    return _to_card(buf, t.device)


def stage_cuda_collectives(device_type="cuda"):
    """Replace the kernels of `_c10d_functional`'s collectives (the ones
    DTensor's redistributions call) for `device_type` by the staged ones
    above.  Made once a process, when a mesh on the card runs over gloo
    (the tests stage the CPU's to run the same code); every call is
    counted in STATS."""
    if _STAGED_LIB:
        return
    import warnings

    lib = torch.library.Library("_c10d_functional", "IMPL")
    ops = torch.ops._c10d_functional
    with warnings.catch_warnings():
        # "overriding a previously registered kernel": that is the point
        warnings.simplefilter("ignore")
        for name, fn in (("all_reduce", _staged_all_reduce),
                         ("all_reduce_", _staged_all_reduce_),
                         ("all_gather_into_tensor", _staged_all_gather),
                         ("reduce_scatter_tensor", _staged_reduce_scatter),
                         ("all_to_all_single", _staged_all_to_all),
                         ("broadcast", _staged_broadcast)):
            if hasattr(ops, name):
                lib.impl(name, fn, device_type.upper())
    _STAGED_LIB.append(lib)
