"""ZeRO-1/2: optimizer-state (and gradient) partitioning over the dp axis
(counterpart of paddle_tpu/parallel/zero.py; the passes are its own, line
for line, so both packages stamp the same annotations).

A flat data-parallel run replicates params *and* their Adam moments on
every dp replica.  ZeRO (Rajbhandari et al.) observes the moments are
only read/written by the elementwise optimizer update, so each replica
needs just its 1/dp slice.  It is an *annotation* pass, not a graph
rewrite:

  stage 1  every param-shaped optimizer accumulator gets `dp` stamped
           onto a divisible dim (composed with any existing TP sharding,
           e.g. (None, 'tp') moments become ('dp', 'tp')).  Params stay
           replicated.  The Executor's mesh mode (parallel/spmd.py) runs
           the optimizer update on the moments' shards (its param and
           grad taken to the same layout) and all-gathers the updated
           param into its replicated layout; between steps each rank
           holds only its moment shard.
  stage 2  additionally stamps the same layout onto each param's @GRAD
           var, so the grad's partial sum is reduce-scattered into that
           layout where it is made, instead of all-reduced.

Unlike apply_zero_sharding (FSDP: shards the *params themselves*, which
changes every layer's compute layout), apply_zero leaves forward/backward
untouched — it is purely an optimizer-memory pass, which is why it
composes freely under TP rules.

Numerics: the partitioned update + all-gather computes the same math as
the replicated update, but the gradient reduction may be reassociated
(reduce-scatter vs all-reduce order), so step losses match the unsharded
run to fp tolerance, not bitwise.
"""

from __future__ import annotations

import math

from ..framework.framework import Parameter, Program
from .sharding import _axis_live, resolve_mesh_axis

__all__ = ["apply_zero", "zero_topology", "GRAD_SUFFIX"]

GRAD_SUFFIX = "@GRAD"


def _compose_zero_attr(base_attr, shape, axis, mesh):
    """Stamp `axis` onto the first dim of `shape` that divides evenly under
    it (composed with any axes the dim already carries, e.g. a 'tp' row
    sharding becomes ('dp', 'tp')).  Returns the new dist_attr tuple, or
    None when the var already uses the axis or no dim fits."""
    attr = list(base_attr) if base_attr else [None] * len(shape)
    while len(attr) < len(shape):
        attr.append(None)
    for a in attr:
        existing = a if isinstance(a, (tuple, list)) else ((a,) if a else ())
        if axis in existing:
            return None  # already partitioned over this axis
    for d in range(len(shape)):
        a = attr[d]
        if a is None:
            entry = axis
        else:
            entry = (axis,) + (tuple(a) if isinstance(a, (tuple, list))
                               else (a,))
        if mesh is not None and int(shape[d]) % _axes_product(mesh, entry):
            continue  # uneven split — try the next dim
        return tuple(attr[:d] + [entry] + attr[d + 1:])
    return None


def _axes_product(mesh, entry):
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    out = 1
    for a in axes:
        if a is not None:
            out *= mesh.axis_size(a, 1)
    return out


def apply_zero(program: Program, mesh=None, stage=1, min_size=0, axis=None):
    """Annotate `program` for ZeRO stage 1 or 2 over the mesh's `dp` axis.

    Run AFTER apply_tensor_parallel/apply_data_parallel: the TP pass
    propagates param annotations onto the accumulators and would clobber
    the ZeRO stamp (here the composition goes the other way — the ZeRO
    dim is added on top of whatever the accumulator inherited).

    Targets every persistable accumulator shaped like its param
    (Optimizer._add_accumulator's `<param>_<acc>` naming); scalar state
    (beta pows, lr) and params whose candidate dim does not divide the
    dp extent stay replicated — partial sharding beats an uneven-split
    compile error.  Raises via resolve_mesh_axis when the mesh has no
    live dp axis instead of silently no-op'ing.

    Stamps `program._zero_meta` (stage/axis/extent + the sharded var
    names) — CheckpointManager.save persists it as
    `train_state.zero_topology`."""
    stage = int(stage)
    if stage not in (1, 2):
        raise ValueError(f"apply_zero: stage must be 1 or 2, got {stage}")
    axis = resolve_mesh_axis(
        mesh, ("dp",), "apply_zero (optimizer-state sharding)", axis=axis
    )
    extent = mesh.axis_size(axis, 1) if mesh is not None else 0
    sharded = []
    for block in program.blocks:
        params = [v for v in block.vars.values() if isinstance(v, Parameter)]
        for param in params:
            shape = param.shape
            if not shape or any(int(d) <= 0 for d in shape):
                continue
            if math.prod(int(d) for d in shape) < min_size:
                continue
            zattr = _compose_zero_attr(
                getattr(param, "dist_attr", None), shape, axis, mesh
            )
            if zattr is None:
                continue  # already dp-partitioned, or no dim divides
            prefix = param.name + "_"
            touched = False
            for name, var in block.vars.items():
                if (
                    name.startswith(prefix)
                    and var.shape == param.shape
                    and getattr(var, "persistable", False)
                    and not isinstance(var, Parameter)
                ):
                    var.dist_attr = zattr
                    sharded.append(name)
                    touched = True
            if stage >= 2 and touched:
                grad = block.vars.get(param.name + GRAD_SUFFIX)
                if grad is not None and grad.shape == param.shape:
                    grad.dist_attr = zattr
    program._zero_meta = {
        "stage": stage,
        "axis": axis,
        "axis_size": int(extent),
        "sharded_vars": sorted(sharded),
    }
    return program


def zero_topology(program, mesh=None):
    """The `_zero_meta` stamp apply_zero left on `program`, or — for a
    program annotated by hand — a reconstruction from the live dp-axis
    annotations.  None when the program carries no ZeRO layout."""
    meta = getattr(program, "_zero_meta", None)
    if meta is not None:
        return dict(meta)
    if mesh is None or not _axis_live(mesh, "dp"):
        return None
    sharded = []
    for block in program.blocks:
        for name, var in block.vars.items():
            if isinstance(var, Parameter) or not getattr(
                var, "persistable", False
            ):
                continue
            attr = getattr(var, "dist_attr", None)
            if not attr:
                continue
            for a in attr:
                axes = a if isinstance(a, (tuple, list)) else (a,)
                if "dp" in axes:
                    sharded.append(name)
                    break
    if not sharded:
        return None
    return {
        "stage": 1,
        "axis": "dp",
        "axis_size": int(mesh.axis_size("dp", 1)),
        "sharded_vars": sorted(sharded),
    }
