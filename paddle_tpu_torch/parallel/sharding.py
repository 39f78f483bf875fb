"""Sharding annotation passes over Programs (counterpart of
paddle_tpu/parallel/sharding.py).

The passes are the JAX package's, line for line: they stamp `dist_attr`
(mesh-axis names per dim) onto a program's variables, so that a program
annotated in either package carries the same annotations.  Where the JAX
package resolves an annotation to a NamedSharding and lets GSPMD derive
the collectives, the port resolves it to DTensor placements, one per mesh
dimension (`sharding_for_var`), and the Executor's mesh mode
(parallel/spmd.py) runs the ops on DTensors in those layouts.

`apply_expert_parallel` is not ported yet (ROADMAP.md A item 7).
"""

from __future__ import annotations

from ..framework.framework import Parameter, Program

# a var-level replicated annotation (distinct from None = "unannotated")
REPLICATED = ()


def shard(var, *axes):
    """Annotate one variable: shard(w, 'tp', None) — dim0 over tp axis.
    Trailing unannotated dims are replicated."""
    var.dist_attr = tuple(axes)
    return var


def placements_for_attr(mesh, attr):
    """DTensor placements (one per mesh dim) of a dist_attr on `mesh`: a
    tensor dim annotated with a live axis (or a tuple of them) is
    Shard(dim) on each of their mesh dims; dead axes and unannotated dims
    are replicated — the port's PartitionSpec."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for d, a in enumerate(attr or ()):
        if not _axis_live(mesh, a):
            continue
        for name in (a if isinstance(a, (tuple, list)) else (a,)):
            out[mesh.dim(name)] = Shard(d)
    return out


def sharding_for_var(var, mesh, *, is_feed=False):
    """Resolve a variable's placements under `mesh`.

    Priority: explicit dist_attr > data vars batch-sharded over dp >
    persistables replicated.  Returns None for plain intermediates (they
    take the layout the ops give them)."""
    attr = getattr(var, "dist_attr", None)
    if attr is not None:
        return placements_for_attr(mesh, attr)
    if getattr(var, "is_data", False) or is_feed:
        return _batch_sharding(mesh, var)
    if getattr(var, "persistable", False):
        return placements_for_attr(mesh, ())
    return None


def _axis_live(mesh, axis):
    if axis is None:
        return False
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return all(mesh.has_axis(a) and mesh.axis_size(a) > 1 for a in axes)


def _batch_sharding(mesh, var):
    data_axes = _live_data_axes(mesh)
    if not data_axes:
        return placements_for_attr(mesh, ())
    spec = data_axes[0] if len(data_axes) == 1 else data_axes
    return placements_for_attr(mesh, (spec,))


def resolve_mesh_axis(mesh, candidates, purpose, axis=None, default=None):
    """Shared mesh-axis resolution for the annotation passes (apply_zero,
    apply_expert_parallel, apply_zero_sharding — previously each carried
    its own copy of this auto-pick + dead-axis-raise logic).

    Picks `axis` when given, else the first candidate live on `mesh`,
    else `default` (when set) — and, with a mesh in hand, raises on a
    dead resolved axis instead of letting the caller annotate for it:
    annotating a dead axis silently replicates the state, defeating the
    memory point of every pass that calls this.  With no mesh the pick
    is `axis`/`default`/first candidate, unvalidated (annotate-now,
    mesh-later callers)."""
    if axis is None:
        if mesh is None:
            axis = default if default is not None else candidates[0]
        else:
            axis = next((a for a in candidates if _axis_live(mesh, a)), None)
            if axis is None:
                if default is None:
                    raise ValueError(
                        f"{purpose} needs a live mesh axis among "
                        f"{tuple(candidates)}; {mesh!r} has none of size > 1 "
                        "(the state would silently replicate)")
                axis = default
    if mesh is not None and not _axis_live(mesh, axis):
        raise ValueError(
            f"{purpose} needs a live `{axis}` axis; {mesh!r} has none "
            "(the state would silently replicate)")
    return axis


# ---------------------------------------------------------------------------
# Whole-program annotation passes (the BuildStrategy.Apply() equivalents)
# ---------------------------------------------------------------------------


def _live_data_axes(mesh):
    """Mesh axes the global batch is sharded over (dp and/or fsdp, size>1)."""
    if mesh is None:
        return ("dp",)
    return tuple(a for a in ("dp", "fsdp") if mesh.axis_size(a, 1) > 1)


def data_axes_for(mesh, batch_dim):
    """Live data axes usable to shard a batch dim of static size
    `batch_dim`, or () when the size does not divide evenly (callers fall
    back to replication)."""
    import math

    axes = _live_data_axes(mesh)
    if axes and batch_dim % math.prod(mesh.axis_size(a) for a in axes):
        return ()
    return axes


def apply_data_parallel(program: Program, mesh=None):
    """Pure DP: data vars batch-sharded over the mesh's live data axes on
    dim0, params replicated.  This *is* the reference ParallelExecutor
    semantics (param broadcast + per-grad allreduce): a replicated param's
    gradient over a batch-sharded input is a partial sum, which the mesh
    mode all-reduces where the optimizer reads it."""
    axes = _live_data_axes(mesh)
    batch_axis = axes if len(axes) > 1 else (axes[0] if axes else None)
    for block in program.blocks:
        for var in block.vars.values():
            if var.is_data and var.dist_attr is None:
                if batch_axis is not None:
                    var.dist_attr = (batch_axis,) + (None,) * max(
                        0, (len(var.shape or ()) - 1)
                    )
            elif var.persistable and var.dist_attr is None:
                var.dist_attr = REPLICATED
    return program


def _propagate_to_optimizer_state(block, param):
    """Copy a param's annotation onto its optimizer accumulators (vars named
    `<param>_<acc>...` with the same shape — Optimizer._add_accumulator's
    naming).  Sharded params with replicated moments would be correct but
    waste the memory FSDP/TP exists to save."""
    prefix = param.name + "_"
    for name, var in block.vars.items():
        if (
            name.startswith(prefix)
            and var.shape == param.shape
            and getattr(var, "persistable", False)
        ):
            var.dist_attr = param.dist_attr


def apply_zero_sharding(program: Program, mesh=None, min_size: int = 1024):
    """ZeRO/FSDP: additionally shard every large parameter (and with it, its
    optimizer accumulators — they inherit the param's annotation in
    Optimizer._create_accumulators) over the mesh's param-sharding axis on
    dim0 — `fsdp` when that axis is live, else `dp` (classic ZeRO over the
    data axis).  Raises when the mesh has neither, rather than silently
    no-op'ing.

    The reference has no FSDP (SURVEY §2.13: 'must be designed fresh');
    its closest ancestor is pserver block-sharding of params
    (distribute_transpiler.py:79 slice_variable)."""
    import math

    axis = resolve_mesh_axis(
        mesh, ("fsdp", "dp"), "ZeRO/Reduce param sharding (live data axis)"
    )

    for block in program.blocks:
        for var in block.vars.values():
            if not isinstance(var, Parameter) or var.shape is None:
                continue
            if math.prod(var.shape) < min_size or not var.shape:
                continue
            var.dist_attr = (axis,) + (None,) * (len(var.shape) - 1)
            _propagate_to_optimizer_state(block, var)
    return program


def apply_embedding_parallel(program: Program, patterns=(r".*emb.*",),
                             mesh=None):
    """EP: shard embedding tables' vocab dim over the `ep` mesh axis.

    The reference keeps big embeddings on parameter-server shards reached
    over RPC (operators/lookup_sparse_table_op.cc + distribute_transpiler's
    split_dense_variable); the device-side analog shards the table's rows
    across the ep axis, and each lookup_table gather becomes a
    partitioned gather.  Targets every Parameter consumed by a
    lookup_table/lookup_table_v2 op whose name matches one of `patterns`
    (default: anything with 'emb' in it); optimizer state follows the
    table's sharding.

    Pass `mesh` to validate eagerly: a mesh without a live ep axis would
    silently replicate the tables (the annotation resolves to no-op),
    which defeats EP's memory point — that case raises here."""
    import re

    if mesh is not None and not _axis_live(mesh, "ep"):
        raise ValueError(
            f"apply_embedding_parallel needs a live `ep` axis; {mesh!r} "
            "has none (tables would silently replicate)")
    compiled = [re.compile(p) for p in patterns]
    # tables = W inputs of lookup ops (not every 2-D param)
    table_names = set()
    for block in program.blocks:
        for op in block.ops:
            if op.type in ("lookup_table", "lookup_table_v2"):
                table_names.update(op.inputs.get("W", ()))
    for block in program.blocks:
        for var in list(block.vars.values()):
            if not isinstance(var, Parameter) or var.name not in table_names:
                continue
            if not any(p.fullmatch(var.name) for p in compiled):
                continue
            if var.shape is None or len(var.shape) != 2:
                continue
            var.dist_attr = ("ep", None)
            _propagate_to_optimizer_state(block, var)
    return program


def apply_tensor_parallel(program: Program, rules):
    """TP: apply {name_pattern: axes_tuple} rules to matching parameters —
    megatron-style column/row sharding, e.g.
    {r".*qkv.*w": (None, "tp"), r".*out_proj.*w": ("tp", None)}."""
    import re

    compiled = [(re.compile(p), axes) for p, axes in rules.items()]
    for block in program.blocks:
        for var in list(block.vars.values()):
            if not isinstance(var, Parameter):
                continue
            for pat, axes in compiled:
                if pat.fullmatch(var.name):
                    if var.shape is None or len(axes) != len(var.shape):
                        continue  # rule rank must match the param rank
                    var.dist_attr = tuple(axes)
                    _propagate_to_optimizer_state(block, var)
                    break
    return program
