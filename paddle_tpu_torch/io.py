"""Save and load vars, parameters, persistables and the inference model.

Counterpart of paddle_tpu/io.py:21-205 (reference python/paddle/fluid/
io.py).  As in the reference, saving is itself a Program of `save` /
`load` ops (ops/io_ops.py) that the Executor runs, and the files are the
JAX package's, byte for byte: a model saved by either package loads in
the other.  An inference model is a directory holding `__model__` (JSON:
the pruned test program's `to_dict`, the feed names and the fetch names)
and its persistables.

The sharded checkpoint (`snapshot_sharded`, `write_sharded`,
`save_sharded`, `load_sharded`; paddle_tpu/io.py:207-445) writes the JAX
package's layout, `shard_<process>.npz` plus `shard_<process>.index.json`,
in its single-process form: one process and one card, so every tensor is
whole and each var has one index entry starting at zeros, written by
process 0 of a world of 1.  `load_sharded` assembles a var from whatever
slices the files hold (a JAX checkpoint written by several processes
loads too).  What belongs to several devices — `gather=True`, a `mesh` to
re-stage under — raises (ROADMAP.md A item 7), and so does a bfloat16
persistable: numpy cannot hold it and the JAX form of it does not
survive the round trip (ROADMAP.md C15).
"""

from __future__ import annotations

import glob
import json
import os
import warnings

import numpy as np

from .framework.core_types import VarType
from .framework.framework import Parameter, Program, Variable

# var kinds that hold no tensor (the JAX package's VarType strings)
_NOT_SAVED = ("feed_minibatch", "fetch_list", "raw", "reader")


def _is_persistable(var):
    return var.type not in _NOT_SAVED and var.persistable


def _is_parameter(var):
    return isinstance(var, Parameter)


def _io_vars(main_program, vars, predicate):
    from .framework.framework import default_main_program

    main_program = main_program or default_main_program()
    if vars is None:
        vars = list(filter(predicate, main_program.list_vars()))
    return [v for v in vars if v.type == VarType.LOD_TENSOR]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Save `vars` (or the vars of `main_program` that `predicate` picks)
    under `dirname`: one file per var, or all in `filename`."""
    vars = _io_vars(main_program, vars, predicate)
    save_program = Program()
    block = save_program.global_block()
    os.makedirs(dirname, exist_ok=True)
    names = []
    for v in vars:
        block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                         persistable=True)
        names.append(v.name)
        if filename is None:
            block.append_op(
                type="save", inputs={"X": [v.name]},
                attrs={"file_path": os.path.join(dirname, v.name)},
                infer_shape=False)
    if filename is not None:
        block.append_op(
            type="save_combine", inputs={"X": names},
            attrs={"file_path": os.path.join(dirname, filename),
                   "var_names": names},
            infer_shape=False)
    executor.run(save_program)


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load `vars` (or the vars of `main_program` that `predicate` picks)
    from `dirname` into the executor's scope, on its place."""
    vars = _io_vars(main_program, vars, predicate)
    load_program = Program()
    block = load_program.global_block()
    names = []
    for v in vars:
        block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                         persistable=True)
        names.append(v.name)
        if filename is None:
            block.append_op(
                type="load", outputs={"Out": [v.name]},
                attrs={"file_path": os.path.join(dirname, v.name)},
                infer_shape=False)
    if filename is not None:
        block.append_op(
            type="load_combine", outputs={"Out": names},
            attrs={"file_path": os.path.join(dirname, filename),
                   "var_names": names},
            infer_shape=False)
    executor.run(load_program)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """Prune `main_program`'s test clone to `target_vars`, write it with
    the feed and fetch names to `model_filename` (default `__model__`),
    then save its persistables.  Returns the fetch names."""
    from .framework.framework import default_main_program

    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    pruned = main_program.clone(for_test=True)._prune(target_vars)
    meta = {
        "program": pruned.to_dict(),
        "feed_var_names": list(feeded_var_names),
        "fetch_var_names": [v.name if isinstance(v, Variable) else str(v)
                            for v in target_vars],
    }
    with open(os.path.join(dirname, model_filename or "__model__"),
              "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, params_filename)
    return meta["fetch_var_names"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """-> (program, feed names, fetch vars), the persistables loaded into
    the executor's scope."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in meta["fetch_var_names"]]
    return program, meta["feed_var_names"], fetch_vars


# ---------------------------------------------------------------------------
# Sharded checkpoint, single-process form (paddle_tpu/io.py:207-445)
# ---------------------------------------------------------------------------

_MULTI_DEVICE = ("belongs to multi-device training, which the port does "
                 "not have yet (ROADMAP.md A item 7)")


def _host_array(name, value):
    """A private host copy of a scope value: the scope's tensor is
    updated in place by later steps, and an async writer serializes the
    copy after the caller has moved on."""
    import torch

    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            raise TypeError(
                f"snapshot_sharded: {name!r} is bfloat16, which numpy cannot "
                "hold and whose JAX form does not survive a round trip "
                "(ROADMAP.md C15); keep persistables float32 to checkpoint "
                "them")
        return value.detach().to("cpu", copy=True).numpy()
    return np.array(value, copy=True)


def snapshot_sharded(scope=None, main_program=None, gather=False):
    """Host-side snapshot of every persistable var: (arrays, index,
    skipped), touching no disk, so that a background writer
    (checkpoint.CheckpointManager) can serialize it later while training
    goes on.  arrays: {name: np.ndarray}; index: {name: [{"start",
    "shape"}]}, one whole-tensor entry each; skipped: persistable names
    absent from the scope (callers decide whether that is fatal)."""
    from .framework.framework import default_main_program
    from .framework.scope import global_scope

    if gather:
        raise NotImplementedError(
            f"snapshot_sharded(gather=True) {_MULTI_DEVICE}")
    program = main_program or default_main_program()
    scope = scope or global_scope()
    arrays, index, skipped = {}, {}, []
    for var in program.list_vars():
        if not _is_persistable(var):
            continue
        name = var.name
        value = scope.find_var(name)
        if value is None:
            skipped.append(name)
            continue
        arr = _host_array(name, value)
        arrays[name] = arr
        index[name] = [{"start": [0] * arr.ndim, "shape": list(arr.shape)}]
    return arrays, index, skipped


def write_sharded(dirname, arrays, index):
    """Serialize a snapshot_sharded() result as process 0 of a world of 1
    (the world size is recorded so that load_sharded can tell a missing
    process's files from a hole)."""
    os.makedirs(dirname, exist_ok=True)
    np.savez(os.path.join(dirname, "shard_0.npz"), **arrays)
    with open(os.path.join(dirname, "shard_0.index.json"), "w") as f:
        json.dump({"vars": index, "world": 1}, f)


def save_sharded(dirname, scope=None, main_program=None):
    """Checkpoint every persistable var in the sharded layout.  Returns
    the sorted names saved, and warns on persistable vars missing from the
    scope."""
    arrays, index, skipped = snapshot_sharded(scope, main_program)
    if skipped:
        warnings.warn(
            f"save_sharded: {len(skipped)} persistable var(s) absent from "
            f"the scope were NOT saved: {sorted(skipped)[:8]}"
            f"{'...' if len(skipped) > 8 else ''}",
            RuntimeWarning, stacklevel=2,
        )
    write_sharded(dirname, arrays, index)
    return sorted(index)


def _assemble(dirname):
    """{name: global np.ndarray} from every shard file under `dirname`,
    with the JAX package's checks: every process of the recorded world
    present, the slices tiling each var exactly, pasted in sorted-start
    order."""
    index_paths = sorted(glob.glob(os.path.join(dirname,
                                                "shard_*.index.json")))
    if not index_paths:
        raise FileNotFoundError(
            f"load_sharded: no shard_*.index.json files under {dirname!r} "
            "(not a save_sharded checkpoint, or an empty/partial write)")
    blocks, world = {}, 1
    for path in index_paths:
        with open(path) as f:
            meta = json.load(f)
        world = max(world, int(meta.get("world", 1)))
        npz = np.load(path.replace(".index.json", ".npz"))
        for name, entries in meta["vars"].items():
            for e in entries:
                blocks.setdefault(name, []).append(
                    (e["start"], npz[e.get("key", name)]))
    missing = [f"shard_{p}{suffix}" for p in range(world)
               for suffix in (".index.json", ".npz")
               if not os.path.exists(os.path.join(dirname,
                                                  f"shard_{p}{suffix}"))]
    if missing:
        raise IOError(
            f"load_sharded: checkpoint {dirname!r} was written by {world} "
            f"process(es) but shard files are missing: {missing} — "
            "refusing to restore a partial state")
    out = {}
    for name, pieces in blocks.items():
        ndim = pieces[0][1].ndim
        shape = [max(int(start[d]) + int(arr.shape[d])
                     for start, arr in pieces) for d in range(ndim)]
        distinct = {(tuple(int(s) for s in start), arr.shape)
                    for start, arr in pieces}
        covered = sum(int(np.prod(shp)) for _, shp in distinct)
        expected = int(np.prod(shape))
        if covered < expected:
            raise IOError(
                f"load_sharded: var {name!r} has a coverage gap — saved "
                f"slices cover {covered} of {expected} elements of the "
                f"inferred global shape {shape}")
        if covered > expected:
            raise IOError(
                f"load_sharded: var {name!r} has overlapping slices — "
                f"saved slices cover {covered} elements of the "
                f"{expected}-element inferred global shape {shape}")
        if len(pieces) == 1 and list(pieces[0][1].shape) == shape:
            full = pieces[0][1]
        else:
            full = np.zeros(shape, pieces[0][1].dtype)
            for start, arr in sorted(
                    pieces, key=lambda p: tuple(int(s) for s in p[0])):
                sl = tuple(slice(s, s + d) for s, d in zip(start, arr.shape))
                full[sl] = arr
        if full.dtype.kind == "V":
            raise TypeError(
                f"load_sharded: var {name!r} was saved as {full.dtype} "
                "void bytes (a bfloat16 array through numpy), which cannot "
                "be read back as numbers (ROADMAP.md C15)")
        out[name] = full
    return out


def load_sharded(dirname, scope=None, main_program=None, mesh=None,
                 place=None):
    """Restore a save_sharded checkpoint into `scope`.  A var the scope
    already holds as a tensor of the saved shape is overwritten in place
    (it keeps its storage, so a captured CUDA graph that reads it stays
    valid); any other is created on `place` (default: the card).  Returns
    the sorted names restored."""
    import torch

    from .framework.core_types import as_device, dtype_to_torch
    from .framework.framework import default_main_program
    from .framework.scope import global_scope

    if mesh is not None:
        raise NotImplementedError(f"load_sharded(mesh=...) {_MULTI_DEVICE}")
    program = main_program or default_main_program()
    scope = scope or global_scope()
    device = None
    assembled = _assemble(dirname)
    for name, full in assembled.items():
        value = torch.from_numpy(np.ascontiguousarray(full))
        have = scope.find_var(name)
        if isinstance(have, torch.Tensor) and tuple(have.shape) == \
                tuple(value.shape):
            have.copy_(value.to(have.dtype))
            continue
        var = program.global_block().vars.get(name)
        if var is not None and var.type == VarType.LOD_TENSOR:
            value = value.to(dtype_to_torch(var.dtype))
        if device is None:
            device = as_device(place)
        scope.set_var(name, value.to(device))
    return sorted(assembled)
