"""Save and load vars, parameters, persistables and the inference model.

Counterpart of paddle_tpu/io.py:21-205 (reference python/paddle/fluid/
io.py).  As in the reference, saving is itself a Program of `save` /
`load` ops (ops/io_ops.py) that the Executor runs, and the files are the
JAX package's, byte for byte: a model saved by either package loads in
the other.  An inference model is a directory holding `__model__` (JSON:
the pruned test program's `to_dict`, the feed names and the fetch names)
and its persistables.

(The JAX module's sharded checkpoints, `snapshot_sharded`,
`save_sharded` and `load_sharded`, belong to multi-device training and
are not ported.)
"""

from __future__ import annotations

import json
import os

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
