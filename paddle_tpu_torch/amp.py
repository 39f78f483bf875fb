"""Mixed-precision (bf16) training: a program-level AMP pass.

Counterpart of paddle_tpu/amp.py.  bf16 shares float32's exponent range,
so no loss scaling is needed.  What remains:

  * `cast_model_to_bf16(main, startup)`, an O2-style rewrite: every
    float32 var of the program (parameters and activations) becomes
    bfloat16, with the matching startup vars and the dtype attrs of the
    ops that produce them.  Run it after building the forward graph and
    before `optimizer.minimize()`, so gradients inherit bf16 and the
    optimizer can provision f32 accumulators;
  * f32 master weights: optimizers built with `multi_precision=True`
    keep an f32 copy of each bf16 parameter, update it in f32 and write
    both (optimizer.py, ops/optimizer_ops.py);
  * the numerics-sensitive lowerings (softmax_with_cross_entropy,
    layer_norm statistics, mean) upcast to f32 inside, whatever the
    storage dtype (ops/loss_ops.py, ops/nn_ops.py, ops/math_ops.py).

On the card a bf16 `mul` is a bf16 `torch.matmul`, which may use the
tensor cores.
"""

from __future__ import annotations

from .framework.core_types import convert_dtype
from .framework.framework import Program, default_startup_program

# vars that stay f32 under O2: learning rates, rng counters and the f32
# master weights
_KEEP_F32_FRAGMENTS = ("learning_rate", "@RNG", "_master")


def _should_flip(name, var, keep_f32):
    if var.dtype is None or convert_dtype(var.dtype) != "float32":
        return False
    if name in keep_f32:
        return False
    return not any(f in name for f in _KEEP_F32_FRAGMENTS)


def _flip_dtype_attrs(op, flipped):
    """dtype-producing attrs follow their flipped output vars
    (initializers' fill_constant/uniform_random/assign_value, cast)."""
    if not any(n in flipped for n in op.output_arg_names):
        return
    for attr in ("dtype", "out_dtype"):
        if attr in op.attrs and convert_dtype(op.attrs[attr]) == "float32":
            op.attrs[attr] = "bfloat16"


def _flip_block(block, flipped, keep_f32):
    for name, var in block.vars.items():
        if _should_flip(name, var, keep_f32):
            var.dtype = "bfloat16"
            flipped.add(name)
    for op in block.ops:
        _flip_dtype_attrs(op, flipped)


def _bn_stat_names(program):
    """Vars holding batch_norm running/saved statistics: they accumulate
    with momentum 0.9 and stay f32."""
    names = set()
    for block in program.blocks:
        for op in block.ops:
            if op.type != "batch_norm":
                continue
            for param in ("Mean", "Variance"):
                names.update(op.inputs.get(param, ()))
            for param in ("MeanOut", "VarianceOut", "SavedMean",
                          "SavedVariance"):
                names.update(op.outputs.get(param, ()))
    return names


def cast_model_to_bf16(program: Program, startup_program: Program = None,
                       keep_f32=()):
    """Flip every float32 var in `program` (and the matching startup vars
    and initializer dtype attrs) to bfloat16.  Returns the set of flipped
    names.  Call after building the forward graph, before minimize()."""
    startup_program = startup_program or default_startup_program()
    keep_f32 = set(keep_f32) | _bn_stat_names(program)
    flipped = set()
    for block in program.blocks:
        _flip_block(block, flipped, keep_f32)
    for block in startup_program.blocks:
        for name, var in block.vars.items():
            if name in flipped and convert_dtype(var.dtype or "") == "float32":
                var.dtype = "bfloat16"
        for op in block.ops:
            _flip_dtype_attrs(op, flipped)
    return flipped
