"""Quantization-aware training and the int8 freeze: the counterpart of
paddle_tpu/contrib/quantize.py.

The four fake-quant op types are registered here, as the JAX package
registers them: `fake_quantize_dequantize_abs_max` (quantize and
dequantize in one op, straight-through grad), `fake_quantize_abs_max`
(grid values out), `fake_quantize_range_abs_max` (a running scale over a
window of batches, its state written back over itself) and
`fake_dequantize_max_abs`.  Each keeps the JAX arithmetic order,
round(x / scale * qmax) with the scale floored at 1e-8; torch.round and
jnp.round both round half to even, so grids and scales come out bitwise
equal to the JAX package's on the CPU.

`QuantizeTranspiler.training_transpile` rewrites every quantizable op's
float inputs through those ops; `freeze_program` re-rounds the trained
weights; `freeze_int8` writes the deployed form (with `as_int8`, one
quantized_matmul / quantized_conv2d op each, ops/int8_ops.py) and
`convert_to_int8` flips the weights' storage to int8.  Freezing reads the
scope on the host: the abs-max, rounding and clipping run in numpy exactly
as the JAX file runs them, and the result goes back onto the var's device
in the var's dtype, so the grids and the `@int8_scale` sidecars equal the
JAX package's bit for bit.

One divergence, on purpose (ROADMAP C18): the JAX `freeze_int8` leaves a
quantizable op with no weight input (a `matmul` of two activations)
reading grid values with no dequant, off by 127^2 / (scale_x * scale_y).
Here such an op keeps its float inputs, and the quantize ops nothing else
reads are dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.framework import (OpRole, Operator, default_main_program,
                                   default_startup_program)
from ..ops.registry import register_grad, register_op

_QUANTIZABLE_OP_TYPES = ("conv2d", "depthwise_conv2d", "mul", "matmul")
_QUANT_OPS = ("fake_quantize_abs_max", "fake_quantize_range_abs_max")


def _abs_max(x):
    return x.abs().amax().clamp_min(1e-8)


def _on(value, like):
    """A float32 0-d tensor on `like`'s device: a divisor that CUDA
    divides by (a host scalar divisor is a multiply by its reciprocal
    there), so the card rounds as the CPU does."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


@register_op("fake_quantize_dequantize_abs_max")
def fake_quantize_dequantize_abs_max(ctx):
    """scale = max|x| per tensor; quantize to [-qmax, qmax], qmax =
    2^(bits-1) - 1, and dequantize back."""
    x = ctx.input("X")
    qmax = float(2 ** (int(ctx.attr("bit_length", 8)) - 1) - 1)
    scale = _abs_max(x)
    q = torch.round(x / scale * qmax).clamp(-qmax, qmax)
    ctx.set_output("Out", (q * scale / _on(qmax, x)).to(x.dtype))
    ctx.set_output("OutScale", scale.reshape(1).float())


@register_grad("fake_quantize_dequantize_abs_max")
def _fake_quant_grad(ctx):
    """Straight-through: the output's grad passes to X unchanged."""
    x = ctx.input("X")
    ctx.set_output("X@GRAD", ctx.input("Out@GRAD").to(x.dtype))


@register_op("fake_quantize_abs_max")
def fake_quantize_abs_max(ctx):
    """Out is the grid (float storage of integers), OutScale the abs-max:
    Out * scale / qmax recovers the values (fake_dequantize_max_abs)."""
    x = ctx.input("X")
    qmax = float(2 ** (int(ctx.attr("bit_length", 8)) - 1) - 1)
    scale = _abs_max(x)
    q = torch.round(x / scale * qmax).clamp(-qmax, qmax)
    ctx.set_output("Out", q.to(x.dtype))
    ctx.set_output("OutScale", scale.reshape(1).float())


@register_grad("fake_quantize_abs_max")
def _fake_quantize_abs_max_grad(ctx):
    ctx.set_output("X@GRAD", ctx.input("Out@GRAD"))


@register_op("fake_quantize_range_abs_max")
def fake_quantize_range_abs_max(ctx):
    """The activation scale tracked over a window of batches.  InScale
    [1], OutScalesIn [window_size] (a ring written at Iter % window) and
    Iter [1] are persistable state that the op writes back over itself:
    on the jit path the new values are copied into the same storage inside
    the captured step, as Adam's moments are.  With is_test the trained
    InScale is the scale."""
    x = ctx.input("X")
    in_scale = ctx.input("InScale")
    qmax = float(2 ** (int(ctx.attr("bit_length", 8)) - 1) - 1)
    if ctx.attr("is_test", False):
        scale = in_scale.reshape(()).clamp_min(1e-8)
        ctx.set_output("OutScale", scale.reshape(1).float())
    else:
        cur = _abs_max(x).float()
        it = ctx.input("Iter") if ctx.has_input("Iter") else None
        buf = (ctx.input("OutScalesIn") if ctx.has_input("OutScalesIn")
               else None)
        if buf is not None and it is not None:
            # an index tensor, not a host int: no read-back inside a capture
            idx = (it.reshape(1) % buf.shape[0]).long()
            buf = buf.scatter(0, idx, cur.reshape(1))
            scale = buf.amax()
            ctx.set_output("OutScales", buf)
            ctx.set_output("IterOut", it + 1)
        else:
            scale = torch.maximum(cur, in_scale.reshape(()).float())
        ctx.set_output("OutScale", scale.reshape(1))
    q = torch.round(x.float() / scale * qmax).clamp(-qmax, qmax)
    ctx.set_output("Out", q.to(x.dtype))


@register_grad("fake_quantize_range_abs_max")
def _fake_quantize_range_grad(ctx):
    ctx.set_output("X@GRAD", ctx.input("Out@GRAD"))


@register_op("fake_dequantize_max_abs")
def fake_dequantize_max_abs(ctx):
    """Out = X * Scale / max_range."""
    x, scale = ctx.input("X"), ctx.input("Scale")
    max_range = _on(float(ctx.attr("max_range")), x)
    ctx.set_output("Out", (x.float() * scale.reshape(()) / max_range)
                   .to(x.dtype))


# ---------------------------------------------------------------------------
# the scope on the host
# ---------------------------------------------------------------------------


def _host(value):
    """A scope value as a numpy array (float32 for a bfloat16 tensor)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


def _put(scope, name, arr, like, dtype=None):
    """Bind `arr` to `name` on `like`'s device, in `dtype` (default:
    `like`'s dtype)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(like, torch.Tensor):
        t = t.to(device=like.device, dtype=dtype or like.dtype)
    elif dtype is not None:
        t = t.to(dtype)
    scope.set_var(name, t)


class QuantizeTranspiler:
    """training_transpile() puts a fake quantize-dequantize on every
    quantizable op's float inputs (weights and activations);
    freeze_program() re-rounds trained weights through the int grid;
    freeze_int8() writes the deployed int8 form."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000):
        if activation_quantize_type not in ("abs_max", "range_abs_max"):
            raise ValueError(
                "activation_quantize_type must be abs_max or range_abs_max")
        self.weight_bits = int(weight_bits)
        self.activation_bits = int(activation_bits)
        self.activation_quantize_type = activation_quantize_type
        self.window_size = int(window_size)

    def training_transpile(self, program=None, startup_program=None):
        program = program or default_main_program()
        if startup_program is None:
            startup_program = default_startup_program()
        for block in program.blocks:
            self._transpile_block(block, startup_program)
        return program

    def _range_state_vars(self, block, name, startup_program):
        """range_abs_max's persistable state: the scale [1], the window's
        ring [window_size] and the step counter [1], each filled in the
        startup program."""
        specs = [
            (f"{name}.scale@state", (1,), "float32", 1e-3),
            (f"{name}.scales@state", (self.window_size,), "float32", 0.0),
            (f"{name}.iter@state", (1,), "int64", 0),
        ]
        for vname, shape, dtype, init in specs:
            if block.has_var(vname):
                continue
            block.create_var(name=vname, shape=shape, dtype=dtype,
                             persistable=True, stop_gradient=True)
            if startup_program is not None:
                sb = startup_program.global_block()
                sb.create_var(name=vname, shape=shape, dtype=dtype,
                              persistable=True, stop_gradient=True)
                sb.append_op(type="fill_constant", outputs={"Out": [vname]},
                             attrs={"shape": list(shape), "dtype": dtype,
                                    "value": init},
                             infer_shape=False)
        return [s[0] for s in specs]

    def _transpile_block(self, block, startup_program=None):
        quantized = {}  # var name -> quantized var name
        new_ops = []
        params = {n for n, v in block.vars.items()
                  if getattr(v, "persistable", False)}
        for op in list(block.ops):
            role = int(op.attrs.get(OpRole.ATTR_NAME, 0))
            if op.type not in _QUANTIZABLE_OP_TYPES or role & 1:
                continue
            for param, names in op.inputs.items():
                renamed = []
                for name in names:
                    var = block.vars.get(name)
                    if var is None or var.dtype is None or \
                            "float" not in str(var.dtype):
                        renamed.append(name)
                        continue
                    if name not in quantized:
                        new_ops += self._quant_descs(block, op, name, var,
                                                     name in params,
                                                     startup_program)
                        quantized[name] = f"{name}.quantized"
                    renamed.append(quantized[name])
                op.inputs[param] = renamed
        # each insertion lands just before its anchor, so the emission
        # order (quantize, dequantize) is kept
        for anchor, desc in new_ops:
            block.ops.insert(block.ops.index(anchor), Operator(
                block, desc["type"],
                {k: list(v) for k, v in desc["inputs"].items()},
                {k: list(v) for k, v in desc["outputs"].items()},
                desc["attrs"]))
        block.program._bump_version()

    def _quant_descs(self, block, op, name, var, is_w, startup_program):
        """The (anchor, op desc) pairs that quantize `name` before `op`."""
        bits = self.weight_bits if is_w else self.activation_bits
        qname = f"{name}.quantized"
        block.create_var(name=qname, shape=var.shape, dtype=var.dtype)
        if not is_w and self.activation_quantize_type == "range_abs_max":
            scale, window, it = self._range_state_vars(block, name,
                                                       startup_program)
            iname = f"{name}.quantized_int"
            block.create_var(name=iname, shape=var.shape, dtype=var.dtype)
            return [
                (op, {"type": "fake_quantize_range_abs_max",
                      "inputs": {"X": [name], "InScale": [scale],
                                 "Iter": [it], "OutScalesIn": [window]},
                      # the state writes back over itself
                      "outputs": {"Out": [iname], "OutScale": [scale],
                                  "OutScales": [window], "IterOut": [it]},
                      "attrs": {"bit_length": bits,
                                "window_size": self.window_size,
                                "is_test": False}}),
                (op, {"type": "fake_dequantize_max_abs",
                      "inputs": {"X": [iname], "Scale": [scale]},
                      "outputs": {"Out": [qname]},
                      "attrs": {"max_range": float(2 ** (bits - 1) - 1)}}),
            ]
        svar = block.create_var(name=f"{name}.scale", shape=(1,),
                                dtype="float32")
        return [(op, {"type": "fake_quantize_dequantize_abs_max",
                      "inputs": {"X": [name]},
                      "outputs": {"Out": [qname], "OutScale": [svar.name]},
                      "attrs": {"bit_length": bits}})]

    def freeze_program(self, program, scope):
        """Bake trained weights through the int grid, so that saved params
        equal the deployed quantized values."""
        qmax = float(2 ** (self.weight_bits - 1) - 1)
        for block in program.blocks:
            for op in block.ops:
                if op.type != "fake_quantize_dequantize_abs_max":
                    continue
                (name,) = op.inputs["X"]
                var = block.vars.get(name)
                if var is None or not getattr(var, "persistable", False):
                    continue
                live = scope.find_var(name)
                w = _host(live)
                scale = max(float(np.abs(w).max()), 1e-8)
                q = np.clip(np.round(w / scale * qmax), -qmax, qmax)
                _put(scope, name, (q * scale / qmax).astype(w.dtype), live)
        return program

    def freeze_int8(self, program, scope, as_int8=False):
        """Rewrite a trained, transpiled inference program into its
        deployed int8 form (quantize.py:218 of the JAX package):

          * weights are baked onto the int grid in `scope` (float storage
            of integers) and their quantize ops removed; the weight scale
            becomes the dequant constant;
          * activation quantize ops stay (abs_max quantizes per batch,
            range_abs_max turns is_test and uses its trained scale) and
            now emit grid values, which the matmul or conv consumes;
          * a fake_dequantize_max_abs follows each quantized mul or conv
            with max_range = wq * aq / weight_scale and Scale = the
            activation's scale.

        as_int8=True instead turns each such op and its dequant into one
        quantized_matmul / quantized_conv2d (ops/int8_ops.py), with the
        weight scale in a persistable `<w>@int8_scale` sidecar (WScale),
        so the program round-trips through save/load_inference_model;
        convert_to_int8 then flips the weights' storage to int8.

        A quantizable op with no weight input keeps its float inputs
        (ROADMAP C18).  Call on a clone(for_test=True) after training."""
        wq = float(2 ** (self.weight_bits - 1) - 1)
        aq = float(2 ** (self.activation_bits - 1) - 1)
        for block in program.blocks:
            weight_scale = {}   # quantized name -> python float scale
            act_scale_var = {}  # grid name -> scale var name
            grid_src = {}       # grid name -> the float var it quantizes
            kept = []
            for op in block.ops:   # pass 1: rewrite or remove quant ops
                if op.type == "fake_quantize_dequantize_abs_max":
                    (name,) = op.inputs["X"]
                    qname = op.outputs["Out"][0]
                    var = block.vars.get(name)
                    if var is not None and getattr(var, "persistable",
                                                   False):
                        live = scope.find_var(name)
                        w = _host(live)
                        scale = max(float(np.abs(w).max()), 1e-8)
                        grid = np.clip(np.round(w / scale * wq), -wq, wq)
                        _put(scope, name, grid.astype(w.dtype), live)
                        weight_scale[qname] = scale
                        continue  # op removed; consumers read `name`
                    # an activation: quantized to the grid per batch
                    kept.append(Operator(
                        block, "fake_quantize_abs_max", {"X": [name]},
                        {"Out": [qname], "OutScale": [f"{name}.scale"]},
                        {"bit_length": self.activation_bits}))
                    act_scale_var[qname] = f"{name}.scale"
                    grid_src[qname] = name
                    continue
                if op.type == "fake_quantize_range_abs_max":
                    op.attrs["is_test"] = True
                    act_scale_var[op.outputs["Out"][0]] = \
                        op.inputs["InScale"][0]
                    grid_src[op.outputs["Out"][0]] = op.inputs["X"][0]
                    kept.append(op)
                    continue
                if op.type == "fake_dequantize_max_abs" and \
                        op.inputs["X"][0].endswith(".quantized_int"):
                    # the training-time activation dequant goes: its
                    # consumers read the grid directly
                    act_scale_var[op.outputs["Out"][0]] = act_scale_var.get(
                        op.inputs["X"][0], op.inputs["Scale"][0])
                    for later in block.ops:
                        later.rename_input(op.outputs["Out"][0],
                                           op.inputs["X"][0])
                    continue
                kept.append(op)
            block.ops = kept
            self._rewire(block, scope, weight_scale, act_scale_var, grid_src,
                         wq, aq, as_int8)
        program._bump_version()
        return program

    def _rewire(self, block, scope, weight_scale, act_scale_var, grid_src,
                wq, aq, as_int8):
        """Pass 2: each quantized consumer reads the baked weight and gets
        its dequant (or becomes one int8 op); an activation-only one reads
        its float inputs again (C18)."""
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            w_scale = a_scale = w_param = None
            if op.type in _QUANTIZABLE_OP_TYPES:
                for param, names in op.inputs.items():
                    fixed = []
                    for n in names:
                        if n in weight_scale:
                            w_scale = weight_scale[n]
                            w_param = param
                            fixed.append(n[: -len(".quantized")])
                        else:
                            if n in act_scale_var:
                                a_scale = act_scale_var[n]
                            fixed.append(n)
                    op.inputs[param] = fixed
            if w_scale is None and a_scale is not None:
                for n in list(op.input_arg_names):
                    if n in grid_src:
                        op.rename_input(n, grid_src[n])
            elif w_scale is not None and a_scale is not None:
                if as_int8:
                    self._to_int8_op(block, scope, op, w_param, w_scale,
                                     a_scale, wq, aq)
                else:
                    self._insert_dequant(block, i, op, a_scale,
                                         float(wq * aq / w_scale))
                    i += 1
            i += 1
        read = {n for op in block.ops for n in op.input_arg_names}
        block.ops = [op for op in block.ops
                     if op.type not in _QUANT_OPS
                     or op.outputs["Out"][0] in read]

    @staticmethod
    def _to_int8_op(block, scope, op, w_param, w_scale, a_scale, wq, aq):
        wname = op.inputs[w_param][0]
        sname = f"{wname}@int8_scale"
        block.create_var(name=sname, shape=(1,), dtype="float32",
                         persistable=True, stop_gradient=True)
        _put(scope, sname, np.array([w_scale], np.float32),
             scope.find_var(wname), torch.float32)
        op.attrs["orig_type"] = op.type
        op.attrs["weight_param"] = w_param
        op.attrs["wq_range"] = wq
        op.attrs["aq_range"] = aq
        op.type = ("quantized_conv2d"
                   if op.type in ("conv2d", "depthwise_conv2d")
                   else "quantized_matmul")
        op.inputs["Scale"] = [a_scale]
        op.inputs["WScale"] = [sname]

    @staticmethod
    def _insert_dequant(block, i, op, a_scale, max_range):
        out_name = op.output_arg_names[0]
        deq = f"{out_name}.dequantized"
        src = block.vars[out_name]
        block.create_var(name=deq, shape=src.shape, dtype=src.dtype)
        block.ops.insert(i + 1, Operator(
            block, "fake_dequantize_max_abs",
            {"X": [out_name], "Scale": [a_scale]}, {"Out": [deq]},
            {"max_range": max_range}))
        for later in block.ops[i + 2:]:
            later.rename_input(out_name, deq)

    def convert_to_int8(self, program, scope):
        """Flip every quantized weight of a freeze_int8(as_int8=True)
        program from float storage of grid values to int8 (4x smaller on
        disk and on the card; the scale is already in the sidecar).  The
        int8 ops take either storage.  Returns the converted names."""
        converted = []
        for block in program.blocks:
            for op in block.ops:
                if op.type not in ("quantized_matmul", "quantized_conv2d"):
                    continue
                w_param = op.attr("weight_param")
                if not w_param or not op.inputs.get(w_param):
                    continue
                wname = op.inputs[w_param][0]
                live = scope.find_var(wname)
                if live is None:
                    raise ValueError(
                        f"quantized weight {wname!r} has no value in scope"
                        " — run freeze_int8(as_int8=True) first")
                w = _host(live)
                if w.dtype == np.int8:
                    continue  # idempotent
                qmax = float(op.attr("wq_range",
                                     2 ** (self.weight_bits - 1) - 1))
                _put(scope, wname,
                     np.clip(np.rint(w), -qmax, qmax).astype(np.int8), live,
                     torch.int8)
                var = (block.vars.get(wname)
                       or program.global_block().vars.get(wname))
                if var is not None:
                    var.dtype = "int8"
                converted.append(wname)
        program._bump_version()
        return converted


def convert_to_int8(program, scope, weight_bits=8):
    """QuantizeTranspiler(weight_bits).convert_to_int8(program, scope)."""
    return QuantizeTranspiler(
        weight_bits=weight_bits).convert_to_int8(program, scope)
