"""Parameter initializers — ops appended to the startup program, as in
paddle_tpu/initializer.py: `exe.run(startup_program)` performs the
initialization on the place the Executor runs on: Constant
(`fill_constant`), Uniform, Xavier and MSRA (`uniform_random`, or
`gaussian_random` when not uniform), Normal (`gaussian_random`),
TruncatedNormal (`truncated_gaussian_random`), Bilinear and NumpyArray
(`assign_value`), with the JAX package's aliases.
"""

from __future__ import annotations

import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)},
            infer_shape=False,
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
            },
            infer_shape=False,
        )


class NormalInitializer(Initializer):
    """-> gaussian_random (conv2d's default filter init)."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
            infer_shape=False,
        )


class TruncatedNormalInitializer(Initializer):
    """-> truncated_gaussian_random: Normal(loc, scale) kept inside loc
    +- 2 scale."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
            infer_shape=False,
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """Glorot init, uniform or normal."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        f_in, f_out = _fan_in_out(var)
        f_in = self.fan_in if self.fan_in is not None else f_in
        f_out = self.fan_out if self.fan_out is not None else f_out
        if self.uniform:
            limit = math.sqrt(6.0 / (f_in + f_out))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (f_in + f_out))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming init, uniform or normal, from the fan-in."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        f_in, _ = _fan_in_out(var)
        f_in = self.fan_in if self.fan_in is not None else f_in
        if self.uniform:
            limit = math.sqrt(6.0 / f_in)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / f_in)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """A bilinear upsampling kernel for conv2d_transpose: each of the
    first min(C_out, C_in) diagonal filters the separable tent (1 - |x /
    f - c|)(1 - |y / f - c|), f = ceil(W / 2), the rest zeros; staged
    through assign_value."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer expects a 4-D kernel")
        c_out, c_in, h, w = shape
        f = math.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        vals = np.zeros((h, w), dtype="float32")
        for y in range(h):
            for x in range(w):
                vals[y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        for i in range(min(c_out, c_in)):
            weight[i, i] = vals
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(shape),
                "dtype": var.dtype,
                "values": weight.reshape(-1).tolist(),
            },
            infer_shape=False,
        )


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(self.value.shape),
                "dtype": var.dtype,
                "values": self.value.reshape(-1).tolist(),
            },
            infer_shape=False,
        )


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
