"""Running the JAX package as the port's reference in the CPU tests.

`jit_at_level(level)` is a context manager that patches `jax.jit`: every
function jitted inside it (the JAX Executor's segments, the JAX
Generator's programs) compiles at XLA backend optimization `level` at its
first call for each argument signature.  The suite runs XLA at level 0
(tests/conftest.py), which sums in other orders than XLA's default level;
the beam test measures that spread.

`f32_rnn_projection(monkeypatch)` lets the JAX package's recurrent ops
run in bfloat16 on the CPU.  Their hoisted input projection is
`jnp.einsum(x, wx, preferred_element_type=float32)`, a bfloat16 x
bfloat16 -> float32 product that the CPU runtime of XLA refuses ("Unsupported
element type for DotThunk::Execute").  The patch computes the same
function with both operands cast to float32 first: a product of two
bfloat16 values is exact in float32, and the sums are float32 either way.
Nothing in the JAX package changes outside the test that asks for it.
"""

import contextlib

import jax
import jax.numpy as jnp

XLA_DEFAULT_LEVEL = 3   # XLA's default backend optimization level


@contextlib.contextmanager
def jit_at_level(level=XLA_DEFAULT_LEVEL):
    real_jit = jax.jit

    def jit(fn, **kw):
        jitted = real_jit(fn, **kw)
        compiled = {}

        def call(*args):
            sig = tuple((getattr(a, "shape", None), str(getattr(a, "dtype",
                                                                 type(a))))
                        for a in jax.tree.leaves(args))
            if sig not in compiled:
                compiled[sig] = jitted.lower(*args).compile(
                    compiler_options={
                        "xla_backend_optimization_level": level})
            return compiled[sig](*args)
        return call

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real_jit


def _project_input_f32(x, wx, b, reverse, width):
    """paddle_tpu/ops/rnn_ops.py:_project_input with float32 operands."""
    if reverse:
        x = jnp.flip(x, axis=1)
    xw = jnp.einsum("bsd,dh->sbh", x.astype(jnp.float32),
                    wx.astype(jnp.float32)).astype(x.dtype)
    if b is not None:
        xw = xw + b.reshape(-1)[:width]
    return xw


def f32_rnn_projection(monkeypatch):
    from paddle_tpu.ops import rnn_ops

    monkeypatch.setattr(rnn_ops, "_project_input", _project_input_f32)
