"""Kernel #8 (batch-norm affine + relu folded into a 1x1 conv) against the
JAX package's Pallas kernel, and the port's conv1x1 probe against the TPU
probe's math, on the CPU.

The JAX side is tools/conv1x1_fuse_probe.py's `pallas_bn_relu_conv1x1`,
run in interpret mode: `jax.experimental.pallas.pallas_call` is replaced
for the call by itself with interpret=True (the probe imports `pl` when it
is called, so nothing of it changes).  The port side is the kernel
wrapper on CPU tensors, which runs its plain version.

Tolerances: float32 rtol 1e-5 (atol 1e-5 of the output's largest
magnitude, for entries near 0); bfloat16 rtol 1e-2 and atol 1e-2 of the
largest magnitude (the two sum in other orders before the final bfloat16
rounding).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas

from paddle_tpu_torch import testing
from paddle_tpu_torch.ops.cuda import bn_relu_conv1x1 as brc
from paddle_tpu_torch.tools import conv1x1_fuse_probe as probe

_TPU_PROBE = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "conv1x1_fuse_probe.py"


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


@pytest.fixture(scope="module")
def tpu_probe():
    spec = importlib.util.spec_from_file_location("tpu_conv1x1_probe",
                                                  _TPU_PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


def _inputs(seed, b, c, h, w, k):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, c, h, w)).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            (rng.standard_normal(c) * 0.5).astype(np.float32),
            (rng.standard_normal((c, k)) * c ** -0.5).astype(np.float32))


def _bf16(a):
    """float32 values rounded to bfloat16 once, as numpy float32 (the same
    numbers then reach both packages)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _close(got, want, rtol, atol_frac):
    atol = atol_frac * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


_SHAPES = {
    # (b, c, h, w, k): two conv3 sites at B = 2, and HW = 576 > the Pallas
    # tile of 512, so two tiles run and the second is ragged
    "64->256 14x14": (2, 64, 14, 14, 256),
    "128->512 7x7": (2, 128, 7, 7, 512),
    "64->128 24x24": (2, 64, 24, 24, 128),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(_SHAPES))
def test_plain_version_matches_the_pallas_kernel(tpu_probe, interpret, name,
                                                 dtype):
    y, scale, bias, w = _inputs(0, *_SHAPES[name])
    if dtype == "bfloat16":
        y, w = _bf16(y), _bf16(w)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(tpu_probe.pallas_bn_relu_conv1x1(
        jnp.asarray(y, jdt), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(w, jdt)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    before = brc.launches
    got = brc.bn_relu_conv1x1(torch.as_tensor(y).to(tdt),
                              torch.as_tensor(scale), torch.as_tensor(bias),
                              torch.as_tensor(w).to(tdt))
    assert brc.launches == before   # the CPU runs the plain version
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if dtype == "float32":
        _close(got.numpy(), want, 1e-5, 1e-5)
    else:
        _close(got.float().numpy(), want, 1e-2, 1e-2)


def test_wrapper_on_the_meta_device_gives_the_output_shape():
    y = torch.empty((3, 16, 5, 7), device="meta", dtype=torch.bfloat16)
    s = torch.empty(16, device="meta")
    w = torch.empty((16, 40), device="meta", dtype=torch.bfloat16)
    z = brc.bn_relu_conv1x1(y, s, s, w)
    assert z.shape == (3, 40, 5, 7) and z.dtype == torch.bfloat16


def _tpu_via_xla(x3, w3, A, Bc, w1c):
    """The TPU probe's composite (tools/conv1x1_fuse_probe.py:86-100)."""
    y = lax.conv_general_dilated(
        x3, w3, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.bfloat16)
    a = jnp.maximum(y.astype(jnp.float32) * A[None, :, None, None]
                    + Bc[None, :, None, None], 0.0).astype(jnp.bfloat16)
    return lax.conv_general_dilated(
        a, w1c, (1, 1), "VALID", dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.bfloat16)


def test_probe_composite_and_kernel_path_match_the_tpu_probe(tpu_probe,
                                                             interpret):
    """At a small shape: the port probe's draws are the TPU probe's
    RandomState(0) draws; its composite equals the TPU probe's via_xla and
    its kernel path the TPU probe's via_pallas (bfloat16 tolerances)."""
    b, c, h, k = 2, 16, 8, 32
    x3, w3, scale, bias, w1, w1c = probe.draw(b, c, h, k, "cpu")
    rng = np.random.RandomState(0)
    want_x3 = rng.randn(b, c, h, h) * 0.1
    np.testing.assert_allclose(x3.float().numpy(), want_x3, rtol=1e-2,
                               atol=1e-3)
    j = [jnp.asarray(t.float().numpy(), d) for t, d in
         ((x3, jnp.bfloat16), (w3, jnp.bfloat16), (scale, jnp.float32),
          (bias, jnp.float32), (w1, jnp.bfloat16), (w1c, jnp.bfloat16))]
    want = np.asarray(_tpu_via_xla(j[0], j[1], j[2], j[3], j[5]),
                      np.float32)
    got = probe.via_composite(x3, w3, scale, bias, w1c).float().numpy()
    _close(got, want, 1e-2, 1e-2)
    y = lax.conv_general_dilated(
        j[0], j[1], (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW",
                                                       "NCHW"),
        preferred_element_type=jnp.bfloat16)
    want_k = np.asarray(tpu_probe.pallas_bn_relu_conv1x1(y, j[2], j[3],
                                                         j[4]), np.float32)
    got_k = probe.via_kernel(x3, w3, scale, bias, w1).float().numpy()
    _close(got_k, want_k, 1e-2, 1e-2)


def test_probe_cost_and_bound_at_the_four_sites():
    """Bytes and FLOP of the 1x1 stage (y, w, scale, bias read; z
    written) and the bound at 3.35 TB/s and 989 TFLOP/s."""
    want_mb = (513.9, 257.0, 129.0, 66.3)
    for (b, c, h, k), mb in zip(probe.SHAPES, want_mb):
        kernel, composite, flop = probe.cost(b, c, h, k)
        assert abs(kernel / 1e6 - mb) < 0.1, (c, kernel)
        assert composite == kernel + 4 * b * c * h * h
        assert abs(flop / 1e9 - 26.3) < 0.05


def test_probe_main_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        probe.main([])
