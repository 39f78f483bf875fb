"""The port's ring attention on a 4-rank gloo world (sp=4) against the
JAX package's `ring_attention` on an sp=4 mesh of 4 virtual CPU devices:
the forward and the q/k/v grads (by the `fused_attention_grad` op's
`ring_attention_grad` and by autograd), causal and not, with global key
lengths that cross rank boundaries, on both per-rotation bodies: the
composite (s_loc 8) and the flash body (s_loc 128, head_dim 64: kernel #3
per rotation and #4/#5 in the backward, here their plain versions; the
JAX side's Pallas kernels in interpret mode, as tests/test_ring_attention.py:97
runs them).  (transformer.tiny trained on an sp=4 mesh is
tests/test_torch_parallel_executor.py's, which shares its single-device
runs with the dp x tp leg.)

Tolerances: forward 2e-5 (the JAX tests'), grads 3e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.ring_attention import ring_attention as jring
from paddle_tpu_torch.parallel.world import World


RANKS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(RANKS, str(tmp_path_factory.mktemp("ring") / "rendezvous"),
              device_type="cpu", timeout=180)
    yield w
    w.close()


def _jax_ring(q, k, v, g, heads, causal, lens, flash):
    mesh = jmake_mesh(devices=jax.devices()[:RANKS], sp=RANKS)
    sl = None if lens is None else jnp.asarray(lens, jnp.int32)
    if flash:
        jflags.set("flash_attention", "interpret")
    try:
        def f(q_, k_, v_):
            return jring(q_, k_, v_, mesh, num_heads=heads, causal=causal,
                         seq_len=sl)

        @jax.jit
        def fwd_bwd(q_, k_, v_, g_):
            # one compile for the forward and its vjp (an eager
            # shard_map compiles each transform apart, ~5x the time)
            out, vjp = jax.vjp(f, q_, k_, v_)
            return out, vjp(g_)

        out, grads = fwd_bwd(q, k, v, g)
    finally:
        jflags.reset("flash_attention")
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("body,causal,lens", [
    ("composite", False, None),
    ("composite", True, None),
    ("composite", True, [23, 9]),
    ("composite", False, [23, 9]),
    ("flash", True, [700]),
    ("flash", False, None),
])
def test_ring_matches_jax(world, body, causal, lens):
    rng = np.random.RandomState(3)
    shape = (1, 512, 64) if body == "flash" else (2, 32, 16)
    q, k, v, g = (rng.rand(*shape).astype("float32") for _ in range(4))
    if lens is not None:
        lens = np.asarray(lens[:shape[0]], np.int64)
    heads = 1 if body == "flash" else 2
    want, want_grads = _jax_ring(q, k, v, g, heads, causal, lens,
                                 body == "flash")
    got = world.run("torch_mesh_cases:ring", q, k, v, g, causal, lens,
                    "interpret" if body == "flash" else None)
    for r in got:
        assert r["flash_body"] == (body == "flash")
        np.testing.assert_allclose(r["out"], want, rtol=2e-5, atol=2e-5)
        for mine in (r["grads"], r["autograd"]):
            for a, b, name in zip(mine, want_grads, "qkv"):
                np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-4,
                                           err_msg=f"d{name}")
