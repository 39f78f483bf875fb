"""The mesh mode's kernel paths on the card: a 2-rank gloo World on one
card (NCCL refuses two ranks on one device) runs fused_attention on
DTensors, on a tp mesh (each rank's kernel on its local heads: #1 and
#2 at seq 256) and on an sp mesh (the ring: #3 on every rotation, #4
and #5 in its backward), against the same tier on one device over the
whole tensors (max abs 1e-4 of max(1, |ref|), float32).

Marked `cuda`: run with `python -m pytest tests/test_torch_mesh_cuda.py
-m cuda` on a machine with a card.  The card is looked for in the
`world` fixture (never at import); without one each test skips."""

import pytest
import torch

from paddle_tpu_torch.parallel.world import World

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    w = World(2, str(tmp_path_factory.mktemp("mesh") / "rendezvous"),
              device_type="cuda", timeout=300)
    yield w
    w.close()


@pytest.mark.parametrize("causal,lens", [(False, None), (True, [200, 256])])
def test_local_heads_run_the_mha_block_kernels(world, causal, lens):
    for r in world.run("torch_mesh_cases:card_attention", {"tp": 2}, 256,
                       causal, lens):
        assert max(r["errors"]) <= 1e-4, r["errors"]
        assert r["launches"][0] >= 1 and r["launches"][1] >= 1, r


@pytest.mark.parametrize("causal,lens", [(True, None), (True, [700, 1024])])
def test_the_ring_runs_the_flash_kernels(world, causal, lens):
    for r in world.run("torch_mesh_cases:card_attention", {"sp": 2}, 1024,
                       causal, lens):
        assert max(r["errors"]) <= 1e-4, r["errors"]
        assert all(n >= 1 for n in r["launches"][2:]), r
