"""The port's ParallelExecutor on a 4-rank gloo world against the JAX
package's ParallelExecutor on the same mesh shapes (4 of the 8 virtual
CPU devices) and against single-device runs: the twins of
tests/test_parallel_executor.py (dp, the ragged final batch, fsdp with
ReduceStrategy.Reduce, dp x tp) and tests/test_zero.py (ZeRO-1 on dp x
tp, ZeRO-2 on dp), and transformer.tiny on dp x tp with
ReduceStrategy.Reduce and tp_rules() and on sp (dryrun_multichip's first
and third legs: every attention of the sp run on the ring).

One module-scoped World of 4 rank processes (a file rendezvous under
tmp_path) runs the port's side (tests/torch_mesh_cases.py); this process
runs the JAX package and the port's single-device runs.  Both packages
start from the JAX startup's persistables (`convert.load_params`) and
feed the same global batches, each rank its own rows.  Losses rtol 2e-4
(the JAX tests' bar), 3e-4 on the ring (the dryrun's).  Single-device
runs are made once for the tests that share their program and batches.
"""

import functools

import jax
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import layers
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import BuildStrategy as JBuildStrategy
from paddle_tpu.parallel import ParallelExecutor as JParallelExecutor
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import memory as jmemory
from paddle_tpu.parallel import shard as jshard
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.parallel.world import World

import torch_mesh_cases as cases

RANKS, BATCH, STEPS = 4, 32, 4
RTOL = 2e-4
TINY = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16, n_layer=2,
            n_head=4, d_model=64, d_inner=128, dropout=0.0)
ZERO_RULES = {"fc_0.w_0": (None, "tp"), "fc_0.b_0": ("tp",)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(RANKS, str(tmp_path_factory.mktemp("mesh") / "rendezvous"),
              device_type="cpu", timeout=180)
    yield w
    w.close()


def _mlp_feeds(batches=None, seed=42):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(b, cases.DIM).astype("float32"),
             "y": rng.randint(0, cases.CLASSES, size=(b, 1)).astype("int64")}
            for b in (batches or [BATCH] * STEPS)]


def _jax_build(model, opt="sgd", tp_annotate=False, cfg=None):
    if model == "transformer":
        loss, _ = JT.build(JT.TransformerConfig(**cfg))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return loss
    x = layers.data(name="x", shape=[cases.DIM], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="int64")
    h = layers.fc(input=x, size=32, act="relu")
    pred = layers.fc(input=h, size=cases.CLASSES, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=pred, label=y))
    if opt == "sgd":
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    else:
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    if tp_annotate:
        blk = fluid.default_main_program().global_block()
        for name, var in blk.vars.items():
            if var.persistable and var.shape and len(var.shape) == 2 \
                    and var.shape[1] == 32:
                jshard(var, None, "tp")
    return loss


def _jax_train(model, feeds, mesh=None, strategy=None, build=None):
    """(losses, the JAX startup's persistables, per-device optimizer-state
    bytes) of the JAX package's run: one device, or ParallelExecutor on
    `mesh` over the first 4 virtual devices."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), jun.guard():
        loss = _jax_build(model, **(build or {}))
    scope = JScope()
    with jscope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        weights = {v.name: np.asarray(scope.find_var(v.name))
                   for v in main.global_block().vars.values()
                   if v.persistable and scope.find_var(v.name) is not None}
        if mesh is None:
            exe = fluid.Executor(fluid.CPUPlace())
            run = lambda f: exe.run(main, feed=f, fetch_list=[loss])
        else:
            bs = JBuildStrategy()
            for k, v in (strategy or {}).items():
                setattr(bs, k, v)
            pe = JParallelExecutor(
                loss_name=loss.name, main_program=main, build_strategy=bs,
                mesh=jmake_mesh(devices=jax.devices()[:RANKS], **mesh))
            run = lambda f: pe.run(feed=f, fetch_list=[loss.name])
        losses = [float(np.asarray(run(f)[0]).reshape(-1)[0])
                  for f in feeds]
        opt_bytes = jmemory.optimizer_state_bytes(scope, main)
    return losses, weights, opt_bytes


def _port_mesh(world, model, weights, feeds, mesh, strategy=None,
               build=None):
    """The port's ParallelExecutor on every rank; every rank's losses
    equal (the fetch is the whole value)."""
    got = world.run("torch_mesh_cases:train", model, weights, feeds, mesh,
                    strategy, build)
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
    assert all(r["mode"] == "interpret" for r in got)
    return got


def _feeds(key):
    if key[0] == "mlp":
        return _mlp_feeds(list(key[1]))
    return [JT.synthetic_batch(8, JT.TransformerConfig(**TINY), seed=s)
            for s in range(3)]


@functools.lru_cache(maxsize=None)
def _singles(key, opt):
    """(JAX single-device losses, its startup's persistables, the port's
    single-device losses from them) of `key` = ("mlp", batches) or
    ("transformer",) with the MLP's optimizer `opt`."""
    feeds = _feeds(key)
    build = {"cfg": TINY} if key[0] == "transformer" else {"opt": opt}
    jax_single, weights, _ = _jax_train(key[0], feeds, build=build)
    port_single = cases.train(key[0], weights, feeds, build=build)["losses"]
    return jax_single, weights, port_single


def _check(key, world, mesh, strategy=None, build=None, port_strategy=None,
           jax_mesh=True, rtol=RTOL):
    """Port mesh == JAX mesh (unless `jax_mesh` is False: the JAX
    package's own tests hold its mesh to its single device) == single
    device (both packages).  Returns the port mesh's losses."""
    build = dict(build or {})
    jax_single, weights, port_single = _singles(key, build.get("opt", "sgd"))
    if key[0] == "transformer":
        build = {"cfg": TINY}
    feeds = _feeds(key)
    got = _port_mesh(world, key[0], weights, feeds, mesh,
                     port_strategy or strategy, build)
    port_mesh = got[0]["losses"]
    if jax_mesh:
        np.testing.assert_allclose(
            port_mesh, _jax_train(key[0], feeds, mesh, strategy, build)[0],
            rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(port_mesh, jax_single, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(port_mesh, port_single, rtol=rtol, atol=1e-6)
    return port_mesh


MLP = ("mlp", (BATCH,) * STEPS)


def test_dp_matches_jax_and_single_device(world):
    losses = _check(MLP, world, {"dp": 4})
    assert losses[0] > losses[-1], "loss should decrease"


def test_dp_ragged_final_batch_matches(world):
    """A batch that does not split over dp (13 rows over 4 ranks, each
    feeding its np.array_split share) is gathered whole and runs
    replicated, as the JAX package's stage_feed degrades it."""
    _check(("mlp", (BATCH, BATCH, 13, BATCH)), world, {"dp": 4})


def test_fsdp_reduce_strategy_matches(world):
    _check(MLP, world, {"fsdp": 4},
           {"reduce_strategy": JBuildStrategy.ReduceStrategy.Reduce},
           port_strategy={"reduce_strategy": 1})


def test_dp_x_tp_matches(world):
    _check(MLP, world, {"dp": 2, "tp": 2}, build={"tp_annotate": True})


def test_transformer_dp_x_tp_reduce_matches(world):
    """dryrun_multichip's first leg at transformer.tiny: dp x tp,
    ReduceStrategy.Reduce, tp_rules(); held to both packages' single
    device (its JAX mesh run is tests/test_parallel_executor.py's
    business, and would double this test's compile time)."""
    assert PT.tp_rules() == JT.tp_rules()
    _check(("transformer",), world, {"dp": 2, "tp": 2},
           {"reduce_strategy": JBuildStrategy.ReduceStrategy.Reduce,
            "tensor_parallel_rules": JT.tp_rules()},
           port_strategy={"reduce_strategy": 1,
                          "tensor_parallel_rules": PT.tp_rules()},
           jax_mesh=False)


def test_transformer_trains_on_an_sp_mesh(world):
    """dryrun_multichip's ring leg at transformer.tiny (sp 4, seq 16:
    s_loc 4, the composite body), held to both packages' single device
    at the ring's rtol."""
    _check(("transformer",), world, {"sp": RANKS}, jax_mesh=False,
           rtol=3e-4)


def test_zero1_dp_x_tp_matches_and_shards_moments(world):
    """ZeRO-1 on dp 2 x tp 2: losses as both single-device runs and the
    JAX mesh, and a rank holds the bytes of optimizer state a JAX device
    holds, with and without ZeRO (ZeRO: 1/dp of the moments, plus the
    [1]-shaped accumulators, at most 0.55 of the run without it)."""
    feeds = _mlp_feeds()
    build = {"opt": "adam"}
    mesh = {"dp": 2, "tp": 2}
    base = {"zero_stage": 0, "tensor_parallel_rules": ZERO_RULES}
    zero = {"zero_stage": 1, "tensor_parallel_rules": ZERO_RULES}
    jax_single, weights, _ = _singles(MLP, "adam")
    jax_base, _, jbase_bytes = _jax_train("mlp", feeds, mesh, base, build)
    jax_zero, _, jzero_bytes = _jax_train("mlp", feeds, mesh, zero, build)
    got_base = _port_mesh(world, "mlp", weights, feeds, mesh, base, build)
    got_zero = _port_mesh(world, "mlp", weights, feeds, mesh, zero, build)
    for want in (jax_single, jax_base, jax_zero):
        np.testing.assert_allclose(got_zero[0]["losses"], want, rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(got_base[0]["losses"], want, rtol=RTOL,
                                   atol=1e-6)
    assert max(r["opt_bytes"] for r in got_base) == jbase_bytes
    assert max(r["opt_bytes"] for r in got_zero) == jzero_bytes
    ratio = jzero_bytes / jbase_bytes
    assert ratio <= 0.55, ratio


def test_zero2_dp_matches(world):
    _check(MLP, world, {"dp": 4}, {"zero_stage": 2}, build={"opt": "adam"})


def test_staged_collectives_give_the_same_losses(world):
    """DTensor's collectives staged through host buffers (what a mesh on
    the card runs under gloo, here registered for the CPU) train the
    transformer on dp x tp to both packages' single-device losses, every
    staged call counted.  Last in the file: the staged kernels stay
    registered in the ranks."""
    jax_single, weights, port_single = _singles(("transformer",), "sgd")
    strategy = {"reduce_strategy": 1, "tensor_parallel_rules": PT.tp_rules()}
    staged = world.run("torch_mesh_cases:train_staged", "transformer",
                       weights, _feeds(("transformer",)), {"dp": 2, "tp": 2},
                       strategy, {"cfg": TINY})
    for r in staged:
        np.testing.assert_allclose(r["losses"], jax_single, rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(r["losses"], port_single, rtol=RTOL,
                                   atol=1e-6)
        assert r["stats"]["staged_collectives"] > 0
        assert r["stats"]["host_staged_bytes"] > 0
