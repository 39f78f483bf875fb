"""MoE checkpoints in the port (the twins of tests/test_moe_checkpoint.py):
the expert placement saved beside the dense state (`moe_<name>.json`, the
train state's `moe_topology`), restored with its epoch, rejected when it
is missing or its world disagrees; the files are the JAX manager's byte
for byte, each package restores the other's, and tools/ckpt_fsck.py
(loaded by path, unchanged) accepts the port's directory and flags a
tampered placement.

The model is the JAX test's: x [16, 6] -> moe_ffn (4 experts of 8, top 2,
capacity factor 1.25) -> square error + 0.01 aux, Adam(1e-2), the port
starting from the JAX startup's weights.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import checkpoint as jckpt
from paddle_tpu import moe as jmoe
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, moe, testing
from paddle_tpu_torch.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = pt.CPUPlace()
EXPERTS, SHARDS = 4, 2


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _fsck():
    spec = importlib.util.spec_from_file_location(
        "_ckpt_fsck", os.path.join(REPO, "tools", "ckpt_fsck.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(pkg, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    guard = jun.guard() if pkg is fluid else pt.unique_name.guard()
    with pkg.program_guard(main, startup), guard:
        L = pkg.layers
        x = L.data("x", shape=[6], dtype="float32")
        y = L.data("y", shape=[6], dtype="float32")
        out, aux = L.moe_ffn(x, num_experts=EXPERTS, d_inner=8, top_k=2,
                             capacity_factor=1.25, name="m")
        loss = L.mean(L.square_error_cost(out, y))
        loss = L.elementwise_add(x=loss, y=L.scale(aux, scale=0.01))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _feed(step=0):
    rng = np.random.RandomState(50 + step)
    return {"x": rng.randn(16, 6).astype(np.float32),
            "y": rng.randn(16, 6).astype(np.float32)}


def _np(scope, name):
    v = scope.find_var(name)
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.asarray(v)


class _Both:
    """The JAX program with its startup run, and the port's with the JAX
    startup's persistables carried over."""

    def __init__(self):
        self.jmain, jstartup, self.jloss = _build(fluid)
        self.main, _, self.loss = _build(pt)
        self.jscope, self.jexe = JScope(), fluid.Executor(fluid.CPUPlace())
        self.jexe.run(jstartup, scope=self.jscope)
        self.names = [v.name for v in self.jmain.list_vars()
                      if v.persistable]
        self.scope, self.exe = pt.Scope(), pt.Executor(CPU)
        convert.load_params(self.scope, {
            n: np.asarray(self.jscope.find_var(n)) for n in self.names},
            CPU, [self.main])

    def train(self, steps, start=0, jax=False):
        for s in range(start, start + steps):
            if jax:
                self.jexe.run(self.jmain, feed=_feed(s),
                              fetch_list=[self.jloss.name],
                              scope=self.jscope)
            else:
                self.exe.run(self.main, feed=_feed(s),
                             fetch_list=[self.loss], scope=self.scope)
        return self


def test_save_restore_roundtrip_with_placement_epoch(tmp_path):
    """A rebalanced placement (epoch 1) is saved beside the dense state; a
    fresh epoch-0 placement adopts it on restore, the expert params come
    back bitwise and the next step's loss equals the uninterrupted run's."""
    w = _Both().train(3)
    placements = moe.placements_for_program(w.main, SHARDS)
    assert list(placements) == ["m"]
    assert placements["m"].param_names == ["m_moe_w1", "m_moe_b1",
                                           "m_moe_w2", "m_moe_b2"]
    moves = placements["m"].rebalance([10.0, 1.0, 1.0, 1.0])
    assert placements["m"].epoch == 1 and isinstance(moves, list)
    w1 = _np(w.scope, "m_moe_w1")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    path = mgr.save(5, scope=w.scope, main_program=w.main, moe=placements)
    assert sorted(os.listdir(path)) == ["dense", "manifest.json", "moe_m.json",
                                        "train_state.json"]
    with open(os.path.join(path, "train_state.json")) as f:
        state = json.load(f)
    assert state["moe_topology"] == {
        "m": {"num_experts": EXPERTS, "num_shards": SHARDS,
              "placement_epoch": 1}}
    (want,) = w.exe.run(w.main, feed=_feed(3), fetch_list=[w.loss],
                        scope=w.scope)
    fresh = moe.placements_for_program(w.main, SHARDS)
    assert fresh["m"].epoch == 0
    s2 = pt.Scope()
    got = mgr.restore(scope=s2, main_program=w.main, moe=fresh, place=CPU)
    assert got["step"] == 5 and fresh["m"].epoch == 1
    np.testing.assert_array_equal(fresh["m"].owner_of(np.arange(EXPERTS)),
                                  placements["m"].owner_of(
                                      np.arange(EXPERTS)))
    np.testing.assert_array_equal(_np(s2, "m_moe_w1"), w1)
    (resumed,) = w.exe.run(w.main, feed=_feed(3), fetch_list=[w.loss],
                           scope=s2)
    np.testing.assert_array_equal(resumed, want)


def test_restore_rejects_missing_or_mismatched_placement(tmp_path):
    w = _Both().train(1)
    mgr = CheckpointManager(str(tmp_path / "a"), async_save=False)
    mgr.save(1, scope=w.scope, main_program=w.main)     # no placement
    with pytest.raises(IOError, match="no MoE placement"):
        mgr.restore(scope=pt.Scope(), main_program=w.main, place=CPU,
                    moe=moe.placements_for_program(w.main, SHARDS))
    mgr2 = CheckpointManager(str(tmp_path / "b"), async_save=False)
    mgr2.save(1, scope=w.scope, main_program=w.main,
              moe=moe.placements_for_program(w.main, SHARDS))
    with pytest.raises(ValueError, match="shards"):
        mgr2.restore(scope=pt.Scope(), main_program=w.main, place=CPU,
                     moe=moe.placements_for_program(w.main, 4))
    other = {"m": moe.ExpertPlacement(8, SHARDS)}
    with pytest.raises(ValueError, match="experts"):
        mgr2.restore(scope=pt.Scope(), main_program=w.main, place=CPU,
                     moe=other)


def test_placement_files_are_the_jax_managers(tmp_path):
    """The same trained weights and the same rebalanced placement saved
    by both managers: moe_m.json byte for byte, and the same
    moe_topology stamp."""
    w = _Both().train(2).train(2, jax=True)
    loads = [1.0, 9.0, 4.0, 2.0]
    pp = moe.placements_for_program(w.main, SHARDS)
    jp = jmoe.placements_for_program(w.jmain, SHARDS)
    pp["m"].rebalance(loads)
    jp["m"].rebalance(loads)
    ppath = CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        4, scope=w.scope, main_program=w.main, moe=pp)
    jpath = jckpt.CheckpointManager(str(tmp_path / "jax"),
                                    async_save=False).save(
        4, scope=w.jscope, main_program=w.jmain, moe=jp)
    with open(os.path.join(ppath, "moe_m.json"), "rb") as f:
        mine = f.read()
    with open(os.path.join(jpath, "moe_m.json"), "rb") as f:
        theirs = f.read()
    assert mine == theirs
    states = []
    for path in (ppath, jpath):
        with open(os.path.join(path, "train_state.json")) as f:
            states.append(json.load(f)["moe_topology"])
    assert states[0] == states[1]


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_each_package_restores_the_others_moe_checkpoint(tmp_path, saver):
    w = _Both()
    w.train(2, jax=saver == "jax")
    root = str(tmp_path)
    if saver == "jax":
        placements = jmoe.placements_for_program(w.jmain, SHARDS)
        placements["m"].rebalance([5.0, 5.0, 1.0, 0.0])
        saved = {n: np.asarray(w.jscope.find_var(n)) for n in w.names}
        jckpt.CheckpointManager(root, async_save=False).save(
            2, scope=w.jscope, main_program=w.jmain, moe=placements)
        fresh = moe.placements_for_program(w.main, SHARDS)
        s2 = pt.Scope()
        state = CheckpointManager(root).restore(
            scope=s2, main_program=w.main, moe=fresh, place=CPU)
        got = {n: _np(s2, n) for n in w.names}
    else:
        placements = moe.placements_for_program(w.main, SHARDS)
        placements["m"].rebalance([5.0, 5.0, 1.0, 0.0])
        saved = {n: _np(w.scope, n) for n in w.names}
        CheckpointManager(root, async_save=False).save(
            2, scope=w.scope, main_program=w.main, moe=placements)
        fresh = jmoe.placements_for_program(w.jmain, SHARDS)
        s2 = JScope()
        state = jckpt.CheckpointManager(root).restore(
            scope=s2, main_program=w.jmain, moe=fresh)
        got = {n: np.asarray(s2.find_var(n)) for n in w.names}
    assert state["step"] == 2
    assert fresh["m"].epoch == 1
    assert fresh["m"].to_meta() == placements["m"].to_meta()
    for n in w.names:
        np.testing.assert_array_equal(got[n], saved[n], err_msg=n)


def test_ckpt_fsck_accepts_the_port_and_flags_tampers(tmp_path):
    fsck = _fsck()
    w = _Both().train(1)
    path = CheckpointManager(str(tmp_path), async_save=False).save(
        2, scope=w.scope, main_program=w.main,
        moe=moe.placements_for_program(w.main, SHARDS))
    ok, problems = fsck.fsck_one(path)
    assert ok, problems
    mpath = os.path.join(path, "moe_m.json")
    with open(mpath) as f:
        good = f.read()
    # tamper 1: the placement claims more experts than the params hold
    meta = json.loads(good)
    meta["num_experts"] = 8
    meta["routing"]["slots"] = [0, 1] * 4
    with open(mpath, "w") as f:
        json.dump(meta, f)
    problems = fsck.check_moe_files(path)
    assert any("leading dim" in p for p in problems), problems
    assert any("disagrees with train_state" in p for p in problems)
    # tamper 2: an expert owned by a shard outside the world
    meta = json.loads(good)
    meta["routing"]["slots"][0] = 9
    with open(mpath, "w") as f:
        json.dump(meta, f)
    problems = fsck.check_moe_files(path)
    assert any("outside" in p for p in problems), problems
    with open(mpath, "w") as f:
        f.write(good)
    assert not fsck.check_moe_files(path)
