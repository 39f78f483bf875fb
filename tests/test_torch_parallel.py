"""The port's parallel/ annotations and arithmetic against the JAX
package's, with no process group: on the same built programs every
var's dist_attr after each pass (apply_data_parallel, apply_zero_sharding,
apply_tensor_parallel(tp_rules()), apply_embedding_parallel, apply_zero
stages 1 and 2, zero_topology), the placements the port resolves from
them against the JAX PartitionSpecs, the mesh's size arithmetic and its
errors against the JAX DeviceMesh on the 8 virtual CPU devices, and
memory.estimate / max_fittable_params number for number."""

import functools

import jax
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import layers as jlayers
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import memory as jmemory
from paddle_tpu.parallel import mesh as jmesh_mod
from paddle_tpu.parallel import sharding as jsharding
from paddle_tpu.parallel import zero as jzero
import paddle_tpu_torch as pt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch import testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.parallel import comm, environment
from paddle_tpu_torch.parallel import memory as pmemory
from paddle_tpu_torch.parallel import mesh as pmesh_mod
from paddle_tpu_torch.parallel import sharding as psharding
from paddle_tpu_torch.parallel import zero as pzero

TINY = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16, n_layer=2,
            n_head=4, d_model=64, d_inner=128, dropout=0.0)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _mlp(fl, L):
    x = L.data(name="x", shape=[16], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="int64")
    ids = L.data(name="ids", shape=[1], dtype="int64")
    emb = L.embedding(input=ids, size=[64, 16],
                      param_attr=fl.ParamAttr(name="ep_emb_w"))
    h = L.fc(input=L.elementwise_add(x, L.reshape(emb, [-1, 16])), size=32,
             act="relu")
    pred = L.fc(input=h, size=10, act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=y))
    fl.optimizer.Adam(learning_rate=1e-2).minimize(loss)


def _build(model):
    """The same program built in both packages: (jax main, port main),
    fresh clones of one build a model."""
    return tuple(p.clone() for p in _built(model))


@functools.lru_cache(maxsize=None)
def _built(model):
    out = []
    for fl, L, T, un in ((fluid, jlayers, JT, jun),
                         (pt, players, PT, pt.unique_name)):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), un.guard():
            if model == "mlp":
                _mlp(fl, L)
            else:
                loss, _ = T.build(T.TransformerConfig(**TINY))
                fl.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        out.append(main)
    return tuple(out)


def _attrs(program):
    return {n: v.dist_attr for n, v in program.global_block().vars.items()}


def _meshes(**axes):
    return (jmesh_mod.make_mesh(devices=jax.devices()[:_n(axes)], **axes),
            pmesh_mod.make_mesh(devices=_n(axes), **axes))


def _n(axes):
    return int(np.prod(list(axes.values())))


PASSES = {
    "data_parallel": lambda S, prog, mesh, rules: S.apply_data_parallel(
        prog, mesh),
    "zero_sharding": lambda S, prog, mesh, rules: S.apply_zero_sharding(
        S.apply_data_parallel(prog, mesh), mesh),
    "tensor_parallel": lambda S, prog, mesh, rules: S.apply_tensor_parallel(
        S.apply_data_parallel(prog, mesh), rules),
}


@pytest.mark.parametrize("model", ["mlp", "transformer"])
@pytest.mark.parametrize("name", sorted(PASSES))
@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 2, "tp": 4},
                                  {"fsdp": 4, "tp": 2}])
def test_passes_stamp_the_jax_packages_annotations(model, name, axes):
    jmain, pmain = _build(model)
    jm, pm = _meshes(**axes)
    rules = (JT.tp_rules() if model == "transformer"
             else {"fc_0.w_0": (None, "tp"), "fc_0.b_0": ("tp",)})
    PASSES[name](jsharding, jmain, jm, rules)
    PASSES[name](psharding, pmain, pm, rules)
    assert _attrs(pmain) == _attrs(jmain)
    assert any(a for a in _attrs(pmain).values())
    # the placements the port resolves are the JAX PartitionSpecs
    for n, var in pmain.global_block().vars.items():
        jvar = jmain.global_block().vars[n]
        js = jsharding.sharding_for_var(jvar, jm)
        pl = psharding.sharding_for_var(var, pm)
        assert (js is None) == (pl is None), n
        if js is None:
            continue
        want = [None] * len(pm.axis_names)
        for d, entry in enumerate(js.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    want[pm.dim(a)] = d
        got = [p.dim if p.is_shard() else None for p in pl]
        assert got == want, (n, js.spec, pl)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("axes,rules", [
    ({"dp": 8}, None),
    ({"dp": 4, "tp": 2}, "tp_rules"),
])
def test_apply_zero_stamps_the_jax_packages_annotations(stage, axes, rules):
    jmain, pmain = _build("transformer")
    jm, pm = _meshes(**axes)
    for S, Z, prog, mesh in ((jsharding, jzero, jmain, jm),
                             (psharding, pzero, pmain, pm)):
        S.apply_data_parallel(prog, mesh)
        if rules:
            S.apply_tensor_parallel(prog, JT.tp_rules())
        Z.apply_zero(prog, mesh, stage=stage)
    assert _attrs(pmain) == _attrs(jmain)
    assert pzero.zero_topology(pmain) == jzero.zero_topology(jmain)
    assert pzero.zero_topology(pmain)["sharded_vars"]


def test_zero_topology_and_errors_match():
    jmain, pmain = _build("mlp")
    assert pzero.zero_topology(pmain) is None
    jm, pm = _meshes(dp=8)
    for S in (jsharding, psharding):
        S.shard(jmain.global_block().var("fc_0.w_0_moment1_0")
                if S is jsharding else
                pmain.global_block().var("fc_0.w_0_moment1_0"), "dp", None)
    assert pzero.zero_topology(pmain, pm) == jzero.zero_topology(jmain, jm)
    jt, pt_ = _meshes(tp=8)
    msgs = []
    for Z, prog, mesh in ((jzero, jmain, jt), (pzero, pmain, pt_)):
        with pytest.raises(ValueError, match="live") as e:
            Z.apply_zero(prog, mesh)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="ep"):
        psharding.apply_embedding_parallel(pmain, mesh=pm)


def test_embedding_parallel_matches():
    jmain, pmain = _build("mlp")
    jm, pm = _meshes(dp=2, ep=4)
    jsharding.apply_embedding_parallel(jmain, mesh=jm)
    psharding.apply_embedding_parallel(pmain, mesh=pm)
    assert _attrs(pmain) == _attrs(jmain)
    assert pmain.global_block().var("ep_emb_w").dist_attr == ("ep", None)


@pytest.mark.parametrize("axes", [
    {"dp": -1}, {"dp": 2, "tp": -1}, {"dp": 2, "tp": 4}, {"tp": 8},
    {"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 3}, {"dp": -1, "tp": -1},
    {"dp": 3, "tp": -1}, {"dp": 4, "tp": 4}, {"sp": None, "dp": 4},
])
def test_mesh_sizes_and_errors_match_the_jax_mesh(axes):
    try:
        want = jmesh_mod.DeviceMesh(dict(axes))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh_mod.mesh_sizes(dict(axes), 8)
        assert str(got.value) == str(e)
        with pytest.raises(ValueError):
            pmesh_mod.DeviceMesh(dict(axes), devices=8)
        return
    sizes = pmesh_mod.mesh_sizes(dict(axes), 8)
    assert tuple(sizes) == want.axis_names
    assert tuple(sizes.values()) == want.axis_sizes
    mine = pmesh_mod.DeviceMesh(dict(axes), devices=8)
    assert (mine.axis_names, mine.axis_sizes, mine.size) == (
        want.axis_names, want.axis_sizes, want.size)
    assert repr(mine) == repr(want)
    for a in ("dp", "tp", "ep"):
        assert mine.axis_size(a) == want.axis_size(a)
        assert mine.has_axis(a) == want.has_axis(a)


def test_make_mesh_default_and_guard():
    m = pmesh_mod.make_mesh(devices=4)
    assert m.axis_names == ("dp",) and m.axis_sizes == (4,)
    assert pmesh_mod.get_current_mesh() is None
    with pmesh_mod.mesh_guard(m):
        assert pmesh_mod.get_current_mesh() is m
    assert pmesh_mod.get_current_mesh() is None
    with pytest.raises(RuntimeError, match="process group"):
        m.torch_mesh


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("axes", [{"dp": 4}, {"dp": 4, "tp": 2}, None])
def test_memory_estimate_matches(stage, axes):
    jmain, pmain = _build("transformer")
    if stage:
        jzero.apply_zero(jmain, stage=stage)
        pzero.apply_zero(pmain, stage=stage)
    if axes and "tp" in axes:
        jsharding.apply_tensor_parallel(jmain, JT.tp_rules())
        psharding.apply_tensor_parallel(pmain, PT.tp_rules())
    # the JAX package's shape inference narrows an int64 reshape of the
    # labels to int32 (x64 off); the arithmetic is held on equal programs
    for n, v in pmain.global_block().vars.items():
        jv = jmain.global_block().vars[n]
        if str(jv.dtype) == "int32" and str(v.dtype) == "int64":
            jv.dtype = v.dtype
    kw = dict(axes=axes, batch=8, seq_len=16)
    assert pmemory.estimate(pmain, **kw) == jmemory.estimate(jmain, **kw)
    for n, v in pmain.global_block().vars.items():
        assert pmemory.classify_var(v) == jmemory.classify_var(
            jmain.global_block().vars[n]), n
    args = dict(axes=axes, zero_stage=stage)
    assert pmemory.max_fittable_params(80 * 2**30, **args) == \
        jmemory.max_fittable_params(80 * 2**30, **args)


def test_dist_attr_is_cloned_and_not_serialized():
    _, pmain = _build("mlp")
    var = pmain.global_block().var("fc_0.w_0")
    psharding.shard(var, None, "tp")
    assert pmain.clone().global_block().var("fc_0.w_0").dist_attr == (
        None, "tp")
    assert "dist_attr" not in var.to_dict()
    back = pt.Program.from_dict(pmain.to_dict())
    assert back.global_block().var("fc_0.w_0").dist_attr is None


def test_backend_rule_and_counts_without_a_process_group():
    assert comm.backend_for(4, "cpu") == "gloo"
    # one card (or none) here: several ranks share it, so gloo
    assert comm.backend_for(4, "cuda") == "gloo"
    assert (environment.global_device_count(),
            environment.local_device_count(), environment.process_count(),
            environment.process_index()) == (1, 1, 1, 0)
    environment.init_distributed()      # single process: nothing to do
    assert environment.process_count() == 1
