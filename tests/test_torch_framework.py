"""The port's Program IR, executor plumbing and weight carrier against the
JAX package's.

`transformer.build_decode` at a head_dim-64 config must build the same
prefill, step, verify, chunk and encode programs and their startups in
both packages: op types in order, input/output names, attrs, var shapes
and dtypes (the `paddle_tpu.program.v1` dict of each).  The port's startup must create
exactly the JAX package's parameter names and shapes.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import flags as jflags
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, flags as pflags, testing
from paddle_tpu_torch.framework import core_types
from paddle_tpu_torch.models import transformer as PT

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
PROGRAMS = ("prefill_program", "prefill_startup", "step_program",
            "step_startup", "verify_program", "verify_startup",
            "chunk_program", "chunk_startup", "encode_program",
            "encode_startup")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _specs(prefix_len):
    kw = dict(src_len=128, prefix_len=prefix_len, max_len=256, verify_len=4,
              chunk_len=8)
    return (JT.build_decode(JT.TransformerConfig(**SMALL), **kw),
            PT.build_decode(PT.TransformerConfig(**SMALL), **kw))


@pytest.mark.parametrize("prefix_len", [8, 128])
@pytest.mark.parametrize("which", PROGRAMS)
def test_build_decode_programs_are_identical(prefix_len, which):
    js, ps = _specs(prefix_len)
    jd = getattr(js, which).to_dict()["blocks"][0]
    pd = getattr(ps, which).to_dict()["blocks"][0]
    assert [o["type"] for o in pd["ops"]] == [o["type"] for o in jd["ops"]]
    for jo, po in zip(jd["ops"], pd["ops"]):
        assert po["inputs"] == jo["inputs"], jo["type"]
        assert po["outputs"] == jo["outputs"], jo["type"]
        assert po["attrs"] == jo["attrs"], jo["type"]
    assert [v["name"] for v in pd["vars"]] == [v["name"] for v in jd["vars"]]
    for jv, pv in zip(jd["vars"], pd["vars"]):
        assert pv == jv, jv["name"]
    assert getattr(ps, which).to_dict() == getattr(js, which).to_dict()


def test_generation_specs_agree():
    js, ps = _specs(8)
    for attr in ("prefill_feeds", "step_feeds", "prefill_logits",
                 "step_logits", "lengths_name", "init_lengths_from",
                 "max_len", "bos_id", "eos_id", "prev_ids_name",
                 "verify_logits", "verify_len", "chunk_logits", "chunk_len",
                 "prompt_ids_name"):
        assert getattr(ps, attr) == getattr(js, attr), attr
    for fetches in ("prefill_fetches", "step_fetches", "verify_fetches",
                    "chunk_fetches", "encode_fetches"):
        assert getattr(ps, fetches)() == getattr(js, fetches)(), fetches
    for jst, pst in zip(js.states, ps.states, strict=True):
        for attr in ("feed", "init_from", "update", "pad_to", "zeros",
                     "dtype", "verify_update", "chunk_update", "encode_from"):
            assert getattr(pst, attr) == getattr(jst, attr), attr


def test_decode_op_types_are_the_slice():
    _, ps = _specs(8)
    types = {op.type for name in PROGRAMS
             for op in getattr(ps, name).global_block().ops}
    assert types == {
        "lookup_table", "scale", "elementwise_add", "layer_norm", "mul",
        "relu", "fused_attention", "sequence_pool", "reshape", "gather",
        "increment", "kv_cache_append", "uniform_random", "fill_constant",
        "assign_value", "concat"}


def test_startup_creates_the_jax_parameters():
    js, ps = _specs(8)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    pscope = pt.Scope()
    pexe = pt.Executor(pt.CPUPlace())
    for name in ("prefill_startup", "step_startup"):
        jexe.run(getattr(js, name), scope=jscope)
        pexe.run(getattr(ps, name), scope=pscope)
    jshapes = {n: tuple(np.asarray(jscope.find_var(n)).shape)
               for n in jscope.local_var_names() if "@" not in n}
    pshapes = {n: tuple(pscope.find_var(n).shape)
               for n in pscope.local_var_names() if "@" not in n}
    assert pshapes == jshapes
    for n in pshapes:
        assert pscope.find_var(n).dtype == torch.float32
        assert pscope.find_var(n).device.type == "cpu"
    # the sinusoid tables are data, not draws: equal value for value
    for n in pshapes:
        if "_pos_" in n:
            np.testing.assert_allclose(pscope.find_var(n).numpy(),
                                       np.asarray(jscope.find_var(n)),
                                       rtol=0, atol=1e-6)


def test_uniform_random_is_seeded_from_the_program():
    def draw(seed):
        prog = pt.Program()
        prog.random_seed = seed
        with pt.program_guard(pt.Program(), prog):
            pt.layers.create_parameter([64, 32], "float32", name="w")
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(prog, scope=scope)
        return scope.find_var("w").numpy()

    a, b, c = draw(5), draw(5), draw(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    limit = np.sqrt(6.0 / (64 + 32))  # Xavier uniform bound
    assert np.abs(a).max() <= limit


def test_feeds_keep_their_declared_dtype():
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        ids = pt.layers.data(name="ids", shape=[3], dtype="int64")
        out = pt.layers.increment(ids, value=1, in_place=False)
    (res,) = pt.Executor(pt.CPUPlace()).run(
        prog, feed={"ids": np.array([[1, 2, 3]], np.int32)},
        fetch_list=[out], scope=pt.Scope())
    assert res.dtype == np.int64
    np.testing.assert_array_equal(res, [[2, 3, 4]])


def test_dtypes_and_places():
    for name, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                      ("int64", torch.int64), ("int32", torch.int32),
                      ("bool", torch.bool)):
        assert core_types.dtype_to_torch(name) == tdt
        assert core_types.convert_dtype(tdt) == name
    assert core_types.convert_dtype(np.float32) == "float32"
    assert pt.CPUPlace().device == torch.device("cpu")
    assert pt.CUDAPlace(1).device == torch.device("cuda", 1)
    if torch.cuda.is_available():
        assert pt.default_place() == pt.CUDAPlace(0)
    else:
        # never a silent fall back to the CPU
        with pytest.raises(RuntimeError, match="CPUPlace"):
            pt.default_place()
        with pytest.raises(RuntimeError, match="CPUPlace"):
            pt.Executor()


def test_gate_flags_keep_the_jax_defaults():
    names = ("flash_attention", "attn_vmem_score_budget",
             "attn_decode_min_keys", "attn_flash_min_scores")
    for n in names:
        assert pflags.get(n) == jflags.get(n), n
    sig = dict(pflags.trace_signature())
    assert set(names) <= set(sig)
    pflags.set("attn_decode_min_keys", "64")
    try:
        assert pflags.get("attn_decode_min_keys") == 64
        assert dict(pflags.trace_signature())["attn_decode_min_keys"] == 64
    finally:
        pflags.reset("attn_decode_min_keys")
    assert pflags.get("attn_decode_min_keys") == 2048


def test_executor_mode_default_is_the_one_divergence():
    """`executor_mode` was once the one flag whose default differed from
    the JAX package's; now that a training step is captured on the card,
    both packages default to "jit", and an Executor built without a mode
    takes it."""
    assert pflags.get("executor_mode") == jflags.get("executor_mode") == "jit"
    assert pt.Executor(pt.CPUPlace()).mode == "jit"
    assert pt.Executor(pt.CPUPlace(), mode="interpret").mode == "interpret"


def test_load_params_checks_names_and_shapes():
    _, ps = _specs(8)
    progs = [ps.prefill_program, ps.step_program]
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(ps.prefill_startup, scope=scope)
    params = {n: scope.find_var(n).numpy() for n in scope.local_var_names()
              if "@" not in n and "_pos_" not in n}
    target = pt.Scope()
    convert.load_params(target, params, pt.CPUPlace(), progs)
    assert sorted(target.local_var_names()) == sorted(params)
    with pytest.raises(KeyError, match="not persistable"):
        convert.load_params(pt.Scope(), {**params, "nope": np.zeros(1)},
                            pt.CPUPlace(), progs)
    missing = dict(params)
    missing.pop("src_word_emb")
    with pytest.raises(KeyError, match="src_word_emb"):
        convert.load_params(pt.Scope(), missing, pt.CPUPlace(), progs)
    bad = dict(params)
    bad["src_word_emb"] = np.zeros((64, 64), np.float32)
    with pytest.raises(ValueError, match="src_word_emb"):
        convert.load_params(pt.Scope(), bad, pt.CPUPlace(), progs)


@pytest.mark.parametrize("kw", [dict(verify_len=2), dict(chunk_len=4)])
def test_later_slices_raise(kw):
    """The verify and chunk windows are ported: a window of 2 or more
    builds, and a width of 1 raises ValueError in both packages (a 1-wide
    window is the step program).  What is still a later slice raises
    NotImplementedError naming ROADMAP: MoE FFNs, and the int8 draft tier
    of build_draft (it waits for int8_ops, ROADMAP A4)."""
    kw1 = {k: 1 for k in kw}
    for T, cfg in ((PT, PT.TransformerConfig(**SMALL)),
                   (JT, JT.TransformerConfig(**SMALL))):
        spec = T.build_decode(cfg, src_len=128, prefix_len=8, max_len=256,
                              **kw)
        width = next(iter(kw.values()))
        which = "verify" if "verify_len" in kw else "chunk"
        assert getattr(spec, which + "_len") == width
        assert getattr(spec, which + "_program") is not None
        with pytest.raises(ValueError, match=which):
            T.build_decode(cfg, src_len=128, prefix_len=8, max_len=256,
                           **kw1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PT.build_decode(PT.TransformerConfig(moe_experts=4, **SMALL),
                        src_len=128, prefix_len=8, max_len=256)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PT.build_draft(PT.TransformerConfig(**SMALL), src_len=128,
                       prefix_len=8, max_len=256, tier="int8",
                       scope=pt.Scope())
