"""The sequence family, LoD and the fused beam decode in the port against
the JAX package's, on the CPU at tiny sizes.

  * lod.py: every function of its `__all__` gives the JAX package's
    arrays;
  * the 14 sequence ops and lod_reset: every output within 1e-5 (integer
    outputs equal) of the JAX lowering's on ragged inputs (the JAX
    package's OpTest cases, tests/test_ops_sequence_tail.py, and seeded
    ones);
  * their grads: the port's against central differences of its own
    forward in float64 (the JAX package's `check_grad` of six of them
    fails on this CPU, ROADMAP C1), and, through `append_backward` and
    both Executors, against the JAX package's grads (rtol 1e-4);
  * the 13 sequence builders and `nets.sequence_conv_pool`: the JAX
    package's programs, and its values from its startup's weights;
  * beam_search_decode: at beam 1 the argmax chain
    (tests/test_inference.py:11-65); over a cached-attention LM
    (tests/test_decode.py:273-326) at beams 1 and 3 the JAX package's ids
    and scores within 1e-5, each beam re-scored by a plain numpy forward;
    a While loop composing `beam_search` (tests/test_beam_search_step.py:
    142) as the JAX package's.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import lod as jlod
import paddle_tpu_torch as pt
from paddle_tpu_torch import lod as plod
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import registry as preg

import test_ops_sequence_tail as jtail
from torch_op_parity import (
    assert_forward,
    assert_grads,
    assert_steps_close,
    optest_case,
    run_programs_both,
)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


# ------------------------------------------------------------------ lod.py


def _leaves(x):
    if isinstance(x, (tuple, list)):
        for y in x:
            yield from _leaves(y)
    else:
        yield np.asarray(x)


def test_lod_helpers_are_the_jax_packages():
    assert plod.__all__ == jlod.__all__
    seqs = [np.arange(3) + 1, np.arange(5) + 7, np.arange(1) + 2]
    for kw in ({}, {"max_len": 4, "pad_value": -1}, {"time_major": True}):
        (pp, pl), (jp, jl) = plod.pack_batch(seqs, **kw), \
            jlod.pack_batch(seqs, **kw)
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(pl, jl)
        tm = kw.get("time_major", False)
        for a, b in zip(plod.unpack_batch(pp, pl, tm),
                        jlod.unpack_batch(jp, jl, tm)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(plod.lod_to_lengths([0, 2, 5, 9]),
                                  jlod.lod_to_lengths([0, 2, 5, 9]))
    np.testing.assert_array_equal(plod.lengths_to_lod([2, 3, 4]),
                                  jlod.lengths_to_lod([2, 3, 4]))
    np.testing.assert_array_equal(plod.sequence_mask_np([1, 3], 4),
                                  jlod.sequence_mask_np([1, 3], 4))
    rng = np.random.RandomState(0)
    data = [list(range(rng.randint(1, 20))) for _ in range(50)]
    pairs = [(list(range(n)), [n % 3]) for n in rng.randint(1, 9, 20)]
    for items, kw in ((data, {}), (pairs, {"seq_cols": [0]})):
        got = list(plod.bucket_by_length(lambda: iter(items), [4, 8, 16], 4,
                                         **kw)())
        want = list(jlod.bucket_by_length(lambda: iter(items), [4, 8, 16], 4,
                                          **kw)())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            gl, wl = list(_leaves(g)), list(_leaves(w))
            assert len(gl) == len(wl)
            for a, b in zip(gl, wl):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    rows = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10]]
    for a, b in zip(plod.pack_into_rows(rows, 8, eos=0),
                    jlod.pack_into_rows(rows, 8, eos=0)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- ops


def _seq_cases():
    """op type -> (inputs, attrs, out_names, differentiable params,
    float outputs read by the grad check)."""
    rng = np.random.RandomState(7)
    f32 = np.float32
    lens = np.asarray([5, 2, 4], "int64")
    x3 = rng.randn(3, 5, 2).astype(f32)
    cases = {}
    for cls, op, outs in ((jtail.TestSequenceReverseRagged,
                           "sequence_reverse", {"Y": 1}),
                          (jtail.TestSequenceSlice, "sequence_slice",
                           {"Out": 1}),
                          (jtail.TestSequencePad, "sequence_pad",
                           {"Out": 1}),
                          (jtail.TestSequenceUnpad, "sequence_unpad",
                           {"Out": 1}),
                          (jtail.TestSequenceConcat, "sequence_concat",
                           {"Out": 1}),
                          (jtail.TestSequenceExpand, "sequence_expand",
                           {"Out": 1})):
        inputs, attrs = optest_case(cls)
        cases[op] = (inputs, attrs, ["X"], outs)
    cases["sequence_conv"] = (
        {"X": [rng.randn(3, 5, 4).astype(f32)], "SeqLen": [lens],
         "Filter": [rng.randn(12, 6).astype(f32)]},
        {"contextLength": 3, "contextStart": -1, "contextStride": 1},
        ["X", "Filter"], {"Out": 1})
    cases["sequence_softmax"] = ({"X": [rng.randn(3, 5).astype(f32)],
                                  "SeqLen": [lens]}, {}, ["X"], {"Out": 1})
    cases["sequence_expand_as"] = (
        {"X": [rng.randn(3, 2).astype(f32)], "Y": [x3],
         "SeqLen": [lens]}, {}, ["X"], {"Out": 1})
    cases["sequence_reshape"] = (
        {"X": [rng.randn(3, 4, 6).astype(f32)],
         "SeqLen": [np.asarray([4, 2, 3], "int64")]}, {"new_dim": 3},
        ["X"], {"Out": 1})
    cases["lod_reset"] = ({"X": [x3], "Y": [lens]}, {}, ["X"], {"Out": 1})
    # the ops without a grad
    cases["sequence_mask"] = ({"X": [lens]}, {"maxlen": 6,
                                              "out_dtype": "int64"}, [], {})
    ids = rng.randint(0, 9, (3, 6)).astype("int64")
    ids[0, 1] = ids[1, 0] = 3
    cases["sequence_enumerate"] = ({"X": [ids], "SeqLen": [lens]},
                                   {"win_size": 3, "pad_value": -1}, [], {})
    cases["sequence_erase"] = ({"X": [ids], "SeqLen": [lens]},
                               {"tokens": [3, 5]}, [], {})
    cases["sequence_scatter"] = (
        {"X": [rng.randn(3, 6).astype(f32)],
         "Ids": [np.asarray([[0, 2, 2], [5, 1, 0], [3, 4, 7]], "int64")],
         "Updates": [rng.randn(3, 3).astype(f32)],
         "SeqLen": [np.asarray([3, 2, 3], "int64")]}, {}, [], {})
    return cases


CASES = _seq_cases()
OUT_NAMES = {"sequence_pad": {"Out": ["o"], "Length": ["l"]},
             "sequence_concat": {"Out": ["o"], "OutLen": ["l"]},
             "sequence_erase": {"Out": ["o"], "OutLen": ["l"]},
             "sequence_reshape": {"Out": ["o"], "OutLen": ["l"]},
             "lod_reset": {"Out": ["o"], "OutLen": ["l"]}}
NEW_OPS = sorted(CASES)


def test_the_slice_registers_its_sequence_ops():
    assert len(NEW_OPS) == 15
    assert all(preg.is_registered(t) for t in NEW_OPS)


@pytest.mark.parametrize("op_type", NEW_OPS)
def test_sequence_op_forward_as_jax(op_type):
    inputs, attrs, _, _ = CASES[op_type]
    assert_forward(op_type, inputs, attrs, OUT_NAMES.get(op_type))


def test_lod_reset_from_target_lod_as_jax():
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    assert_forward("lod_reset", {"X": [x]}, {"target_lod": [0, 1, 3, 4]},
                   {"Out": ["o"], "OutLen": ["l"]})


GRAD_OPS = [t for t in NEW_OPS if CASES[t][2]]


def _port_grad(op_type, inputs, attrs, diff, outs, cots):
    """The port's `<op>_grad` lowering on float64 inputs -> {param: [grad]}."""
    info = preg.get_runtime_info(op_type + "_grad")
    fwd = {p: [torch.as_tensor(a) for a in arrs] for p, arrs in inputs.items()}
    out_names = {p: [f"o{i}" for i in range(n)] for p, n in outs.items()}
    res = preg.run_forward(preg.get_op_info(op_type), fwd, dict(attrs),
                           out_names=out_names)
    g_in = dict(fwd)
    for p in outs:
        g_in[p] = res[p]
        g_in[p + "@GRAD"] = [torch.as_tensor(c) for c in cots[p]]
    names = {p + "@GRAD": [f"g{i}" for i in range(len(inputs[p]))]
             for p in diff}
    return preg.run_forward(info, g_in, dict(attrs), out_names=names)


@pytest.mark.parametrize("op_type", GRAD_OPS)
def test_sequence_op_grad_against_central_differences(op_type):
    inputs, attrs, diff, outs = CASES[op_type]
    rng = np.random.RandomState(11)
    x64 = {p: [a.astype(np.float64) if a.dtype.kind == "f" else a
               for a in arrs] for p, arrs in inputs.items()}
    info = preg.get_op_info(op_type)
    out_names = {p: [f"o{i}" for i in range(n)] for p, n in outs.items()}

    def run(ins):
        t = {p: [torch.as_tensor(a) for a in arrs] for p, arrs in ins.items()}
        return preg.run_forward(info, t, dict(attrs), out_names=out_names)

    base = run(x64)
    cots = {p: [rng.standard_normal(tuple(o.shape)) for o in base[p]]
            for p in outs}

    def loss(ins):
        r = run(ins)
        return sum(float((r[p][i].numpy() * cots[p][i]).sum())
                   for p in outs for i in range(outs[p]))

    grads = _port_grad(op_type, x64, attrs, diff, outs, cots)
    eps = 1e-6
    for p in diff:
        for i, a in enumerate(x64[p]):
            num = np.zeros_like(a)
            for idx in np.ndindex(a.shape):
                for sgn in (1, -1):
                    b = a.copy()
                    b[idx] += sgn * eps
                    ins = dict(x64)
                    ins[p] = list(x64[p])
                    ins[p][i] = b
                    num[idx] += sgn * loss(ins) / (2 * eps)
            got = grads[p + "@GRAD"][i].numpy()
            np.testing.assert_allclose(got, num, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{op_type}: {p}[{i}]")


@pytest.mark.parametrize("op_type", GRAD_OPS)
def test_sequence_op_grad_as_jax(op_type):
    inputs, attrs, diff, outs = CASES[op_type]
    assert_grads(op_type, inputs, attrs, diff, outs)


# ------------------------------------------------------------ the builders

T, D = 6, 4


def _builder(name):
    def fn(pkg):
        L = pkg.layers
        x = L.data("x", shape=[T, D], dtype="float32")
        x.stop_gradient = False
        lens = L.data("lens", shape=[], dtype="int64")
        if name == "sequence_conv":
            out = L.sequence_conv(x, num_filters=3, filter_size=3,
                                  seq_len=lens, act="tanh")
        elif name == "sequence_first_step":
            out = L.sequence_first_step(x, seq_len=lens)
        elif name == "sequence_softmax":
            out = L.sequence_softmax(L.reduce_sum(x, dim=[2]), seq_len=lens)
        elif name == "sequence_expand":
            out = L.sequence_expand(L.reduce_sum(x, dim=[1]), x,
                                    seq_len=lens)
        elif name == "sequence_expand_as":
            out = L.sequence_expand_as(L.reduce_sum(x, dim=[1]), x,
                                       seq_len=lens)
        elif name == "sequence_reverse":
            out = L.sequence_reverse(x, seq_len=lens)
        elif name == "sequence_slice":
            off = L.data("off", shape=[], dtype="int64")
            out = L.sequence_slice(x, off, lens)
        elif name == "sequence_mask":
            out = L.sequence_mask(lens, maxlen=T)
        elif name == "sequence_pad":
            pv = L.fill_constant(shape=[1], dtype="float32", value=0.5)
            out, _ = L.sequence_pad(x, pad_value=pv, maxlen=T + 2,
                                    seq_len=lens)
        elif name == "sequence_unpad":
            out = L.sequence_unpad(x, lens)
        elif name == "sequence_concat":
            out = L.sequence_concat([x, L.scale(x, scale=2.0)],
                                    seq_lens=[lens, lens])
        elif name == "sequence_enumerate":
            ids = L.data("ids", shape=[T], dtype="int64")
            out = L.sequence_enumerate(ids, win_size=2, seq_len=lens)
        elif name == "sequence_erase":
            ids = L.data("ids", shape=[T], dtype="int64")
            out, _ = L.sequence_erase(ids, tokens=[2], seq_len=lens)
        else:   # nets.sequence_conv_pool
            out = pkg.nets.sequence_conv_pool(x, num_filters=3,
                                              filter_size=3, seq_len=lens,
                                              act="tanh")
        fetch = [out.name]
        if out.dtype == "float32":
            loss = L.reduce_sum(out)
            pkg.backward.append_backward(loss)
            fetch.append("x@GRAD")
        return fetch

    return fn


BUILDERS = ["sequence_conv", "sequence_first_step", "sequence_softmax",
            "sequence_expand", "sequence_expand_as", "sequence_reverse",
            "sequence_slice", "sequence_mask", "sequence_pad",
            "sequence_unpad", "sequence_concat", "sequence_enumerate",
            "sequence_erase", "sequence_conv_pool"]


@pytest.mark.parametrize("name", BUILDERS)
def test_sequence_builder_as_jax(name):
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(3, T, D).astype(np.float32),
            "lens": np.asarray([6, 2, 4], "int64"),
            "off": np.asarray([1, 0, 2], "int64"),
            "ids": rng.randint(0, 4, (3, T)).astype("int64")}
    want, got = run_programs_both(_builder(name), feed, lambda o: o)
    assert_steps_close(got, want)


# ------------------------------------------------------- beam_search_decode


def _greedy_decoder(pkg, V=20, K=1, L_=5):
    rng = np.random.RandomState(0)
    w_np = rng.rand(8, V).astype("float32")
    emb_np = rng.rand(V, 8).astype("float32")
    L = pkg.layers
    init = pkg.initializer.NumpyArrayInitializer
    L.create_parameter(shape=[V, 8], dtype="float32", name="dec_emb",
                       default_initializer=init(emb_np))
    L.create_parameter(shape=[8, V], dtype="float32", name="dec_w",
                       default_initializer=init(w_np))
    dec = L.BeamSearchDecoder(beam_size=K, max_len=L_, bos_id=0,
                              eos_id=V + 1)
    with dec.block():
        prev = dec.prev_ids()
        blk = pkg.default_main_program().current_block()
        e = blk.create_var(name="e", dtype="float32")
        blk.append_op(type="lookup_table",
                      inputs={"W": [blk._var_recursive("dec_emb")],
                              "Ids": [prev]},
                      outputs={"Out": [e]},
                      attrs={"strip_trailing_one": False}, infer_shape=False)
        logits = blk.create_var(name="logits", dtype="float32")
        blk.append_op(type="matmul",
                      inputs={"X": [e], "Y": [blk._var_recursive("dec_w")]},
                      outputs={"Out": [logits]}, infer_shape=False)
        dec.set_logits(blk.var("logits"))
    ids, scores = dec()
    return [ids, scores], (emb_np, w_np)


@pytest.mark.parametrize("mode", ["jit", "interpret"])
def test_beam_one_is_the_argmax_chain(mode):
    want, got = run_programs_both(lambda pkg: _greedy_decoder(pkg)[0], {},
                                  lambda o: o, mode=mode)
    _, (emb_np, w_np) = _greedy_decoder(pt)
    tok, expect = 0, []
    for _ in range(5):
        tok = int(np.argmax(emb_np[tok] @ w_np))
        expect.append(tok)
    np.testing.assert_array_equal(got[0][0].reshape(-1), expect)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=0, atol=1e-5)


def _beam_lm(K, V=30, d=8, L_=6, B=2):
    """tests/test_decode.py:_build_beam_lm's program: one attention layer
    over a KV cache carried (and reordered) as decoder state."""

    def fn(pkg):
        L = pkg.layers
        L.create_parameter(
            shape=[V, d], dtype="float32", name="lm_emb",
            default_initializer=pkg.initializer.NumpyArrayInitializer(
                np.random.RandomState(1).randn(V, d).astype("float32")))
        cache0 = L.fill_constant(shape=[B * K, L_, d], value=0.0,
                                 dtype="float32")
        len0 = L.fill_constant(shape=[B * K], value=0, dtype="int64")
        dec = L.BeamSearchDecoder(beam_size=K, max_len=L_, bos_id=0,
                                  eos_id=V + 5, batch_size=B)
        with dec.block():
            prev = dec.prev_ids()
            ck, cv, ln = dec.memory(cache0), dec.memory(cache0), \
                dec.memory(len0)
            blk = pkg.default_main_program().current_block()
            e = blk.create_var(name="e", shape=(-1, d), dtype="float32")
            blk.append_op(type="lookup_table",
                          inputs={"W": [blk._var_recursive("lm_emb")],
                                  "Ids": [prev]},
                          outputs={"Out": [e]},
                          attrs={"strip_trailing_one": False},
                          infer_shape=False)
            x = L.reshape(blk.var("e"), shape=[-1, 1, d])
            q, k, v = (L.fc(input=x, size=d, num_flatten_dims=2,
                            bias_attr=False, name=n)
                       for n in ("lm_q", "lm_k", "lm_v"))
            ok, ov = L.kv_cache_append(ck, cv, k, v, ln)
            nl = L.increment(ln, value=1, in_place=False)
            att = L.fused_attention(q, ok, ov, 1, causal=False, seq_len=nl)
            lg = L.fc(input=L.reshape(att, shape=[-1, d]), size=V,
                      bias_attr=False, name="lm_out")
            dec.set_logits(lg)
            dec.update_memory(ck, ok)
            dec.update_memory(cv, ov)
            dec.update_memory(ln, nl)
        ids, scores = dec()
        return [ids, scores, "lm_emb", "lm_q.w_0", "lm_k.w_0", "lm_v.w_0",
                "lm_out.w_0"]

    return fn


def np_rescore(w, d, path):
    """A cache-free numpy forward re-scoring one token path
    (tests/test_decode.py:_np_rescore)."""
    tok, total, ks, vs = 0, 0.0, [], []
    for t in range(len(path)):
        x = w["lm_emb"][tok]
        q = x @ w["lm_q.w_0"]
        ks.append(x @ w["lm_k.w_0"])
        vs.append(x @ w["lm_v.w_0"])
        s = (q @ np.stack(ks).T) / np.sqrt(d)
        p = np.exp(s - s.max())
        p /= p.sum()
        lg = (p @ np.stack(vs)) @ w["lm_out.w_0"]
        lp = lg - (np.log(np.exp(lg - lg.max()).sum()) + lg.max())
        tok = int(path[t])
        total += lp[tok]
    return total


@pytest.mark.parametrize("K", [1, 3])
def test_beam_decode_over_a_carried_kv_cache_as_jax(K):
    want, got = run_programs_both(_beam_lm(K), {}, lambda o: o)
    ids, scores = got[0][0], got[0][1]
    np.testing.assert_array_equal(ids, want[0][0])
    np.testing.assert_allclose(scores, want[0][1], rtol=0, atol=1e-5)
    w = dict(zip(["lm_emb", "lm_q.w_0", "lm_k.w_0", "lm_v.w_0",
                  "lm_out.w_0"], got[0][2:]))
    for b in range(ids.shape[0]):
        for j in range(K):
            assert abs(np_rescore(w, 8, ids[b, j]) - scores[b, j]) < 1e-4
        assert (np.diff(scores[b]) <= 0).all()


def _while_beam(pkg):
    """tests/test_beam_search_step.py:142's user-built While decoder: a
    toy Markov logits table, beam_search each step."""
    B, BEAM, V, STEPS, END, bos = 2, 3, 12, 4, 0, 1
    table = np.random.RandomState(3).randn(V, V).astype("float32")
    logp = table - np.log(np.exp(table).sum(-1, keepdims=True))
    L = pkg.layers
    tbl = L.assign(logp)
    pre_ids = L.assign(np.full((B, BEAM), bos, "int64"))
    pre_scores = L.assign(np.zeros((B, BEAM), "float32"))
    step = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=STEPS)
    cond = L.less_than(x=step, y=limit)
    first = L.assign(np.ones((1,), "bool"))
    w = L.While(cond=cond)
    with w.block():
        rows = L.reshape(L.gather(tbl, L.reshape(pre_ids, shape=[B * BEAM])),
                         shape=[B, BEAM, V])
        acc = L.elementwise_add(rows,
                                L.reshape(pre_scores, shape=[B, BEAM, 1]))
        top_s, top_i = L.topk(acc, k=BEAM)
        sel_i, sel_s = L.beam_search(pre_ids, pre_scores, top_i, top_s,
                                     beam_size=BEAM, end_id=END,
                                     is_first_step=L.reshape(first,
                                                             shape=[]))
        L.assign(sel_i, pre_ids)
        L.assign(sel_s, pre_scores)
        L.assign(np.zeros((1,), "bool"), first)
        L.increment(step, in_place=True)
        L.less_than(x=step, y=limit, cond=cond)
    return [pre_ids, pre_scores]


def test_while_decoder_composing_beam_search_as_jax():
    want, got = run_programs_both(_while_beam, {}, lambda o: o)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=0, atol=1e-5)
