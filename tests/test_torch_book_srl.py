"""The book's label-semantic-roles chapter in the port and the JAX
package, on the CPU at test scale, in two forms:

  (a) tests/book/test_label_semantic_roles.py's: embeddings mixed by an
      fc, `layers.lstm` (fused_lstm) layers of alternating direction, an
      emission fc, linear_chain_crf, SGD at 0.1, crf_decoding;
  (b) the reference chapter's db_lstm, with Fluid's dynamic_lstm as fc +
      the raw `lstm` op (SeqLen; candidate relu, gate and cell sigmoid,
      peepholes in a [1, 7D] bias): eight feature slots (the word and five
      context words share one table `emb`, not trained, set from a seeded
      uniform(-0.1, 0.1) draw; the predicate; the mark), an fc of
      hidden_dim each, `sums`, alternating-direction fc-sum + lstm layers,
      a two-fc emission, linear_chain_crf with `crfw` at
      ParamAttr(learning_rate=1e-3) (both packages apply it), SGD at 0.01.

Each form is built in both packages (the same program dict), the JAX
startup's weights are carried into the port (`convert.load_params`),
and 15 SGD steps give losses within rtol 2e-4 of the JAX package's; the
decoded paths after training are equal.  Then each package saves the
decode graph (`save_inference_model`), and each package's Predictor
serves both directories with the paths of the in-process decode.
"""

import importlib

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, inference, testing

from torch_op_parity import BOTH, build_program, normalized_ints

WORD_DICT, PRED_DICT, MARK_DICT, LABEL_DICT = 60, 20, 2, 9
T, BATCH, STEPS = 6, 8, 15
# form (a): tests/book/test_label_semantic_roles.py's widths
EMB, HIDDEN, DEPTH_A = 8, 16, 2
# form (b): the reference's word_dim 32, mark_dim 5, hidden_dim 512 and
# depth 8, cut to test scale
WORD_DIM, MARK_DIM, HIDDEN_DIM, DEPTH_B = 8, 3, 16, 4
SLOTS = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
         "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data"]


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _db_lstm_a(pkg):
    L = pkg.layers
    word, pred, mark = (L.data(name=n, shape=[T], dtype="int64")
                        for n in ("word_data", "verb_data", "mark_data"))
    embs = [L.embedding(input=v, size=[n, EMB],
                        param_attr=pkg.ParamAttr(name=pn))
            for v, n, pn in ((word, WORD_DICT, "word_emb"),
                             (pred, PRED_DICT, "pred_emb"),
                             (mark, MARK_DICT, "mark_emb"))]
    seq = L.fc(input=L.concat(embs, axis=2), size=HIDDEN, act="tanh",
               num_flatten_dims=2, param_attr=pkg.ParamAttr(name="mix_fc"))
    for d in range(DEPTH_A):
        seq, _, _ = L.lstm(seq, HIDDEN, is_reverse=bool(d % 2),
                           param_attr=pkg.ParamAttr(name=f"lstm{d}"))
    return L.fc(input=seq, size=LABEL_DICT, num_flatten_dims=2,
                param_attr=pkg.ParamAttr(name="emission_fc"))


def dynamic_lstm(pkg, input, size, seq_len, is_reverse=False):
    """Fluid's dynamic_lstm on a projected input [B, T, size]: Weight
    [D, 4D], Bias [1, 7D] (use_peepholes), the chapter's activations."""
    helper = importlib.import_module(
        pkg.__name__ + ".layer_helper").LayerHelper("lstm")
    d = size // 4
    w = helper.create_parameter(attr=None, shape=[d, size], dtype="float32")
    b = helper.create_parameter(attr=None, shape=[1, 7 * d],
                                dtype="float32", is_bias=True)
    hidden, cell = (helper.create_variable_for_type_inference("float32")
                    for _ in range(2))
    helper.append_op(
        type="lstm",
        inputs={"Input": [input], "Weight": [w], "Bias": [b],
                "SeqLen": [seq_len]},
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": True, "is_reverse": is_reverse,
               "gate_activation": "sigmoid", "cell_activation": "sigmoid",
               "candidate_activation": "relu"})
    return hidden


def _db_lstm_b(pkg):
    L = pkg.layers
    feats = {n: L.data(name=n, shape=[T], dtype="int64") for n in SLOTS}
    seq_len = L.data(name="seq_len", shape=[], dtype="int64")
    embs = [L.embedding(input=feats[n], size=[WORD_DICT, WORD_DIM],
                        param_attr=pkg.ParamAttr(name="emb",
                                                 trainable=False))
            for n in SLOTS[:6]]
    embs.append(L.embedding(input=feats["verb_data"],
                            size=[PRED_DICT, WORD_DIM], param_attr="vemb"))
    embs.append(L.embedding(input=feats["mark_data"],
                            size=[MARK_DICT, MARK_DIM]))
    hidden_0 = L.sums([L.fc(input=e, size=HIDDEN_DIM, act="tanh",
                            num_flatten_dims=2) for e in embs])
    inputs = [hidden_0, dynamic_lstm(pkg, hidden_0, HIDDEN_DIM, seq_len)]
    for i in range(1, DEPTH_B):
        mix = L.sums([L.fc(input=x, size=HIDDEN_DIM, act="tanh",
                           num_flatten_dims=2) for x in inputs])
        inputs = [mix, dynamic_lstm(pkg, mix, HIDDEN_DIM, seq_len,
                                    is_reverse=i % 2 == 1)]
    return L.sums([L.fc(input=x, size=LABEL_DICT, act="tanh",
                        num_flatten_dims=2) for x in inputs])


def _chapter(form):
    def build(pkg):
        L = pkg.layers
        emission = _db_lstm_a(pkg) if form == "a" else _db_lstm_b(pkg)
        label = L.data(name="target", shape=[T], dtype="int64")
        seq_len = pkg.default_main_program().global_block().var("seq_len") \
            if form == "b" else L.data(name="seq_len", shape=[], dtype="int64")
        crf_attr = (pkg.ParamAttr(name="crfw") if form == "a"
                    else pkg.ParamAttr(name="crfw", learning_rate=1e-3))
        loss = L.mean(L.linear_chain_crf(input=emission, label=label,
                                         param_attr=crf_attr,
                                         seq_len=seq_len))
        pkg.optimizer.SGD(learning_rate=0.1 if form == "a" else 0.01) \
            .minimize(loss)
        decoded = L.crf_decoding(input=emission, param_attr="crfw",
                                 seq_len=seq_len)
        return loss, decoded
    return build


def _feed(form):
    rng = np.random.RandomState(3)
    names = (SLOTS[:1] + SLOTS[6:]) if form == "a" else SLOTS
    feed = {}
    for n in names:
        size = {"verb_data": PRED_DICT, "mark_data": MARK_DICT}.get(
            n, WORD_DICT)
        feed[n] = rng.randint(0, size, (BATCH, T)).astype(np.int64)
    feed["target"] = rng.randint(0, LABEL_DICT, (BATCH, T)).astype(np.int64)
    feed["seq_len"] = rng.randint(2, T + 1, (BATCH,)).astype(np.int64)
    return feed


def _decode_feed(form, feed):
    return {k: v for k, v in feed.items() if k != "target"}


@pytest.mark.parametrize("form", ["a", "b"])
def test_srl_trains_decodes_and_serves_as_jax(form, tmp_path):
    (jm, js, (jloss, jdec)), (pm, ps, (ploss, pdec)) = (
        build_program(pkg, g, _chapter(form), seed=37) for pkg, g in BOTH)
    assert normalized_ints(pm) == normalized_ints(jm)
    assert normalized_ints(ps) == normalized_ints(js)
    feed = _feed(form)
    jscope, jexe = JScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    if form == "b":     # the chapter's pretrained table
        jscope.set_var("emb", np.random.RandomState(5).uniform(
            -0.1, 0.1, (WORD_DICT, WORD_DIM)).astype(np.float32))
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    convert.load_params(pscope, {v.name: np.asarray(jscope.find_var(v.name))
                                 for v in js.list_vars() if v.persistable},
                        pt.CPUPlace(), [pm])
    want, got = [], []
    for _ in range(STEPS):
        want.append(float(np.asarray(jexe.run(
            jm, feed=feed, fetch_list=[jloss], scope=jscope)[0]).reshape(())))
        got.append(float(pexe.run(pm, feed=feed, fetch_list=[ploss],
                                  scope=pscope)[0].reshape(())))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]

    # the test clones keep the CRF cost, which reads `target`; the saved
    # decode graphs below are pruned to the decode
    dfeed = _decode_feed(form, feed)
    jtest, ptest = jm.clone(for_test=True), pm.clone(for_test=True)
    jpath = np.asarray(jexe.run(jtest, feed=feed, fetch_list=[jdec],
                                scope=jscope)[0])
    ppath = pexe.run(ptest, feed=feed, fetch_list=[pdec], scope=pscope)[0]
    np.testing.assert_array_equal(ppath, jpath)
    assert (ppath[np.arange(T) >= feed["seq_len"][:, None]] == 0).all()

    names = sorted(dfeed)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jscope_guard(jscope):
        fluid.io.save_inference_model(jdir, names, [jdec], jexe,
                                      main_program=jm)
    with pt.scope_guard(pscope):
        pt.io.save_inference_model(pdir, names, [pdec], pexe,
                                   main_program=pm)
    for d in (jdir, pdir):
        (served,) = inference.create_predictor(inference.Config(
            d, place=pt.CPUPlace())).run(dfeed)
        np.testing.assert_array_equal(served, ppath, err_msg=d)
        (jserved,) = jinference.create_predictor(
            jinference.Config(d)).run(dfeed)
        np.testing.assert_array_equal(np.asarray(jserved), jpath, err_msg=d)
