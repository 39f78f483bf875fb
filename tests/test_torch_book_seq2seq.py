"""The book's seq2seq chapters and its `while_loop` program in the port,
against the JAX package, on the CPU at the chapters' own tiny sizes.

  * machine translation (tests/book/test_machine_translation.py): the
    LSTM encoder, the DynamicRNN decoder trained with Adagrad and L2
    decay, then the BeamSearchDecoder program fed the trained weights
    through save_persistables / load_persistables: three losses within
    rtol 2e-4 of the JAX package's from its startup's weights, and the
    decode of the JAX package's trained weights equal to its own (ids
    equal, scores within 1e-5);
  * the RNN encoder-decoder (tests/book/test_rnn_encoder_decoder.py): a
    bi-LSTM encoder and a DynamicRNN of fc-gate LSTM steps, three losses
    within rtol 2e-4, then save_inference_model -> load_inference_model
    -> the same predictions as the test clone;
  * `tests/book/_programs/while_loop.*.json`: the port reads them (s =
    45), and the program built in each package and saved by each with
    save_inference_model gives the same files byte for byte; each
    package loads the other's directory and runs it;
  * a BeamSearchDecoder program saved and served through the port's
    Predictor at beam 1 is the greedy argmax chain.
"""

import filecmp
import json
import os
import pathlib

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework.scope import Scope as JScope
import paddle_tpu_torch as pt
from paddle_tpu_torch import inference, testing

from torch_op_parity import BOTH, run_programs_both, assert_steps_close

BOOK = pathlib.Path(__file__).parent / "book" / "_programs"


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


# ------------------------------------------------------ machine translation

DICT_SIZE, WORD_DIM, HIDDEN = 48, 8, 16
T, BATCH = 6, 4
BEAM, MAX_LEN, BOS, EOS = 2, 5, 0, 1


def _encoder(pkg):
    L = pkg.layers
    src = L.data(name="src_word_id", shape=[T], dtype="int64")
    src_len = L.data(name="src_len", shape=[], dtype="int64")
    emb = L.embedding(input=src, size=[DICT_SIZE, WORD_DIM],
                      param_attr=pkg.ParamAttr(name="vemb"))
    seq, _, _ = L.lstm(emb, HIDDEN, param_attr=pkg.ParamAttr(name="enc_lstm"))
    return L.sequence_last_step(seq, seq_len=src_len)


def _decoder_step(pkg, word, prev):
    L = pkg.layers
    state = L.fc(input=[word, prev], size=HIDDEN, act="tanh",
                 param_attr=[pkg.ParamAttr(name="dec_state_w"),
                             pkg.ParamAttr(name="dec_state_u")],
                 bias_attr=pkg.ParamAttr(name="dec_state_b"))
    score = L.fc(input=state, size=DICT_SIZE, act="softmax",
                 param_attr=pkg.ParamAttr(name="dec_out_w"),
                 bias_attr=pkg.ParamAttr(name="dec_out_b"))
    return state, score


def mt_train(pkg):
    """The chapter's `_build_train` with its Adagrad + L2 decay."""
    L = pkg.layers
    context = _encoder(pkg)
    trg = L.data(name="trg_word_id", shape=[T], dtype="int64")
    trg_len = L.data(name="trg_len", shape=[], dtype="int64")
    emb = L.embedding(input=trg, size=[DICT_SIZE, WORD_DIM],
                      param_attr=pkg.ParamAttr(name="trg_emb"))
    drnn = L.DynamicRNN()
    with drnn.block():
        word = drnn.step_input(emb, seq_len=trg_len)
        prev = drnn.memory(init=context)
        state, score = _decoder_step(pkg, word, prev)
        drnn.update_memory(prev, state)
        drnn.output(score)
    label = L.data(name="trg_next_word", shape=[T], dtype="int64")
    ce = L.cross_entropy(input=L.reshape(drnn(), shape=[-1, DICT_SIZE]),
                         label=L.reshape(label, shape=[-1, 1]))
    mask = L.reshape(L.cast(L.sequence_mask(trg_len, T), "float32"),
                     shape=[-1, 1])
    loss = L.elementwise_div(L.reduce_sum(L.elementwise_mul(ce, mask)),
                             L.reduce_sum(mask))
    pkg.optimizer.Adagrad(
        learning_rate=0.5,
        regularization=pkg.regularizer.L2DecayRegularizer(1e-4),
    ).minimize(loss)
    return [loss]


def mt_infer(pkg, batch=BATCH, beam=BEAM, max_len=MAX_LEN):
    """The chapter's `_build_infer`: the encoder context tiled to B*K,
    decoded by a BeamSearchDecoder carrying the decoder state."""
    L = pkg.layers
    context = _encoder(pkg)
    tiled = L.reshape(L.expand(L.reshape(context, shape=[-1, 1, HIDDEN]),
                               expand_times=[1, beam, 1]),
                      shape=[-1, HIDDEN])
    dec = L.BeamSearchDecoder(beam_size=beam, max_len=max_len, bos_id=BOS,
                              eos_id=EOS, batch_size=batch)
    with dec.block():
        prev_ids = dec.prev_ids()
        prev_state = dec.memory(init=tiled)
        word = L.embedding(input=prev_ids, size=[DICT_SIZE, WORD_DIM],
                           param_attr=pkg.ParamAttr(name="trg_emb"))
        state, score = _decoder_step(pkg, word, prev_state)
        dec.update_memory(prev_state, state)
        dec.set_logits(L.log(score))
    return list(dec())


def mt_batch(rng):
    src = rng.randint(2, DICT_SIZE, size=(BATCH, T)).astype("int64")
    src_len = rng.randint(2, T + 1, size=(BATCH,)).astype("int64")
    trg = np.roll(src, 1, axis=1)
    trg[:, 0] = BOS
    return {"src_word_id": src, "src_len": src_len, "trg_word_id": trg,
            "trg_len": src_len, "trg_next_word": src.copy()}


def _trained(pkg, fn, feed, steps, seed, path, jax_weights=None):
    """Train `fn` `steps` times in `pkg` (the port from `jax_weights`)
    and save its persistables to `path` -> (the losses, the weights it
    started from)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    guard = dict(BOTH)[pkg]
    with pkg.program_guard(main, startup), guard():
        (loss,) = fn(pkg)
    if pkg is fluid:
        scope, exe = JScope(), fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        start = {v.name: np.asarray(scope.find_var(v.name))
                 for v in startup.list_vars() if v.persistable}
    else:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        pt.convert.load_params(scope, jax_weights, pt.CPUPlace(), [main])
        start = jax_weights
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(steps)]
    with _scoped(pkg, scope):
        pkg.io.save_persistables(exe, path, main_program=main)
    return losses, start


def _scoped(pkg, scope):
    if pkg is fluid:
        from paddle_tpu.framework.scope import scope_guard
    else:
        from paddle_tpu_torch.framework.scope import scope_guard
    return scope_guard(scope)


def _decode(pkg, path, feed, fn=mt_infer):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 17
    with pkg.program_guard(main, startup), dict(BOTH)[pkg]():
        ids, scores = fn(pkg)
    if pkg is fluid:
        scope, exe = JScope(), fluid.Executor(fluid.CPUPlace())
    else:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    with _scoped(pkg, scope):
        pkg.io.load_persistables(exe, path, main_program=main)
    got = exe.run(main, feed={k: feed[k] for k in ("src_word_id",
                                                   "src_len")},
                  fetch_list=[ids, scores], scope=scope)
    return [np.asarray(a) for a in got]


def test_machine_translation_trains_and_beam_decodes_as_jax(tmp_path):
    feed = mt_batch(np.random.RandomState(0))
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    want, jstart = _trained(fluid, mt_train, feed, 3, 17, jpath)
    # the port starts from the JAX startup's weights (before training)
    got, _ = _trained(pt, mt_train, feed, 3, 17, ppath, jstart)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
    # the JAX package's trained weights, decoded by both
    jids, jscores = _decode(fluid, jpath, feed)
    pids, pscores = _decode(pt, jpath, feed)
    assert pids.shape == (BATCH, BEAM, MAX_LEN)
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_allclose(pscores, jscores, rtol=0, atol=1e-5)
    # the port's own trained weights decode to finite, best-first beams
    ids, scores = _decode(pt, ppath, feed)
    assert np.isfinite(scores).all()
    assert (scores[:, 0] >= scores[:, -1] - 1e-6).all()
    assert ids.min() >= 0 and ids.max() < DICT_SIZE


# ---------------------------------------------------- RNN encoder-decoder

RD_DICT, RD_DIM, RD_HIDDEN, RD_T = 40, 8, 12, 5


def _lstm_step(pkg, x_t, h_prev, c_prev):
    L = pkg.layers

    def gate(suffix, act):
        return L.fc(input=[x_t, h_prev], size=RD_HIDDEN, act=act,
                    param_attr=[pkg.ParamAttr(name=f"dec_{suffix}_x"),
                                pkg.ParamAttr(name=f"dec_{suffix}_h")],
                    bias_attr=pkg.ParamAttr(name=f"dec_{suffix}_b"))

    f, i, o, g = (gate("f", "sigmoid"), gate("i", "sigmoid"),
                  gate("o", "sigmoid"), gate("g", "tanh"))
    c = L.elementwise_add(L.elementwise_mul(f, c_prev),
                          L.elementwise_mul(i, g))
    return L.elementwise_mul(o, L.tanh(c)), c


def rnn_encoder_decoder(pkg):
    """The chapter's `_seq_to_seq_net` + `_loss_over` + Adagrad."""
    L = pkg.layers
    src = L.data(name="src_word_id", shape=[RD_T], dtype="int64")
    src_len = L.data(name="src_len", shape=[], dtype="int64")
    src_emb = L.embedding(input=src, size=[RD_DICT, RD_DIM],
                          param_attr=pkg.ParamAttr(name="src_emb"))
    fwd, _, _ = L.lstm(src_emb, RD_HIDDEN,
                       param_attr=pkg.ParamAttr(name="enc_fw"))
    bwd, _, _ = L.lstm(src_emb, RD_HIDDEN, is_reverse=True,
                       param_attr=pkg.ParamAttr(name="enc_bw"))
    context = L.concat([L.sequence_last_step(fwd, seq_len=src_len),
                        L.sequence_first_step(bwd)], axis=1)
    boot = L.fc(input=context, size=RD_HIDDEN, act="tanh",
                param_attr=pkg.ParamAttr(name="boot_w"))
    trg = L.data(name="trg_word_id", shape=[RD_T], dtype="int64")
    trg_len = L.data(name="trg_len", shape=[], dtype="int64")
    trg_emb = L.embedding(input=trg, size=[RD_DICT, RD_DIM],
                          param_attr=pkg.ParamAttr(name="trg_emb"))
    drnn = L.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(trg_emb, seq_len=trg_len)
        h = drnn.memory(init=boot)
        c = drnn.memory(shape=[RD_HIDDEN], batch_ref=x_t)
        h2, c2 = _lstm_step(pkg, x_t, h, c)
        pred = L.fc(input=h2, size=RD_DICT, act="softmax",
                    param_attr=pkg.ParamAttr(name="dec_out_w"))
        drnn.update_memory(h, h2)
        drnn.update_memory(c, c2)
        drnn.output(pred)
    rnn_out = drnn()
    label = L.data(name="trg_next_word", shape=[RD_T], dtype="int64")
    ce = L.cross_entropy(input=L.reshape(rnn_out, shape=[-1, RD_DICT]),
                         label=L.reshape(label, shape=[-1, 1]))
    mask = L.reshape(L.cast(L.sequence_mask(trg_len, RD_T), "float32"),
                     shape=[-1, 1])
    loss = L.elementwise_div(L.reduce_sum(L.elementwise_mul(ce, mask)),
                             L.reduce_sum(mask))
    pkg.optimizer.Adagrad(learning_rate=0.3).minimize(loss)
    return [loss, rnn_out]


def test_rnn_encoder_decoder_trains_saves_and_infers_as_jax(tmp_path):
    rng = np.random.RandomState(1)
    src = rng.randint(2, RD_DICT, size=(4, RD_T)).astype("int64")
    lens = rng.randint(2, RD_T + 1, size=(4,)).astype("int64")
    trg = np.roll(src, 1, axis=1)
    trg[:, 0] = 0
    feed = {"src_word_id": src, "src_len": lens, "trg_word_id": trg,
            "trg_len": lens, "trg_next_word": src}
    want, got = run_programs_both(rnn_encoder_decoder, feed,
                                  lambda o: [o[0]], steps=3, seed=23)
    assert_steps_close(got, want, atol=0, rtol=2e-4)
    # the port's save -> load -> infer cycle
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 23
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, rnn_out = rnn_encoder_decoder(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    path = str(tmp_path / "rnn_enc_dec")
    names = ["src_word_id", "src_len", "trg_word_id", "trg_len"]
    with _scoped(pt, scope):
        pt.io.save_inference_model(path, names, [rnn_out], exe,
                                   main_program=main)
    (before,) = exe.run(main.clone(for_test=True), feed=feed,
                        fetch_list=[rnn_out], scope=scope)
    scope2, exe2 = pt.Scope(), pt.Executor(pt.CPUPlace())
    with _scoped(pt, scope2):
        prog, feed_names, fetches = pt.io.load_inference_model(path, exe2)
    (after,) = exe2.run(prog, feed={n: feed[n] for n in feed_names},
                        fetch_list=[v.name for v in fetches], scope=scope2)
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ the while program


def _while_loop(pkg):
    """tools/dump_book_programs.py:build_while_loop."""
    L = pkg.layers
    i = L.zeros(shape=[1], dtype="float32")
    limit = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    s = L.zeros(shape=[1], dtype="float32")
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        L.assign(L.elementwise_add(x=s, y=i), output=s)
        L.increment(i, value=1.0)
        L.less_than(x=i, y=limit, cond=cond)
    return s


def test_while_loop_files_are_read_and_written_by_both(tmp_path):
    d = json.loads((BOOK / "while_loop.main.json").read_text())
    prog = pt.Program.from_dict(d)
    assert prog.to_dict() == d
    assert prog.block(0).ops[-1].attrs["sub_block"] is prog.block(1)
    s_name = d["blocks"][0]["ops"][2]["outputs"]["Out"][0]
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.Program.from_dict(json.loads(
        (BOOK / "while_loop.startup.json").read_text())), scope=scope)
    (s,) = exe.run(prog, fetch_list=[s_name], scope=scope)
    assert float(s[0]) == 45.0
    # built and saved by each package: the same files
    dirs = {}
    for pkg, guard in BOTH:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            out = _while_loop(pkg)
        assert main.to_dict() == d
        place = pkg.CPUPlace()
        exe = pkg.Executor(place)
        scope = JScope() if pkg is fluid else pt.Scope()
        dirs[pkg] = str(tmp_path / pkg.__name__)
        with _scoped(pkg, scope):
            exe.run(startup)
            pkg.io.save_inference_model(dirs[pkg], [], [out], exe,
                                        main_program=main)
    jdir, pdir = dirs[fluid], dirs[pt]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for f in os.listdir(jdir):
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(pdir, f),
                           shallow=False), f
    # each package loads the other's directory and runs it
    for pkg, d_ in ((pt, jdir), (fluid, pdir)):
        scope = JScope() if pkg is fluid else pt.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        with _scoped(pkg, scope):
            prog, _, fetches = pkg.io.load_inference_model(d_, exe)
            (s,) = exe.run(prog, fetch_list=[v.name for v in fetches])
        assert float(np.asarray(s)[0]) == 45.0


def test_beam_decoder_served_by_the_predictor_is_the_argmax_chain(tmp_path):
    from test_torch_sequence_family import _greedy_decoder

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        (ids, scores), (emb_np, w_np) = _greedy_decoder(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    path = str(tmp_path / "greedy")
    with _scoped(pt, scope):
        exe.run(startup)
        pt.io.save_inference_model(path, [], [ids, scores], exe,
                                   main_program=main)
    pred = inference.create_predictor(inference.Config(
        path, place=pt.CPUPlace()))
    got_ids, got_scores = pred.run({})
    tok, expect = 0, []
    for _ in range(5):
        tok = int(np.argmax(emb_np[tok] @ w_np))
        expect.append(tok)
    np.testing.assert_array_equal(np.asarray(got_ids).reshape(-1), expect)
    assert np.isfinite(np.asarray(got_scores)).all()
