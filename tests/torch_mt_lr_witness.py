"""The book's machine-translation chapter (tests/book/
test_machine_translation.py `_build_train`) at bench.py's
machine_translation widths (dict 10,000, word dim and hidden 256, T 24),
trained a few Adagrad steps on the CPU by the JAX package and by the
port from the JAX startup's weights: each step's loss from each package
and their largest relative gap, as one JSON line.  It shows whether a
learning rate diverges in the chapter itself or only in the port.

    python tests/torch_mt_lr_witness.py --lr 0.5 --batch 32 --steps 3

The data is chip_smoke.py's CF/mt batch formula (the copy task) from
`--seed`.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_op_parity import run_programs_both  # noqa: E402

DICT, DIM, HIDDEN, T, BOS = 10000, 256, 256, 24, 0


def chapter(lr):
    def fn(pkg):
        L = pkg.layers
        src = L.data(name="src_word_id", shape=[T], dtype="int64")
        src_len = L.data(name="src_len", shape=[], dtype="int64")
        emb = L.embedding(input=src, size=[DICT, DIM],
                          param_attr=pkg.ParamAttr(name="vemb"))
        seq, _, _ = L.lstm(emb, HIDDEN,
                           param_attr=pkg.ParamAttr(name="enc_lstm"))
        context = L.sequence_last_step(seq, seq_len=src_len)
        trg = L.data(name="trg_word_id", shape=[T], dtype="int64")
        trg_len = L.data(name="trg_len", shape=[], dtype="int64")
        temb = L.embedding(input=trg, size=[DICT, DIM],
                           param_attr=pkg.ParamAttr(name="trg_emb"))
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(temb, seq_len=trg_len)
            prev = drnn.memory(init=context)
            state = L.fc(input=[word, prev], size=HIDDEN, act="tanh",
                         param_attr=[pkg.ParamAttr(name="dec_state_w"),
                                     pkg.ParamAttr(name="dec_state_u")],
                         bias_attr=pkg.ParamAttr(name="dec_state_b"))
            score = L.fc(input=state, size=DICT, act="softmax",
                         param_attr=pkg.ParamAttr(name="dec_out_w"),
                         bias_attr=pkg.ParamAttr(name="dec_out_b"))
            drnn.update_memory(prev, state)
            drnn.output(score)
        label = L.data(name="trg_next_word", shape=[T], dtype="int64")
        ce = L.cross_entropy(input=L.reshape(drnn(), shape=[-1, DICT]),
                             label=L.reshape(label, shape=[-1, 1]))
        mask = L.reshape(L.cast(L.sequence_mask(trg_len, T), "float32"),
                         shape=[-1, 1])
        loss = L.elementwise_div(L.reduce_sum(L.elementwise_mul(ce, mask)),
                                 L.reduce_sum(mask))
        pkg.optimizer.Adagrad(
            learning_rate=lr,
            regularization=pkg.regularizer.L2DecayRegularizer(1e-4),
        ).minimize(loss)
        return [loss]

    return fn


def batch_of(seed, batch):
    rng = np.random.RandomState(seed)
    src = rng.randint(2, DICT, size=(batch, T)).astype("int64")
    src_len = rng.randint(2, T + 1, size=(batch,)).astype("int64")
    trg = np.roll(src, 1, axis=1)
    trg[:, 0] = BOS
    return {"src_word_id": src, "src_len": src_len, "trg_word_id": trg,
            "trg_len": src_len, "trg_next_word": src.copy()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2204)
    args = ap.parse_args()
    want, got = run_programs_both(chapter(args.lr),
                                  batch_of(args.seed, args.batch),
                                  lambda o: o, steps=args.steps, seed=17)
    jax_l = [float(np.asarray(s[0]).reshape(-1)[0]) for s in want]
    port_l = [float(np.asarray(s[0]).reshape(-1)[0]) for s in got]
    gap = max(abs(p - j) / abs(j) for p, j in zip(port_l, jax_l))
    print(json.dumps({"lr": args.lr, "batch": args.batch, "seed": args.seed,
                      "jax_losses": jax_l, "port_losses": port_l,
                      "max_rel_gap": gap}))


if __name__ == "__main__":
    main()
