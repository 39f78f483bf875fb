"""Stacked-LSTM text classification (counterpart of
paddle_tpu/models/stacked_lstm.py; the reference's
benchmark/fluid/models/stacked_dynamic_lstm.py): embedding, stacked
LSTMs (every second one reversed), a max pool over time, a softmax fc.
Fixed-length padded batches replace the reference's LoD batches.
bench.py's stacked_lstm leg trains `build(seq_len=100, hidden_dim=512,
stacked_num=2)` at batch 64 with Adam(1e-3) under bf16 AMP.
"""

from __future__ import annotations

from .. import layers


def build(seq_len=100, dict_size=30000, emb_dim=512, hidden_dim=512,
          stacked_num=3, class_dim=2):
    words = layers.data(name="words", shape=[seq_len], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(input=words, size=[dict_size, emb_dim])

    x = emb
    for i in range(stacked_num):
        x, _, _ = layers.lstm(x, hidden_dim, is_reverse=(i % 2 == 1))
    pooled = layers.reduce_max(x, dim=1)       # max over time
    prediction = layers.fc(input=pooled, size=class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return loss, prediction, acc


def feed_shapes(batch_size, seq_len=100):
    return {
        "words": ((batch_size, seq_len), "int64"),
        "label": ((batch_size, 1), "int64"),
    }
