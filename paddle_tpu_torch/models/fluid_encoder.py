"""A transformer encoder classifier written as a Fluid user writes one:
from `layers` and `nets` primitives only, no fused op.

Each layer: three `fc` projections, `nets.scaled_dot_product_attention`
(heads split and merged by `layers.reshape` and `layers.transpose`,
`matmul` and `softmax` between), an output `fc`, a residual add and
`layer_norm`; then a gated feed-forward: `fc` d_model -> d_inner,
`nets.glu` to d_inner / 2, `fc` back to d_model, a residual add and
`layer_norm`.  The input is a sequence of feature vectors (frames of a
signal, patches of an image) projected by an `fc`, plus a learned
position table (`create_parameter`); the head is `reduce_mean` over the
sequence, an `fc` to the classes and `softmax_with_cross_entropy`, with
`layers.argmax` and `accuracy` beside it.  Every op of the step has a
backward that adds in a fixed order on the card (no atomics), so a
captured step replays the interpreter's bit for bit.

`build(cfg, layers=..., nets=...)` takes the layer and net modules as
arguments (the port's by default), so that the same function builds the
same Program from another package's builders of the same names.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EncoderConfig:
    d_input: int = 512      # the width of a feature vector
    classes: int = 16
    seq_len: int = 256
    d_model: int = 512
    n_head: int = 8
    n_layer: int = 6
    d_inner: int = 4096     # the GLU's input width; its output is half
    dropout: float = 0.0


def base():
    """Transformer-base width: d_model 512, 8 heads of 64, 6 layers, the
    GLU 512 -> 4096 -> 2048 -> 512, sequence 256."""
    return EncoderConfig()


def tiny(**kw):
    cfg = EncoderConfig(d_input=32, classes=5, seq_len=16, d_model=64,
                        n_head=4, n_layer=2, d_inner=512)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def build(cfg, layers=None, nets=None):
    """-> (loss, {"logits", "pred", "acc"}); feeds `feat` [B, S, d_input]
    float32 and `label` [B, 1] int64."""
    if layers is None:
        from .. import layers
    if nets is None:
        from .. import nets
    d, s = cfg.d_model, cfg.seq_len
    feat = layers.data(name="feat", shape=[s, cfg.d_input], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    x = layers.fc(feat, d, num_flatten_dims=2)
    pos = layers.create_parameter(shape=[s, d], dtype="float32",
                                  name="pos_table")
    x = layers.elementwise_add(x, pos, axis=1)
    for _ in range(cfg.n_layer):
        q, k, v = (layers.fc(x, d, num_flatten_dims=2) for _ in range(3))
        ctx = nets.scaled_dot_product_attention(
            q, k, v, num_heads=cfg.n_head, dropout_rate=cfg.dropout)
        attn = layers.fc(ctx, d, num_flatten_dims=2)
        x = layers.layer_norm(layers.elementwise_add(x, attn),
                              begin_norm_axis=2)
        h = nets.glu(layers.fc(x, cfg.d_inner, num_flatten_dims=2), dim=-1)
        ffn = layers.fc(h, d, num_flatten_dims=2)
        x = layers.layer_norm(layers.elementwise_add(x, ffn),
                              begin_norm_axis=2)
    pooled = layers.reduce_mean(x, dim=1)
    logits = layers.fc(pooled, cfg.classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    pred = layers.argmax(logits, axis=1)
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, {"logits": logits, "pred": pred, "acc": acc}


def synthetic_batch(batch, cfg, seed=0):
    """Standard normal features and a label they decide (the largest of
    the first `classes` features' means over the sequence), so the loss
    can fall."""
    rng = np.random.RandomState(seed)
    feat = rng.standard_normal((batch, cfg.seq_len, cfg.d_input)).astype(
        np.float32)
    label = feat[:, :, : cfg.classes].mean(1).argmax(1).astype(
        np.int64)[:, None]
    return {"feat": feat, "label": label}


def flops_per_token(cfg):
    """Training FLOPs a token (3 x the forward's 2 x MACs): the input
    projection, and a layer's four d x d projections, the GLU's two
    products and the attention's QK^T and PV over the sequence."""
    d, s = cfg.d_model, cfg.seq_len
    per_layer = (4 * d * d + d * cfg.d_inner + (cfg.d_inner // 2) * d
                 + 2 * s * d)
    return 6 * (cfg.d_input * d + cfg.n_layer * per_layer)
