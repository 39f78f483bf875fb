"""BERT-base masked-LM pretraining: the configs, the training graph and
its synthetic batch.

Counterpart of paddle_tpu/models/bert.py: `BertConfig`, `base`, `tiny`,
`build`, `_gather_positions` and `synthetic_batch`, op for op and name for
name, so both packages build the same Program and weights carried across
with `convert.load_params` land where it reads them.  Token + position +
segment embeddings, pre-LN encoder layers (`fused_attention` with the
input mask's per-row lengths as SeqLen), a masked-LM head tied to the
word embedding over the masked positions (gathered by a one-hot matmul)
and a next-sentence head on [CLS].  At 2048 tokens and BERT-base widths
every attention takes the streaming flash tier (kernels #3, #4, #5).
Dropout sits where the JAX package puts it (the embeddings, each
attention and FFN branch).  `fused_head` computes the masked-LM loss with
`fused_linear_cross_entropy` over the tied word embedding (transpose_w,
no [B, M, V] logits); `checkpoints` collects each encoder layer's output
for `optimizer.RecomputeOptimizer`.  With `moe_experts` > 0 each encoder
FFN is a mixture (`layers.moe_ffn`, gelu experts) and the gating ops'
load-balance losses join the total at `moe_aux_weight`.
"""

from __future__ import annotations

import numpy as np

from .. import layers, moe
from ..layer_helper import LayerHelper, ParamAttr


def _check_prefix_mask(imask):
    """Route input_mask through the check_prefix_mask op (ops/misc_ops.py):
    the identity, which raises naming the first row that is not a prefix
    mask."""
    helper = LayerHelper("check_prefix_mask")
    out = helper.create_variable_for_type_inference(dtype=imask.dtype)
    out.stop_gradient = True
    helper.append_op(type="check_prefix_mask", inputs={"X": [imask]},
                     outputs={"Out": [out]})
    return out


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, layers_=12, heads=12,
                 ffn=3072, max_positions=512, type_vocab=2,
                 max_predictions=20, dropout=0.1, moe_experts=0,
                 moe_top_k=2, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers_
        self.heads = heads
        self.ffn = ffn
        self.max_positions = max_positions
        self.type_vocab = type_vocab
        self.max_predictions = max_predictions
        self.dropout = dropout
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_weight = moe_aux_weight


def base():
    return BertConfig()


def tiny(vocab=128, seq=16):
    """Test config (head_dim 16: every attention gate sends it to the
    composite)."""
    return BertConfig(vocab_size=vocab, hidden=32, layers_=2, heads=2,
                      ffn=64, max_positions=seq, max_predictions=4,
                      dropout=0.0)


def tiny_moe(vocab=128, seq=16, experts=4, top_k=2, capacity_factor=1.25):
    """tiny() with MoE FFNs at its FLOPs a token: experts of width
    ffn // top_k, so top_k of them spend what the dense ffn does."""
    cfg = tiny(vocab=vocab, seq=seq)
    cfg.ffn = max(1, cfg.ffn // top_k)
    cfg.moe_experts = experts
    cfg.moe_top_k = top_k
    cfg.moe_capacity_factor = capacity_factor
    return cfg


def _encoder_layer(x, cfg, name, attn_seq_len=None):
    attn = layers.multi_head_attention(
        layers.layer_norm(x, begin_norm_axis=2, name=f"{name}_ln1"),
        d_model=cfg.hidden, num_heads=cfg.heads, causal=False,
        attn_seq_len=attn_seq_len, name=f"{name}_attn")
    if cfg.dropout:
        attn = layers.dropout(x=attn, dropout_prob=cfg.dropout)
    x = layers.elementwise_add(x=x, y=attn)
    h_in = layers.layer_norm(x, begin_norm_axis=2, name=f"{name}_ln2")
    if cfg.moe_experts:
        # the aux loss is scanned out of the program by build()
        h, _aux = layers.moe_ffn(
            h_in, num_experts=cfg.moe_experts, d_inner=cfg.ffn,
            top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
            act="gelu", name=f"{name}_ffn")
    else:
        h = layers.fc(h_in, size=cfg.ffn, num_flatten_dims=2, act="gelu",
                      name=f"{name}_fc1")
        h = layers.fc(h, size=cfg.hidden, num_flatten_dims=2,
                      name=f"{name}_fc2")
    if cfg.dropout:
        h = layers.dropout(x=h, dropout_prob=cfg.dropout)
    return layers.elementwise_add(x=x, y=h)


def build(cfg: BertConfig = None, seq_len=None, checkpoints=None,
          fused_head=False, use_input_mask=False):
    """Pretraining graph -> (total_loss, mlm_loss, nsp_loss).

    Feeds: input_ids [B,S], segment_ids [B,S], masked_positions [B,M],
    masked_labels [B,M], masked_weights [B,M] (0 pads), nsp_labels [B,1],
    plus input_mask [B,S] float (1 = real token) when use_input_mask.
    checkpoints: a list that collects every encoder layer's output.
    use_input_mask: attend only over real tokens.  The mask must be a
    PREFIX mask (every row 1...1 0...0); it reduces to [B] int32 key
    lengths that ride the attention kernels' length masks, and a
    check_prefix_mask op raises on a row with a hole.
    """
    cfg = cfg or base()
    s = seq_len or cfg.max_positions
    ids = layers.data("input_ids", shape=[s], dtype="int64")
    seg = layers.data("segment_ids", shape=[s], dtype="int64")
    mpos = layers.data("masked_positions", shape=[cfg.max_predictions],
                       dtype="int64")
    mlab = layers.data("masked_labels", shape=[cfg.max_predictions],
                       dtype="int64")
    mw = layers.data("masked_weights", shape=[cfg.max_predictions],
                     dtype="float32")
    nsp = layers.data("nsp_labels", shape=[1], dtype="int64")

    emb = layers.embedding(ids, size=[cfg.vocab_size, cfg.hidden],
                           param_attr=ParamAttr(name="word_emb"))
    pos_ids = layers.assign(np.arange(s, dtype=np.int64).reshape(1, s))
    pos = layers.embedding(pos_ids, size=[cfg.max_positions, cfg.hidden],
                           param_attr=ParamAttr(name="pos_emb"))
    typ = layers.embedding(seg, size=[cfg.type_vocab, cfg.hidden],
                           param_attr=ParamAttr(name="type_emb"))
    x = layers.elementwise_add(x=layers.elementwise_add(x=emb, y=typ),
                               y=pos, axis=1)
    seq_lens = None
    if use_input_mask:
        imask = layers.data("input_mask", shape=[s], dtype="float32")
        imask = _check_prefix_mask(imask)
        # [B] real-token lengths counted in int32: a float sum would ride
        # the AMP pass into bf16, which holds no odd integer above 256
        seq_lens = layers.reduce_sum(layers.cast(imask, "int32"), dim=1)
        seq_lens.stop_gradient = True
    if cfg.dropout:
        x = layers.dropout(x=x, dropout_prob=cfg.dropout)
    for i in range(cfg.layers):
        x = _encoder_layer(x, cfg, f"enc{i}", attn_seq_len=seq_lens)
        if checkpoints is not None:
            checkpoints.append(x)
    x = layers.layer_norm(x, begin_norm_axis=2, name="final_ln")

    # masked-LM head, tied to word_emb, over the gathered positions
    gathered = _gather_positions(x, mpos, s)
    h = layers.fc(gathered, size=cfg.hidden, num_flatten_dims=2, act="gelu",
                  name="mlm_transform")
    h = layers.layer_norm(h, begin_norm_axis=2, name="mlm_ln")
    w = layers.create_parameter(shape=[cfg.vocab_size, cfg.hidden],
                                dtype="float32", name="word_emb")
    if fused_head:
        per_tok = layers.fused_linear_cross_entropy(
            h, mlab, size=cfg.vocab_size, weight=w, transpose_w=True)
    else:
        logits = layers.matmul(h, w, transpose_y=True)      # [B, M, V]
        logits2d = layers.reshape(logits, shape=[-1, cfg.vocab_size])
        lab2d = layers.reshape(mlab, shape=[-1, 1])
        per_tok = layers.softmax_with_cross_entropy(logits=logits2d,
                                                    label=lab2d)
    w2d = layers.reshape(mw, shape=[-1, 1])
    mlm_loss = layers.reduce_sum(layers.elementwise_mul(per_tok, w2d)) \
        / (layers.reduce_sum(w2d) + 1e-6)

    # next-sentence head on [CLS]
    cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, shape=[-1, cfg.hidden])
    pooled = layers.fc(cls, size=cfg.hidden, act="tanh", name="pooler")
    nsp_logits = layers.fc(pooled, size=2, name="nsp_head")
    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(logits=nsp_logits, label=nsp))
    total = layers.elementwise_add(x=mlm_loss, y=nsp_loss)
    aux = (moe.scaled_aux_loss(cfg.moe_aux_weight) if cfg.moe_experts
           else None)
    if aux is not None:
        total = layers.elementwise_add(x=total, y=aux)
    return total, mlm_loss, nsp_loss


def _gather_positions(x, positions, seq_len):
    """x [B,S,H], positions [B,M] -> [B,M,H] by a one-hot matmul (static
    shapes)."""
    onehot = layers.one_hot(positions, depth=seq_len)  # [B,M,S]
    return layers.matmul(onehot, x)


def synthetic_batch(batch, cfg: BertConfig, seq_len=None, seed=0,
                    use_input_mask=False):
    """A random pretraining batch from a seed: half the prediction slots
    masked ([MASK] = 3), and with use_input_mask ragged real lengths in
    [s // 2, s] as prefix masks."""
    rng = np.random.RandomState(seed)
    s = seq_len or cfg.max_positions
    m = cfg.max_predictions
    ids = rng.randint(0, cfg.vocab_size, (batch, s)).astype(np.int64)
    n_mask = max(1, m // 2)
    mpos = np.zeros((batch, m), np.int64)
    mw = np.zeros((batch, m), np.float32)
    mlab = np.zeros((batch, m), np.int64)
    for b in range(batch):
        sel = rng.choice(s, size=n_mask, replace=False)
        mpos[b, :n_mask] = sel
        mlab[b, :n_mask] = ids[b, sel]
        mw[b, :n_mask] = 1.0
        ids[b, sel] = 3  # [MASK]
    feed = {
        "input_ids": ids,
        "segment_ids": (rng.rand(batch, s) > 0.5).astype(np.int64),
        "masked_positions": mpos,
        "masked_labels": mlab,
        "masked_weights": mw,
        "nsp_labels": rng.randint(0, 2, (batch, 1)).astype(np.int64),
    }
    if use_input_mask:
        lens = rng.randint(s // 2, s + 1, (batch,))
        feed["input_mask"] = (
            np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    return feed
