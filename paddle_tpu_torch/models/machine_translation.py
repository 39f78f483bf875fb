"""Seq2seq machine translation: a GRU encoder-decoder with attention
(counterpart of paddle_tpu/models/machine_translation.py; the reference's
benchmark/fluid/models/machine_translation.py).

The encoder runs a GRU each way over the source and concatenates them;
the decoder GRU is teacher-forced at train time, its states query a
projection of the encoder states through one attention head, and the
context concatenated onto the GRU output goes through one fc to the
vocabulary.  Parameter names are explicit, so the train program and both
decode programs land on the same weights in one scope.  bench.py's
machine_translation leg trains `build()` (src and trg 24, dict 10000,
emb and hidden 256) at batch 128 with Adam(1e-3) under bf16 AMP.
"""

from __future__ import annotations

from .. import decode as decode_mod
from .. import layers
from ..framework import Program, program_guard, unique_name
from ..layer_helper import ParamAttr


def encoder(src_ids, dict_size, emb_dim, hidden_dim):
    emb = layers.embedding(input=src_ids, size=[dict_size, emb_dim],
                           param_attr=ParamAttr(name="src_emb_w"))
    fwd, _ = layers.gru(emb, hidden_dim,
                        param_attr=ParamAttr(name="enc_gru_fwd"),
                        bias_attr=ParamAttr(name="enc_gru_fwd_b"))
    bwd, _ = layers.gru(emb, hidden_dim, is_reverse=True,
                        param_attr=ParamAttr(name="enc_gru_bwd"),
                        bias_attr=ParamAttr(name="enc_gru_bwd_b"))
    return layers.concat([fwd, bwd], axis=2)  # [B, S, 2H]


def _dec_gru(emb, hidden_dim, h0=None):
    return layers.gru(emb, hidden_dim, h0=h0,
                      param_attr=ParamAttr(name="dec_gru"),
                      bias_attr=ParamAttr(name="dec_gru_b"))


def _dec_head(dec, ctx_q, enc_kv, dict_size, hidden_dim):
    """Attention (one head, no bias, no mask) and the output projection,
    shared by the train and decode-step programs."""
    ctx = layers.fused_attention(ctx_q, enc_kv, enc_kv, num_heads=1)
    merged = layers.concat([dec, ctx], axis=2)
    return layers.fc(input=merged, size=dict_size, num_flatten_dims=2,
                     act=None, name="dec_proj")


def decoder_train(trg_ids, enc_out, dict_size, emb_dim, hidden_dim):
    emb = layers.embedding(input=trg_ids, size=[dict_size, emb_dim],
                           param_attr=ParamAttr(name="trg_emb_w"))
    dec, _ = _dec_gru(emb, hidden_dim)  # [B, T, H]
    q = layers.fc(input=dec, size=hidden_dim, num_flatten_dims=2,
                  bias_attr=False, name="attn_q")
    kv = layers.fc(input=enc_out, size=hidden_dim, num_flatten_dims=2,
                   bias_attr=False, name="attn_kv")
    return _dec_head(dec, q, kv, dict_size, hidden_dim)


def build(src_seq_len=24, trg_seq_len=24, dict_size=10000, emb_dim=256,
          hidden_dim=256):
    src = layers.data(name="src_ids", shape=[src_seq_len], dtype="int64")
    trg = layers.data(name="trg_ids", shape=[trg_seq_len], dtype="int64")
    lbl = layers.data(name="lbl_ids", shape=[trg_seq_len], dtype="int64")
    enc = encoder(src, dict_size, emb_dim, hidden_dim)
    logits = decoder_train(trg, enc, dict_size, emb_dim, hidden_dim)
    loss_vec = layers.softmax_with_cross_entropy(
        logits=layers.reshape(logits, shape=[-1, dict_size]),
        label=layers.reshape(lbl, shape=[-1, 1]),
    )
    loss = layers.mean(loss_vec)
    return loss, logits


def build_decode(src_seq_len=24, dict_size=10000, emb_dim=256,
                 hidden_dim=256, max_len=None):
    """Prefill and step programs as a decode.GenerationSpec.

    The carried decode state is the decoder GRU's [B, H] hidden vector
    (gru h0 in, LastH out), beside the encoder-side attention projection
    computed once by the prefill.  Generation starts from bos: the
    prefill emits no logits and the first step consumes bos.  The step
    attends over all src_seq_len encoder positions unmasked, as training
    does."""
    prefill, prefill_startup = Program(), Program()
    with program_guard(prefill, prefill_startup), unique_name.guard():
        src = layers.data(name="src_ids", shape=[src_seq_len],
                          dtype="int64")
        enc = encoder(src, dict_size, emb_dim, hidden_dim)
        kv = layers.fc(input=enc, size=hidden_dim, num_flatten_dims=2,
                       bias_attr=False, name="attn_kv")

    step, step_startup = Program(), Program()
    with program_guard(step, step_startup), unique_name.guard():
        prev_ids = layers.data(name="prev_ids", shape=[1], dtype="int64")
        dec_h = layers.data(name="dec_h", shape=[hidden_dim])
        enc_kv = layers.data(name="enc_kv", shape=[src_seq_len,
                                                   hidden_dim])
        emb = layers.embedding(input=prev_ids, size=[dict_size, emb_dim],
                               param_attr=ParamAttr(name="trg_emb_w"))
        # lookup_table drops the trailing singleton ids dim: [B, e]
        emb = layers.reshape(emb, shape=[-1, 1, emb_dim])
        dec, last_h = _dec_gru(emb, hidden_dim, h0=dec_h)
        q = layers.fc(input=dec, size=hidden_dim, num_flatten_dims=2,
                      bias_attr=False, name="attn_q")
        logits = _dec_head(dec, q, enc_kv, dict_size, hidden_dim)
        step_logits = layers.reshape(logits, shape=[-1, dict_size])

    return decode_mod.GenerationSpec(
        prefill_program=prefill, prefill_startup=prefill_startup,
        step_program=step, step_startup=step_startup,
        prefill_feeds=["src_ids"],
        prefill_logits=None,
        step_feeds=[],
        step_logits=step_logits.name,
        states=[
            decode_mod.StateSpec(feed="enc_kv", init_from=kv.name),
            decode_mod.StateSpec(feed="dec_h", zeros=(hidden_dim,),
                                 update=last_h.name),
        ],
        max_len=max_len,
    )


def feed_shapes(batch_size, src_seq_len=24, trg_seq_len=24):
    return {
        "src_ids": ((batch_size, src_seq_len), "int64"),
        "trg_ids": ((batch_size, trg_seq_len), "int64"),
        "lbl_ids": ((batch_size, trg_seq_len), "int64"),
    }
