"""Transformer (base/big) for WMT En-De: the training graph and the decode
programs.

Counterpart of paddle_tpu/models/transformer.py: the configs, `build` (the
training graph and its loss), `encoder`/`decoder`, `feed_shapes`,
`synthetic_batch`, the decode programs of `build_decode` (prefill, step,
the Sq = k verify and Sq = chunk windows, the encoder-only pass), and
`build_draft`'s truncated draft for speculative decoding.  Every
parameter name is the JAX package's, and the training graph places its
dropouts where the JAX package's does (the embeddings, the FFN hidden,
every residual branch), so the two Program dicts are equal op for op and
weights carried across with `convert.load_params` land where these
programs read them.  The fused loss head (`fused_head`), MoE FFNs and the
int8 draft tier are later slices (ROADMAP.md A).
"""

from __future__ import annotations

import copy

import numpy as np

from .. import layers
from .. import decode as decode_mod
from ..framework import Program, program_guard, unique_name
from ..initializer import NumpyArrayInitializer
from ..layer_helper import ParamAttr


class TransformerConfig:
    def __init__(
        self,
        src_vocab_size=32000,
        trg_vocab_size=32000,
        max_length=256,
        n_layer=6,
        n_head=8,
        d_model=512,
        d_inner=2048,
        dropout=0.1,
        label_smooth_eps=0.1,
        tie_embeddings=True,
        moe_experts=0,
    ):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.max_length = max_length
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model
        self.d_inner = d_inner
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps
        self.tie_embeddings = tie_embeddings
        self.moe_experts = moe_experts


def base():
    return TransformerConfig()


def big():
    return TransformerConfig(n_head=16, d_model=1024, d_inner=4096)


def tiny(vocab=1000, max_length=32):
    """Test config (head_dim 16: every attention gate sends it to the
    composite)."""
    return TransformerConfig(
        src_vocab_size=vocab, trg_vocab_size=vocab, max_length=max_length,
        n_layer=2, n_head=4, d_model=64, d_inner=128, dropout=0.0,
    )


def _position_encoding(seq_len, d_model):
    pos = np.arange(seq_len)[:, None].astype("float64")
    dim = np.arange(0, d_model, 2)[None, :].astype("float64")
    angle = pos / np.power(10000.0, dim / d_model)
    enc = np.zeros((seq_len, d_model), dtype="float32")
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


def _check_trainable(cfg: TransformerConfig):
    if cfg.moe_experts:
        raise NotImplementedError(
            "MoE FFNs land with the moe op family (ROADMAP.md A)")


def _embed(ids, vocab_size, cfg: TransformerConfig, param_name, seq_len):
    """Token embedding scaled by sqrt(d_model) plus the sinusoid table of
    the training graph (`<param_name>_pos_enc`)."""
    emb = layers.embedding(input=ids, size=[vocab_size, cfg.d_model],
                           param_attr=ParamAttr(name=param_name))
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    pos = layers.create_parameter(
        shape=[seq_len, cfg.d_model], dtype="float32",
        name=f"{param_name}_pos_enc",
        default_initializer=NumpyArrayInitializer(
            _position_encoding(seq_len, cfg.d_model)))
    pos.trainable = False
    pos.stop_gradient = True
    x = layers.elementwise_add(x=emb, y=pos, axis=1)
    if cfg.dropout:
        x = layers.dropout(x=x, dropout_prob=cfg.dropout)
    return x


def _pre_ln(x, name=None):
    return layers.layer_norm(x, begin_norm_axis=2, name=name)


def _ffn(x, cfg: TransformerConfig, name):
    h = layers.fc(input=x, size=cfg.d_inner, num_flatten_dims=2, act="relu",
                  name=f"{name}_fc1")
    if cfg.dropout:
        h = layers.dropout(x=h, dropout_prob=cfg.dropout)
    return layers.fc(input=h, size=cfg.d_model, num_flatten_dims=2,
                     name=f"{name}_fc2")


def _residual(x, sub, cfg: TransformerConfig):
    if cfg.dropout:
        sub = layers.dropout(x=sub, dropout_prob=cfg.dropout)
    return layers.elementwise_add(x=x, y=sub)


def encoder(src, cfg: TransformerConfig, checkpoints=None, src_lens=None):
    """Pre-LN encoder stack; layer norms carry explicit names so the decode
    programs share one scope with the training graph.  `checkpoints`, when
    given, collects the residual stream after every sub-block."""
    x = src
    for i in range(cfg.n_layer):
        attn = layers.multi_head_attention(
            _pre_ln(x, name=f"enc{i}_ln1"), d_model=cfg.d_model,
            num_heads=cfg.n_head, causal=False, attn_seq_len=src_lens,
            name=f"enc{i}_attn")
        x = _residual(x, attn, cfg)
        if checkpoints is not None:
            checkpoints.append(x)
        x = _residual(x, _ffn(_pre_ln(x, name=f"enc{i}_ln2"), cfg,
                              f"enc{i}_ffn"), cfg)
        if checkpoints is not None:
            checkpoints.append(x)
    return _pre_ln(x, name="enc_ln")


def decoder(trg, enc_out, cfg: TransformerConfig, checkpoints=None,
            src_lens=None):
    """Pre-LN decoder stack: causal self-attention, cross-attention over
    enc_out (keys past src_lens masked), FFN."""
    x = trg
    for i in range(cfg.n_layer):
        self_attn = layers.multi_head_attention(
            _pre_ln(x, name=f"dec{i}_ln1"), d_model=cfg.d_model,
            num_heads=cfg.n_head, causal=True, name=f"dec{i}_self")
        x = _residual(x, self_attn, cfg)
        if checkpoints is not None:
            checkpoints.append(x)
        cross = layers.multi_head_attention(
            _pre_ln(x, name=f"dec{i}_ln2"), keys=enc_out,
            d_model=cfg.d_model, num_heads=cfg.n_head, causal=False,
            attn_seq_len=src_lens, name=f"dec{i}_cross")
        x = _residual(x, cross, cfg)
        if checkpoints is not None:
            checkpoints.append(x)
        x = _residual(x, _ffn(_pre_ln(x, name=f"dec{i}_ln3"), cfg,
                              f"dec{i}_ffn"), cfg)
        if checkpoints is not None:
            checkpoints.append(x)
    return _pre_ln(x, name="dec_ln")


def build(cfg: TransformerConfig = None, seq_len=None, checkpoints=None,
          fused_head=False, use_src_lens=False):
    """Training graph: (src_ids, trg_ids, lbl_ids) -> mean token loss, with
    label smoothing fused into softmax_with_cross_entropy.  Returns
    (loss, logits).

    use_src_lens: feed src_lens [B] (real source lengths); encoder
    self-attention and decoder cross-attention mask keys past each row's
    length through the kernels' key_len path.

    `checkpoints` (optional list) is filled with the residual stream after
    every sub-block plus the embedding and encoder/decoder outputs, the
    remat boundaries a RecomputeOptimizer would use."""
    cfg = cfg or base()
    _check_trainable(cfg)
    if fused_head:
        raise NotImplementedError(
            "fused_head (the chunked linear_softmax_ce loss head) is not "
            "ported yet (ROADMAP.md A)")
    seq_len = seq_len or cfg.max_length
    src_ids = layers.data(name="src_ids", shape=[seq_len], dtype="int64")
    trg_ids = layers.data(name="trg_ids", shape=[seq_len], dtype="int64")
    lbl_ids = layers.data(name="lbl_ids", shape=[seq_len], dtype="int64")
    src_lens = None
    if use_src_lens:
        src_lens = layers.data(name="src_lens", shape=[], dtype="int64")
        src_lens.stop_gradient = True

    src_emb_name = "src_word_emb"
    trg_emb_name = src_emb_name if cfg.tie_embeddings else "trg_word_emb"

    enc_in = _embed(src_ids, cfg.src_vocab_size, cfg, src_emb_name, seq_len)
    if checkpoints is not None:
        checkpoints.append(enc_in)
    enc_out = encoder(enc_in, cfg, checkpoints, src_lens=src_lens)
    if checkpoints is not None:
        checkpoints.append(enc_out)
    dec_in = _embed(trg_ids, cfg.trg_vocab_size, cfg, trg_emb_name, seq_len)
    if checkpoints is not None:
        checkpoints.append(dec_in)
    dec_out = decoder(dec_in, enc_out, cfg, checkpoints, src_lens=src_lens)
    if checkpoints is not None:
        checkpoints.append(dec_out)

    logits = layers.fc(input=dec_out, size=cfg.trg_vocab_size,
                       num_flatten_dims=2, bias_attr=False,
                       name="logits_proj")
    logits2d = layers.reshape(logits, shape=[-1, cfg.trg_vocab_size])
    labels = layers.reshape(lbl_ids, shape=[-1, 1])
    loss_vec = layers.softmax_with_cross_entropy(
        logits=logits2d, label=labels,
        label_smooth_eps=cfg.label_smooth_eps or 0.0)
    return layers.mean(loss_vec), logits


def feed_shapes(batch_size, seq_len=256):
    return {
        "src_ids": ((batch_size, seq_len), "int64"),
        "trg_ids": ((batch_size, seq_len), "int64"),
        "lbl_ids": ((batch_size, seq_len), "int64"),
    }


def synthetic_batch(batch_size, cfg: TransformerConfig, seq_len=None,
                    seed=0):
    """Random token ids for the three feeds, from a numpy seed (the JAX
    package's draw, so both packages get the same batch)."""
    rng = np.random.RandomState(seed)
    seq_len = seq_len or cfg.max_length
    v = min(cfg.src_vocab_size, cfg.trg_vocab_size)
    return {
        "src_ids": rng.randint(0, v, size=(batch_size, seq_len)).astype(
            "int64"),
        "trg_ids": rng.randint(0, v, size=(batch_size, seq_len)).astype(
            "int64"),
        "lbl_ids": rng.randint(0, v, size=(batch_size, seq_len)).astype(
            "int64"),
    }


def _embed_rows(ids, vocab_size, cfg: TransformerConfig, param_name,
                table_len, tag):
    """Token embedding + sinusoid positions, with a decode-specific,
    length-suffixed position-table name."""
    emb = layers.embedding(input=ids, size=[vocab_size, cfg.d_model],
                           param_attr=ParamAttr(name=param_name))
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    pos = layers.create_parameter(
        shape=[table_len, cfg.d_model], dtype="float32",
        name=f"{param_name}_pos_{tag}{table_len}",
        default_initializer=NumpyArrayInitializer(
            _position_encoding(table_len, cfg.d_model)))
    pos.trainable = False
    pos.stop_gradient = True
    return layers.elementwise_add(x=emb, y=pos, axis=1), pos


def _decoder_sublayers(x, i, cfg: TransformerConfig, self_attn_fn,
                       cross_attn_fn):
    """One decoder layer with the self/cross attention cores injected."""
    h = _pre_ln(x, name=f"dec{i}_ln1")
    q = layers.fc(input=h, size=cfg.d_model, num_flatten_dims=2,
                  bias_attr=False, name=f"dec{i}_self_q")
    attn = self_attn_fn(q, h)
    attn = layers.fc(input=attn, size=cfg.d_model, num_flatten_dims=2,
                     bias_attr=False, name=f"dec{i}_self_out")
    x = layers.elementwise_add(x=x, y=attn)
    h = _pre_ln(x, name=f"dec{i}_ln2")
    q = layers.fc(input=h, size=cfg.d_model, num_flatten_dims=2,
                  bias_attr=False, name=f"dec{i}_cross_q")
    cross = cross_attn_fn(q)
    cross = layers.fc(input=cross, size=cfg.d_model, num_flatten_dims=2,
                      bias_attr=False, name=f"dec{i}_cross_out")
    x = layers.elementwise_add(x=x, y=cross)
    return layers.elementwise_add(
        x=x, y=_ffn(_pre_ln(x, name=f"dec{i}_ln3"), cfg, f"dec{i}_ffn"))


def _kv_fc(h, i, which, cfg: TransformerConfig):
    return (
        layers.fc(input=h, size=cfg.d_model, num_flatten_dims=2,
                  bias_attr=False, name=f"dec{i}_{which}_k"),
        layers.fc(input=h, size=cfg.d_model, num_flatten_dims=2,
                  bias_attr=False, name=f"dec{i}_{which}_v"),
    )


def build_decode(cfg: TransformerConfig = None, src_len=None, prefix_len=1,
                 max_len=None, verify_len=None, chunk_len=None):
    """Prefill + per-step decode programs as a decode.GenerationSpec.

    PREFILL (one causal pass over the [B, prefix_len] target prefix and the
    [B, src_len] source): fetches next-token logits at each row's last real
    prefix position plus, per decoder layer, the prefix's self-attention
    k/v rows (seeding the KV cache) and the encoder-side cross k/v.

    STEP (one new token): appends the token's k/v rows into the [B,
    max_len, H*D] caches at each row's cursor (kv_cache_append), attends
    single-query over the cache with seq_len = cursor + 1, and emits
    next-token logits.

    VERIFY (verify_len=k >= 2) and CHUNK (chunk_len=c >= 2): the Sq = k
    window of `_window_program`, for speculative verify and chunked
    prefill.  With chunk_len, ENCODE is the encoder-only pass that seeds
    the cross-attention k/v of a chunked prompt, which never runs the
    prefill program (transformer.py:542-696 of the JAX package)."""
    cfg = copy.copy(cfg or base())
    if cfg.moe_experts:
        raise NotImplementedError(
            "MoE FFNs land with the moe op family (ROADMAP.md A)")
    cfg.dropout = 0.0  # decode is inference
    src_len = src_len or cfg.max_length
    max_len = max_len or cfg.max_length
    hd = cfg.d_model

    src_emb_name = "src_word_emb"
    trg_emb_name = src_emb_name if cfg.tie_embeddings else "trg_word_emb"

    # ---- prefill ----------------------------------------------------
    prefill = Program()
    prefill_startup = Program()
    states = []
    with program_guard(prefill, prefill_startup), unique_name.guard():
        src_ids = layers.data(name="src_ids", shape=[src_len], dtype="int64")
        src_lens = layers.data(name="src_lens", shape=[], dtype="int64")
        trg_ids = layers.data(name="trg_ids", shape=[prefix_len],
                              dtype="int64")
        prefix_lens = layers.data(name="prefix_lens", shape=[],
                                  dtype="int64")
        enc_in, _ = _embed_rows(src_ids, cfg.src_vocab_size, cfg,
                                src_emb_name, src_len, "s")
        enc_out = encoder(enc_in, cfg, src_lens=src_lens)
        x, _ = _embed_rows(trg_ids, cfg.trg_vocab_size, cfg, trg_emb_name,
                           prefix_len, "p")
        for i in range(cfg.n_layer):
            kn = vn = ek = ev = None

            def self_attn(q, h, i=i):
                nonlocal kn, vn
                kn, vn = _kv_fc(h, i, "self", cfg)
                # ragged prefixes ride the causal mask alone: a pad row's
                # cache positions are overwritten by later appends before
                # the seq_len mask ever exposes them
                return layers.fused_attention(q, kn, vn, cfg.n_head,
                                              causal=True)

            def cross_attn(q, i=i):
                nonlocal ek, ev
                ek, ev = _kv_fc(enc_out, i, "cross", cfg)
                return layers.fused_attention(q, ek, ev, cfg.n_head,
                                              causal=False, seq_len=src_lens)

            x = _decoder_sublayers(x, i, cfg, self_attn, cross_attn)
            states += [
                decode_mod.StateSpec(feed=f"cache_k_{i}", init_from=kn.name,
                                     pad_to=max_len),
                decode_mod.StateSpec(feed=f"cache_v_{i}", init_from=vn.name,
                                     pad_to=max_len),
                decode_mod.StateSpec(feed=f"enc_k_{i}", init_from=ek.name),
                decode_mod.StateSpec(feed=f"enc_v_{i}", init_from=ev.name),
            ]
        x = _pre_ln(x, name="dec_ln")
        last = layers.sequence_last_step(x, seq_len=prefix_lens)
        prefill_logits = layers.fc(input=last, size=cfg.trg_vocab_size,
                                   bias_attr=False, name="logits_proj")

    # ---- step -------------------------------------------------------
    step = Program()
    step_startup = Program()
    with program_guard(step, step_startup), unique_name.guard():
        prev_ids = layers.data(name="prev_ids", shape=[1], dtype="int64")
        gen_lengths = layers.data(name="gen_lengths", shape=[],
                                  dtype="int64")
        src_lens_s = layers.data(name="src_lens", shape=[], dtype="int64")
        emb = layers.embedding(
            input=prev_ids, size=[cfg.trg_vocab_size, cfg.d_model],
            param_attr=ParamAttr(name=trg_emb_name),
        )  # ids [B, 1] strip the trailing 1 -> [B, d]
        emb = layers.reshape(layers.scale(emb, scale=cfg.d_model ** 0.5),
                             shape=[-1, 1, cfg.d_model])
        pos_tab = layers.create_parameter(
            shape=[max_len, cfg.d_model], dtype="float32",
            name=f"{trg_emb_name}_pos_m{max_len}",
            default_initializer=NumpyArrayInitializer(
                _position_encoding(max_len, cfg.d_model)))
        pos_tab.trainable = False
        pos_tab.stop_gradient = True
        pos = layers.gather(pos_tab, gen_lengths)  # this token's position
        x = layers.elementwise_add(
            x=emb, y=layers.reshape(pos, shape=[-1, 1, cfg.d_model]))
        new_lens = layers.increment(gen_lengths, value=1, in_place=False)
        for i in range(cfg.n_layer):
            st = states[4 * i:4 * i + 4]
            cache_k = layers.data(name=f"cache_k_{i}", shape=[max_len, hd])
            cache_v = layers.data(name=f"cache_v_{i}", shape=[max_len, hd])
            enc_k = layers.data(name=f"enc_k_{i}", shape=[src_len, hd])
            enc_v = layers.data(name=f"enc_v_{i}", shape=[src_len, hd])

            def self_attn(q, h, i=i, ck=cache_k, cv=cache_v, st=st):
                kn, vn = _kv_fc(h, i, "self", cfg)
                ok, ov = layers.kv_cache_append(ck, cv, kn, vn, gen_lengths)
                st[0].update = ok.name
                st[1].update = ov.name
                return layers.fused_attention(q, ok, ov, cfg.n_head,
                                              causal=False, seq_len=new_lens)

            def cross_attn(q, ek=enc_k, ev=enc_v):
                return layers.fused_attention(q, ek, ev, cfg.n_head,
                                              causal=False,
                                              seq_len=src_lens_s)

            x = _decoder_sublayers(x, i, cfg, self_attn, cross_attn)
        x = _pre_ln(x, name="dec_ln")
        logits = layers.fc(input=x, size=cfg.trg_vocab_size,
                           num_flatten_dims=2, bias_attr=False,
                           name="logits_proj")
        step_logits = layers.reshape(logits, shape=[-1, cfg.trg_vocab_size])

    # ---- Sq = k windows: speculative verify + chunked prefill -------
    def _window_program(k, update_attr):
        """One Sq = k ramp-masked pass: prev_ids [B, k] append at the
        cursor, query t attends keys < cursor + 1 + t.  Each row runs the
        step's ops on the step's weights (the embedding scale and one
        position gather per row), so its logits and appended rows are what
        one-at-a-time processing of those positions computes, up to the
        summation order of the wider matmuls.  `update_attr` names the
        StateSpec slot (verify_update / chunk_update) that records each
        cache's output, so one spec carries both programs."""
        prog, startup = Program(), Program()
        with program_guard(prog, startup), unique_name.guard():
            prev_ids = layers.data(name="prev_ids", shape=[k],
                                   dtype="int64")
            gen_lengths = layers.data(name="gen_lengths", shape=[],
                                      dtype="int64")
            src_lens_s = layers.data(name="src_lens", shape=[],
                                     dtype="int64")
            # ids [B, k] keep their axis -> [B, k, d]
            emb = layers.embedding(
                input=prev_ids, size=[cfg.trg_vocab_size, cfg.d_model],
                param_attr=ParamAttr(name=trg_emb_name))
            emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
            pos_tab = layers.create_parameter(
                shape=[max_len, cfg.d_model], dtype="float32",
                name=f"{trg_emb_name}_pos_m{max_len}",
                default_initializer=NumpyArrayInitializer(
                    _position_encoding(max_len, cfg.d_model)))
            pos_tab.trainable = False
            pos_tab.stop_gradient = True
            pos_rows = []
            for t in range(k):
                lens_t = gen_lengths if t == 0 else layers.increment(
                    gen_lengths, value=t, in_place=False)
                pos_rows.append(layers.reshape(
                    layers.gather(pos_tab, lens_t),
                    shape=[-1, 1, cfg.d_model]))
            x = layers.elementwise_add(
                x=emb, y=layers.concat(pos_rows, axis=1))
            new_lens = layers.increment(gen_lengths, value=1,
                                        in_place=False)
            for i in range(cfg.n_layer):
                st = states[4 * i:4 * i + 4]
                cache_k = layers.data(name=f"cache_k_{i}",
                                      shape=[max_len, hd])
                cache_v = layers.data(name=f"cache_v_{i}",
                                      shape=[max_len, hd])
                enc_k = layers.data(name=f"enc_k_{i}", shape=[src_len, hd])
                enc_v = layers.data(name=f"enc_v_{i}", shape=[src_len, hd])

                def self_attn(q, h, i=i, ck=cache_k, cv=cache_v, st=st):
                    kn, vn = _kv_fc(h, i, "self", cfg)
                    ok, ov = layers.kv_cache_append(ck, cv, kn, vn,
                                                    gen_lengths)
                    setattr(st[0], update_attr, ok.name)
                    setattr(st[1], update_attr, ov.name)
                    # per-query ramp: position t's key limit is
                    # cursor + 1 + t, so a rejected suffix stays masked
                    return layers.fused_attention(q, ok, ov, cfg.n_head,
                                                  causal=False,
                                                  seq_len=new_lens,
                                                  seq_len_ramp=True)

                def cross_attn(q, ek=enc_k, ev=enc_v):
                    return layers.fused_attention(q, ek, ev, cfg.n_head,
                                                  causal=False,
                                                  seq_len=src_lens_s)

                x = _decoder_sublayers(x, i, cfg, self_attn, cross_attn)
            x = _pre_ln(x, name="dec_ln")
            logits = layers.fc(input=x, size=cfg.trg_vocab_size,
                               num_flatten_dims=2, bias_attr=False,
                               name="logits_proj")
            out_logits = layers.reshape(logits,
                                        shape=[-1, cfg.trg_vocab_size])
        return prog, startup, out_logits.name

    verify = verify_startup = verify_logits_name = None
    if verify_len is not None:
        if int(verify_len) < 2:
            raise ValueError("verify_len must be >= 2 (a 1-wide verify "
                             "window is the plain step program)")
        verify, verify_startup, verify_logits_name = _window_program(
            int(verify_len), "verify_update")

    chunk = chunk_startup = chunk_logits_name = None
    encode = encode_startup = None
    if chunk_len is not None:
        if int(chunk_len) < 2:
            raise ValueError("chunk_len must be >= 2 (prompt tokens must "
                             "run the ramp window, not the Sq = 1 step)")
        chunk, chunk_startup, chunk_logits_name = _window_program(
            int(chunk_len), "chunk_update")
        # a chunked prompt never runs the prefill program: the constant
        # cross-attention k/v come from this encoder-only pass (the
        # prefill's encoder ops on the same weights)
        encode, encode_startup = Program(), Program()
        with program_guard(encode, encode_startup), unique_name.guard():
            src_ids = layers.data(name="src_ids", shape=[src_len],
                                  dtype="int64")
            src_lens_e = layers.data(name="src_lens", shape=[],
                                     dtype="int64")
            enc_in, _ = _embed_rows(src_ids, cfg.src_vocab_size, cfg,
                                    src_emb_name, src_len, "s")
            enc_out = encoder(enc_in, cfg, src_lens=src_lens_e)
            for i in range(cfg.n_layer):
                ek, ev = _kv_fc(enc_out, i, "cross", cfg)
                states[4 * i + 2].encode_from = ek.name
                states[4 * i + 3].encode_from = ev.name

    return decode_mod.GenerationSpec(
        prefill_program=prefill, prefill_startup=prefill_startup,
        step_program=step, step_startup=step_startup,
        prefill_feeds=["src_ids", "src_lens", "trg_ids", "prefix_lens"],
        prefill_logits=prefill_logits.name,
        step_feeds=["src_lens"],
        step_logits=step_logits.name,
        states=states,
        lengths_name="gen_lengths",
        init_lengths_from="prefix_lens",
        max_len=max_len,
        verify_program=verify, verify_startup=verify_startup,
        verify_logits=verify_logits_name,
        verify_len=None if verify is None else int(verify_len),
        chunk_program=chunk, chunk_startup=chunk_startup,
        chunk_logits=chunk_logits_name,
        chunk_len=None if chunk is None else int(chunk_len),
        encode_program=encode, encode_startup=encode_startup,
        prompt_ids_name="trg_ids",
    )


def clone_scope(scope):
    """Flat copy of a scope's var bindings (transformer.py:699): tensors
    are shared, rebinding a name stays local.  The int8 draft tier needs
    it to bake its weights without touching the target's."""
    from ..framework.scope import Scope

    out = Scope()
    for n in scope.local_var_names():
        out.set_var(n, scope.find_var(n))
    return out


def build_draft(cfg: TransformerConfig = None, src_len=None, prefix_len=1,
                max_len=None, tier="trunc", scope=None):
    """A cheap draft GenerationSpec for speculative decoding and the scope
    it runs against (transformer.py:726).

    tier='trunc': the target with the bottom half of its decoder layers
    (dec0..dec{L//2-1} with dec_ln, logits_proj and the embeddings); every
    parameter name is the target's, so the draft runs on the target's own
    scope (the returned scope is `scope`).  tier='int8' (the full-depth
    target quantized to int8) waits for the int8 ops and
    contrib/quantize.py (ROADMAP.md A4) and raises NotImplementedError."""
    cfg = cfg or base()
    if tier == "trunc":
        dcfg = copy.copy(cfg)
        dcfg.n_layer = max(1, cfg.n_layer // 2)
        return build_decode(dcfg, src_len=src_len, prefix_len=prefix_len,
                            max_len=max_len), scope
    if tier == "int8":
        raise NotImplementedError(
            "the int8 draft tier needs int8_ops and contrib/quantize.py, "
            "which are not ported yet (ROADMAP.md A4)")
    raise ValueError(f"unknown draft tier {tier!r} "
                     "(expected 'trunc' or 'int8')")
