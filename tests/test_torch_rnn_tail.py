"""The recurrent tail of the port (paddle_tpu_torch/ops/rnn_ops.py:
gru_unit, gru, lstm_unit, lstm, lstmp, fusion_lstm, fusion_gru,
attention_lstm, fused_embedding_fc_lstm, fusion_seqconv_eltadd_relu,
fusion_seqexpand_concat_fc) against the JAX package's lowerings, on the
CPU at tiny sizes.

Each case builds the op with a loss over its float outputs in both
packages, appends the backward and runs both Executors on the same
seeded numpy feed: every output, padded positions included, within rtol
1e-5 (atol 1e-6) of the JAX package's, and the input grads within rtol
1e-4 / atol 1e-5.  The cases cover is_reverse, ragged SeqLen (a row of
length 0 in attention_lstm), the peepholes in Bias[4D:7D], H0/C0, the
activations by name and by the reference's integer id, and
fused_embedding_fc_lstm's gate_layout "cifo".
"""

import numpy as np
import pytest

from paddle_tpu_torch import testing

from torch_op_parity import assert_op_and_grads

B, T, M, D, P, V, N = 3, 5, 3, 4, 2, 7, 6


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _f(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


LENS = np.array([5, 3, 1], np.int64)
LENS_WITH_EMPTY = np.array([5, 0, 2], np.int64)


def _cases():
    rng = np.random.RandomState(23)
    return {
        "gru_unit/names": (
            "gru_unit",
            {"Input": [_f(rng, B, 3 * D)], "HiddenPrev": [_f(rng, B, D)],
             "Weight": [_f(rng, D, 3 * D)], "Bias": [_f(rng, 1, 3 * D)]},
            {"gate_activation": "sigmoid", "activation": "tanh"},
            ["Input", "HiddenPrev", "Weight", "Bias"],
            {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1}, None),
        "gru_unit/ids": (
            "gru_unit",
            {"Input": [_f(rng, B, 3 * D)], "HiddenPrev": [_f(rng, B, D)],
             "Weight": [_f(rng, D, 3 * D)]},
            {"gate_activation": 1, "activation": 3},
            ["Input", "HiddenPrev", "Weight"],
            {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1}, None),
        "gru/ragged_reverse_h0_ids": (
            "gru",
            {"Input": [_f(rng, B, T, 3 * D)], "Weight": [_f(rng, D, 3 * D)],
             "Bias": [_f(rng, 1, 3 * D)], "H0": [_f(rng, B, D)],
             "SeqLen": [LENS]},
            {"is_reverse": True, "gate_activation": 1, "activation": 2},
            ["Input", "Weight", "Bias", "H0"],
            {"Hidden": 1, "BatchGate": 1, "BatchResetHiddenPrev": 1}, None),
        "gru/dense": (
            "gru",
            {"Input": [_f(rng, B, T, 3 * D)], "Weight": [_f(rng, D, 3 * D)]},
            {"gate_activation": "sigmoid", "activation": "relu"},
            ["Input", "Weight"], {"Hidden": 1},
            {"BatchGate": 1, "BatchResetHiddenPrev": 1}),
        "lstm_unit/forget_bias": (
            "lstm_unit",
            {"X": [_f(rng, B, 4 * D)], "C_prev": [_f(rng, B, D)]},
            {"forget_bias": 1.0}, ["X", "C_prev"], {"C": 1, "H": 1}, None),
        "lstm/peepholes_ragged_reverse_h0c0_ids": (
            "lstm",
            {"Input": [_f(rng, B, T, 4 * D)], "Weight": [_f(rng, D, 4 * D)],
             "Bias": [_f(rng, 1, 7 * D)], "H0": [_f(rng, B, D)],
             "C0": [_f(rng, B, D)], "SeqLen": [LENS]},
            {"is_reverse": True, "use_peepholes": True,
             "gate_activation": 1, "cell_activation": 2,
             "candidate_activation": 3},
            ["Input", "Weight", "Bias", "H0", "C0"],
            {"Hidden": 1, "Cell": 1}, None),
        "lstm/dense_names": (
            "lstm",
            {"Input": [_f(rng, B, T, 4 * D)], "Weight": [_f(rng, D, 4 * D)],
             "Bias": [_f(rng, 1, 4 * D)]},
            {"gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "relu"},
            ["Input", "Weight", "Bias"], {"Hidden": 1, "Cell": 1}, None),
        "lstmp/peepholes_ragged_reverse": (
            "lstmp",
            {"Input": [_f(rng, B, T, 4 * D)], "Weight": [_f(rng, P, 4 * D)],
             "ProjWeight": [_f(rng, D, P)], "Bias": [_f(rng, 1, 7 * D)],
             "H0": [_f(rng, B, P)], "C0": [_f(rng, B, D)],
             "SeqLen": [LENS]},
            {"is_reverse": True, "use_peepholes": True},
            ["Input", "Weight", "ProjWeight", "Bias", "H0", "C0"],
            {"Projection": 1, "Cell": 1}, None),
        "fusion_lstm/peepholes_reverse_h0c0": (
            "fusion_lstm",
            {"X": [_f(rng, B, T, M)], "WeightX": [_f(rng, M, 4 * D)],
             "WeightH": [_f(rng, D, 4 * D)], "Bias": [_f(rng, 1, 7 * D)],
             "H0": [_f(rng, B, D)], "C0": [_f(rng, B, D)]},
            {"is_reverse": True, "use_peepholes": True},
            ["X", "WeightX", "WeightH", "Bias", "H0", "C0"],
            {"Hidden": 1, "Cell": 1, "XX": 1}, None),
        "fusion_lstm/dense": (
            "fusion_lstm",
            {"X": [_f(rng, B, T, M)], "WeightX": [_f(rng, M, 4 * D)],
             "WeightH": [_f(rng, D, 4 * D)], "Bias": [_f(rng, 1, 4 * D)]},
            {}, ["X", "WeightX", "WeightH", "Bias"], {"Hidden": 1},
            {"Cell": 1, "XX": 1}),
        "fusion_gru/reverse_h0": (
            "fusion_gru",
            {"X": [_f(rng, B, T, M)], "WeightX": [_f(rng, M, 3 * D)],
             "WeightH": [_f(rng, D, 3 * D)], "Bias": [_f(rng, 1, 3 * D)],
             "H0": [_f(rng, B, D)]},
            {"is_reverse": True},
            ["X", "WeightX", "WeightH", "Bias", "H0"],
            {"Hidden": 1, "XX": 1}, None),
        "attention_lstm/ragged_empty_row_scalars": (
            "attention_lstm",
            {"X": [_f(rng, B, T, M)], "C0": [_f(rng, B, D)],
             "H0": [_f(rng, B, D)], "SeqLen": [LENS_WITH_EMPTY],
             "AttentionWeight": [_f(rng, M + D, 1)],
             "AttentionBias": [_f(rng, 1, 1)],
             "AttentionScalar": [_f(rng, 1, 1) + 1.0],
             "AttentionScalarBias": [_f(rng, 1, 1)],
             "LSTMWeight": [_f(rng, D + M, 4 * D)],
             "LSTMBias": [_f(rng, 1, 4 * D)]},
            {"gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "relu"},
            ["X", "C0", "H0", "AttentionWeight", "AttentionBias",
             "AttentionScalar", "AttentionScalarBias", "LSTMWeight",
             "LSTMBias"],
            {"Hidden": 1, "Cell": 1}, None),
        "attention_lstm/dense": (
            "attention_lstm",
            {"X": [_f(rng, B, T, M)], "C0": [_f(rng, B, D)],
             "AttentionWeight": [_f(rng, M + D, 1)],
             "LSTMWeight": [_f(rng, D + M, 4 * D)],
             "LSTMBias": [_f(rng, 1, 4 * D)]},
            {}, ["X", "C0", "AttentionWeight", "LSTMWeight", "LSTMBias"],
            {"Hidden": 1, "Cell": 1}, None),
        "fused_embedding_fc_lstm/ifgo_peepholes_h0c0": (
            "fused_embedding_fc_lstm",
            {"Ids": [rng.randint(0, V, (B, T, 1)).astype(np.int64)],
             "Embeddings": [_f(rng, V, 4 * D)],
             "WeightH": [_f(rng, D, 4 * D)], "Bias": [_f(rng, 1, 7 * D)],
             "H0": [_f(rng, B, D)], "C0": [_f(rng, B, D)]},
            {"use_peepholes": True},
            ["Embeddings", "WeightH", "Bias", "H0", "C0"],
            {"Hidden": 1, "Cell": 1, "XX": 1}, None),
        "fused_embedding_fc_lstm/cifo_reverse": (
            "fused_embedding_fc_lstm",
            {"Ids": [rng.randint(0, V, (B, T)).astype(np.int64)],
             "Embeddings": [_f(rng, V, 4 * D)],
             "WeightH": [_f(rng, D, 4 * D)], "Bias": [_f(rng, 1, 4 * D)]},
            {"gate_layout": "cifo", "is_reverse": True},
            ["Embeddings", "WeightH"],
            {"Hidden": 1, "Cell": 1, "XX": 1}, None),
        "fusion_seqconv_eltadd_relu/ragged": (
            "fusion_seqconv_eltadd_relu",
            {"X": [_f(rng, B, T, M)], "Filter": [_f(rng, 3 * M, N)],
             "Bias": [_f(rng, 1, N)], "SeqLen": [LENS]},
            {"contextLength": 3, "contextStart": -1, "contextStride": 1},
            ["X", "Filter", "Bias"], {"Out": 1, "ColMat": 1}, None),
        "fusion_seqexpand_concat_fc/ragged_tanh": (
            "fusion_seqexpand_concat_fc",
            {"X": [_f(rng, B, T, M), _f(rng, B, 2), _f(rng, B, 3)],
             "FCWeight": [_f(rng, M + 5, N)], "FCBias": [_f(rng, 1, N)],
             "SeqLen": [LENS]},
            {"fc_activation": "tanh"},
            ["X", "FCWeight", "FCBias"], {"Out": 1}, {"FCOut": 1}),
    }


CASES = _cases()


def test_the_cases_cover_the_eleven_op_types():
    assert sorted({c[0] for c in CASES.values()}) == sorted([
        "gru_unit", "gru", "lstm_unit", "lstm", "lstmp", "fusion_lstm",
        "fusion_gru", "attention_lstm", "fused_embedding_fc_lstm",
        "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case):
    op_type, inputs, attrs, diff, outs, more = CASES[case]
    assert_op_and_grads(op_type, inputs, attrs, diff, outs, more)
