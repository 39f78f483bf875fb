"""Sequence layer functions over padded batches + lengths
(paddle_tpu/layers/sequence.py): sequence_pool and sequence_last_step."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def _seq_inputs(x, seq_len):
    inputs = {"X": [x]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    return inputs


def sequence_pool(input, pool_type="average", seq_len=None, name=None):
    helper = LayerHelper("sequence_pool", **locals())
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    max_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_pool",
        inputs=_seq_inputs(input, seq_len),
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_last_step(input, seq_len=None):
    return sequence_pool(input, "last", seq_len=seq_len)
