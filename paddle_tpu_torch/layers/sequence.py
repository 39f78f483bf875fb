"""Sequence layer functions over padded batches + lengths
(paddle_tpu/layers/sequence.py): every layer takes an optional `seq_len`
Variable ([B] ints) where the reference read the LoD of its input at
runtime; paddle_tpu_torch/lod.py packs ragged lists into that form on
the host."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_conv",
    "sequence_pool",
    "sequence_softmax",
    "sequence_expand",
    "sequence_expand_as",
    "sequence_reverse",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_slice",
    "sequence_mask",
    "sequence_pad",
    "sequence_unpad",
    "sequence_concat",
    "sequence_enumerate",
    "sequence_erase",
]


def _seq_inputs(x, seq_len):
    inputs = {"X": [x]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    return inputs


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, seq_len=None, param_attr=None, bias_attr=None,
                  act=None, name=None):
    """Context-window conv over time (reference layers/nn.py sequence_conv)."""
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    d = input.shape[-1]
    filter_shape = [int(filter_size) * int(d), num_filters]
    filter_param = helper.create_parameter(
        attr=param_attr, shape=filter_shape, dtype=dtype
    )
    out = helper.create_variable_for_type_inference(dtype)
    inputs = _seq_inputs(input, seq_len)
    inputs["Filter"] = [filter_param]
    helper.append_op(
        type="sequence_conv",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={
            "contextStride": int(filter_stride),
            "contextStart": -int(filter_size // 2),
            "contextLength": int(filter_size),
        },
    )
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


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


def sequence_first_step(input, seq_len=None):
    return sequence_pool(input, "first", seq_len=seq_len)


def sequence_last_step(input, seq_len=None):
    return sequence_pool(input, "last", seq_len=seq_len)


def sequence_softmax(input, seq_len=None, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="sequence_softmax",
        inputs=_seq_inputs(input, seq_len),
        outputs={"Out": [out]},
    )
    return out


def sequence_expand(x, y, seq_len=None, ref_level=-1, name=None):
    """Broadcast per-row features of `x` along `y`'s time axis (reference
    layers/nn.py sequence_expand with ref_level=0 LoD semantics)."""
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    inputs = {"X": [x], "Y": [y]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="sequence_expand", inputs=inputs, outputs={"Out": [out]},
        attrs={"ref_level": ref_level},
    )
    return out


def sequence_expand_as(x, y, seq_len=None, name=None):
    helper = LayerHelper("sequence_expand_as", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    inputs = {"X": [x], "Y": [y]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="sequence_expand_as", inputs=inputs, outputs={"Out": [out]}
    )
    return out


def sequence_reverse(x, seq_len=None, name=None):
    helper = LayerHelper("sequence_reverse", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="sequence_reverse",
        inputs=_seq_inputs(x, seq_len),
        outputs={"Y": [out]},
    )
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def sequence_mask(x, maxlen, dtype="int64", name=None):
    """lengths [B] -> [B, maxlen] mask. `maxlen` must be static (TPU)."""
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
        attrs={"maxlen": int(maxlen), "out_dtype": dtype},
    )
    return out


def sequence_pad(x, pad_value=None, maxlen=None, seq_len=None, name=None):
    helper = LayerHelper("sequence_pad", **locals())
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    length = helper.create_variable_for_type_inference("int64")
    inputs = _seq_inputs(x, seq_len)
    if pad_value is not None:
        inputs["PadValue"] = [pad_value]
    helper.append_op(
        type="sequence_pad", inputs=inputs,
        outputs={"Out": [out], "Length": [length]},
        attrs={"padded_length": int(maxlen) if maxlen else -1},
    )
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="sequence_unpad",
        inputs={"X": [x], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def sequence_concat(input, seq_lens=None, name=None):
    helper = LayerHelper("sequence_concat", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    out_len = helper.create_variable_for_type_inference("int64")
    inputs = {"X": list(input)}
    if seq_lens is not None:
        inputs["SeqLen"] = list(seq_lens)
    helper.append_op(
        type="sequence_concat", inputs=inputs,
        outputs={"Out": [out], "OutLen": [out_len]},
    )
    return out


def sequence_enumerate(input, win_size, pad_value=0, seq_len=None, name=None):
    helper = LayerHelper("sequence_enumerate", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_enumerate",
        inputs=_seq_inputs(input, seq_len),
        outputs={"Out": [out]},
        attrs={"win_size": int(win_size), "pad_value": pad_value},
    )
    return out


def sequence_erase(input, tokens, seq_len=None, name=None):
    helper = LayerHelper("sequence_erase", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="sequence_erase",
        inputs=_seq_inputs(input, seq_len),
        outputs={"Out": [out], "OutLen": [out_len]},
        attrs={"tokens": list(tokens)},
    )
    return out, out_len
