"""Neural-network layer functions of the ported slices (counterparts of
paddle_tpu/layers/nn.py:18-1178): each appends ops to the default main
program and returns output Variables; nothing executes here.  Helper
names, parameter names and attrs are the JAX package's, so both packages
build the same Program."""

from __future__ import annotations

import copy

import numpy as np

from ..layer_helper import LayerHelper, ParamAttr


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: mul + bias add + activation."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    inputs = helper.multiple_input()
    if len(inputs) != 1:
        raise NotImplementedError(
            "fc over several inputs needs the `sum` op, which is not on the "
            "serving slice (ROADMAP A)")
    (x,) = inputs
    in_features = int(np.prod(x.shape[num_flatten_dims:]))
    w = helper.create_parameter(attr=param_attr, shape=[in_features, size],
                                dtype=dtype, is_bias=False)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [x], "Y": [w]},
        outputs={"Out": [pre_bias]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """-> lookup_table op."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=param_attr, shape=size, dtype=dtype,
                                is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = (
        -1 if padding_idx is None
        else padding_idx if padding_idx >= 0 else (size[0] + padding_idx)
    )
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={
            "is_sparse": is_sparse,
            "is_distributed": is_distributed,
            "padding_idx": padding_idx,
            # decided from the DECLARED ids shape: [..., 1] strips the 1
            "strip_trailing_one": (
                input.shape is not None and len(input.shape) >= 1
                and input.shape[-1] == 1
            ),
        },
    )
    return out


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """NCHW conv2d: Normal(0, sqrt(2 / fan_in)) OIHW filters, a
    per-channel bias over dim 1, then the activation.  With groups equal
    to the input channels it emits depthwise_conv2d, as the JAX package
    does; that op is not ported yet (ROADMAP A)."""
    from ..initializer import NormalInitializer

    helper = LayerHelper("conv2d", **locals())
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _pair(filter_size)
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        attr=param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type=("conv2d" if groups == 1 or groups != num_channels
              else "depthwise_conv2d"),
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups,
               "use_cudnn": use_cudnn},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive},
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Scale and Bias are trainable parameters; the moving mean and
    variance are persistable, non-trainable parameters that the op
    updates in place (MeanOut/VarianceOut are the same vars).  The op's
    fused `act` attr stays None and the activation is its own op, as in
    the JAX package."""
    from ..initializer import ConstantInitializer

    helper = LayerHelper("batch_norm", **locals())
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        attr=param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    stats = []
    for stat_name, value in ((moving_mean_name, 0.0),
                             (moving_variance_name, 1.0)):
        v = helper.create_parameter(
            attr=ParamAttr(name=stat_name, trainable=False,
                           do_model_average=do_model_average_for_mean_and_var),
            shape=[c], dtype=dtype,
            default_initializer=ConstantInitializer(value))
        v.stop_gradient = True
        stats.append(v)
    mean, variance = stats
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats, "act": None},
    )
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = input.dtype
    norm_size = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input]}
    from ..initializer import ConstantInitializer

    if scale:
        s = helper.create_parameter(
            attr=param_attr, shape=[norm_size], dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(attr=bias_attr, shape=[norm_size],
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """-> dropout op (Out and its Mask); `seed` is stored as 0 when None."""
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def reshape(x, shape, name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape]})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    if act:
        helper.kwargs["act"] = act
        return helper.append_activation(out)
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_pow", x, y, axis, act, name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)},
    )
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="slice", inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts),
               "ends": list(ends)},
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    """Sum over `dim`, or over everything (reduce_all) when dim is None."""
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type="reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out) if act else out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, label_smooth_eps=0.0):
    """label_smooth_eps > 0 (hard labels only) fuses uniform label
    smoothing without building the smoothed [N, V] distribution."""
    if soft_label and label_smooth_eps:
        raise ValueError(
            "label_smooth_eps requires hard labels (soft_label=False); "
            "smooth soft labels yourself before the call")
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "label_smooth_eps": label_smooth_eps},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy", inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k + accuracy: the fraction of rows whose top k hit the label."""
    helper = LayerHelper("accuracy", **locals())
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]},
    )
    return acc_out


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def fused_attention(q, k, v, num_heads, causal=False, scale=0.0, bias=None,
                    seq_len=None, seq_len_ramp=False, name=None):
    """Fused scaled-dot-product attention over [B, S, H*D] projections —
    one `fused_attention` op; seq_len [B] is the key-padding length.
    seq_len_ramp: query t's key limit is seq_len[b] + t instead of one
    limit per row (the Sq = k verify and chunk windows; the composite
    computes it)."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    attrs = {"num_heads": num_heads, "causal": causal, "scale": scale}
    if seq_len_ramp:
        attrs["seq_len_ramp"] = True
    helper.append_op(type="fused_attention", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def kv_cache_append(cache_k, cache_v, k, v, lengths, name=None):
    """Decode-step cache write: k/v [B, T, ...] rows land in cache_k/cache_v
    [B, max_len, ...] at per-row cursors `lengths` [B].  Returns the
    updated (cache_k, cache_v); cursors stay caller-owned."""
    helper = LayerHelper("kv_cache_append", name=name)
    out_k = helper.create_variable_for_type_inference(cache_k.dtype)
    out_v = helper.create_variable_for_type_inference(cache_v.dtype)
    helper.append_op(
        type="kv_cache_append",
        inputs={"CacheK": [cache_k], "CacheV": [cache_v],
                "K": [k], "V": [v], "Lengths": [lengths]},
        outputs={"OutK": [out_k], "OutV": [out_v]},
    )
    return out_k, out_v


def _suffixed_attr(attr, suffix):
    """Clone a ParamAttr with a per-weight name suffix."""
    attr = ParamAttr._to_attr(attr)
    if attr is None or attr is False or attr.name is None:
        return attr
    new = copy.copy(attr)
    new.name = f"{attr.name}_{suffix}"
    return new


def multi_head_attention(queries, keys=None, values=None, *, d_model,
                         num_heads, causal=False, attn_bias=None,
                         attn_seq_len=None, param_attr=None, name=None):
    """q/k/v/out projections around the fused attention op; keys/values
    default to queries (self-attention)."""
    keys = queries if keys is None else keys
    values = keys if values is None else values
    q = fc(input=queries, size=d_model, num_flatten_dims=2,
           param_attr=_suffixed_attr(param_attr, "q"), bias_attr=False,
           name=f"{name}_q" if name else None)
    k = fc(input=keys, size=d_model, num_flatten_dims=2,
           param_attr=_suffixed_attr(param_attr, "k"), bias_attr=False,
           name=f"{name}_k" if name else None)
    v = fc(input=values, size=d_model, num_flatten_dims=2,
           param_attr=_suffixed_attr(param_attr, "v"), bias_attr=False,
           name=f"{name}_v" if name else None)
    ctx = fused_attention(q, k, v, num_heads, causal=causal, bias=attn_bias,
                          seq_len=attn_seq_len)
    return fc(input=ctx, size=d_model, num_flatten_dims=2,
              param_attr=_suffixed_attr(param_attr, "o"), bias_attr=False,
              name=f"{name}_out" if name else None)
