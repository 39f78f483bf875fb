"""Neural-network layer functions of the ported slices (counterparts of
paddle_tpu/layers/nn.py:18-1250): each appends ops to the default main
program and returns output Variables; nothing executes here.  Helper
names, parameter names and attrs are the JAX package's, so both packages
build the same Program."""

from __future__ import annotations

import copy

import numpy as np

from ..framework.framework import Variable
from ..layer_helper import LayerHelper, ParamAttr


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: one mul a input (each with its own weight), their
    `sum` when there are several, then bias add and activation."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    inputs = helper.multiple_input()
    param_attrs = (param_attr if isinstance(param_attr, (list, tuple))
                   else [param_attr] * len(inputs))
    mul_results = []
    for x, pa in zip(inputs, param_attrs):
        in_features = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(attr=pa, shape=[in_features, size],
                                    dtype=dtype, is_bias=False)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [x], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
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
    does."""
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


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """NCHW transposed conv: an IOHW filter [C, num_filters / groups, kh,
    kw] (its size from output_size when filter_size is not given), a
    per-channel bias, then the activation."""
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("either filter_size or output_size required")
        output_size = _pair(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in range(2)]
    else:
        filter_size = _pair(filter_size)
    filter_shape = [num_channels, num_filters // groups] + filter_size
    w = helper.create_parameter(attr=param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
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


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalisation across channels (NCHW): Out and the
    op's MidOut (k + alpha * windowed sum of squares)."""
    helper = LayerHelper("lrn", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type="lrn", inputs={"X": [input]},
        outputs={"Out": [out], "MidOut": [mid]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


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


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_pow", x, y, axis, act, name)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="mul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})
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


def _reduce_layer(op_type, input, dim, keep_dim, name):
    """Reduce over `dim`, or over everything (reduce_all) when dim is
    None."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", input, dim, keep_dim, name)


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


def prelu(x, mode, param_attr=None, name=None):
    """Alpha, initialised to 0.25, has shape [1] ("all"), [1, C, 1, 1]
    ("channel") or [1] + x.shape[1:] ("element")."""
    helper = LayerHelper("prelu", **locals())
    from ..initializer import ConstantInitializer

    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [1, x.shape[1], 1, 1]
    else:
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
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


def fused_linear_cross_entropy(input, label, size, label_smooth_eps=0.0,
                               ignore_index=-100, chunks=8, param_attr=None,
                               weight=None, transpose_w=False, name=None):
    """The vocabulary projection fused with softmax cross entropy
    (ops/loss_ops.py linear_softmax_ce): input [..., d] flattened to [N, d],
    the [N, size] logits computed tile by tile.  The math of fc(bias_attr=
    False) + softmax_with_cross_entropy(label_smooth_eps=...).  `weight`
    projects with an existing parameter instead of a new [d, size] one,
    e.g. a tied [size, d] word embedding with transpose_w=True.  Returns
    the per-row Loss [N, 1]."""
    helper = LayerHelper("linear_softmax_ce", **locals())
    dtype = helper.input_dtype()
    in_features = int(input.shape[-1])
    if weight is None:
        w = helper.create_parameter(attr=param_attr,
                                    shape=[in_features, size], dtype=dtype,
                                    is_bias=False)
    else:
        if param_attr is not None:
            raise ValueError(
                "fused_linear_cross_entropy: param_attr has no effect when "
                "an existing `weight` is passed — set attrs on that "
                "parameter instead")
        w = weight
        want = [size, in_features] if transpose_w else [in_features, size]
        if list(w.shape) != want:
            raise ValueError(
                f"fused_linear_cross_entropy: weight shape {list(w.shape)} "
                f"!= {want} (transpose_w={transpose_w})")
    x2d = reshape(input, shape=[-1, in_features])
    lbl2d = reshape(label, shape=[-1, 1])
    loss = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="linear_softmax_ce",
        inputs={"X": [x2d], "W": [w], "Label": [lbl2d]},
        outputs={"Loss": [loss]},
        attrs={"label_smooth_eps": label_smooth_eps,
               "ignore_index": ignore_index, "chunks": chunks,
               "transpose_w": bool(transpose_w)},
    )
    return loss


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None):
    """The logistic loss of logits `x` against 0/1 `label`, elementwise;
    0 where label == ignore_index."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index})
    return out


def square_error_cost(input, label):
    """(input - label)^2, elementwise."""
    helper = LayerHelper("square_error_cost", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
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


def _rnn_params(helper, input, hidden_size, gates, param_attr, bias_attr):
    d = input.shape[-1]
    wx = helper.create_parameter(attr=_suffixed_attr(param_attr, "wx"),
                                 shape=[d, gates * hidden_size],
                                 dtype=input.dtype)
    wh = helper.create_parameter(attr=_suffixed_attr(param_attr, "wh"),
                                 shape=[hidden_size, gates * hidden_size],
                                 dtype=input.dtype)
    b = helper.create_parameter(attr=bias_attr, shape=[gates * hidden_size],
                                dtype=input.dtype, is_bias=True)
    return {"X": [input], "WeightX": [wx], "WeightH": [wh], "Bias": [b]}


def lstm(input, hidden_size, *, param_attr=None, bias_attr=None,
         is_reverse=False, name=None):
    """One LSTM layer over [B, S, D] -> ([B, S, H], last hidden, last
    cell): one `fused_lstm` op, WeightX [D, 4H] and WeightH [H, 4H]
    (named `<param_attr>_wx` / `_wh` when the attr has a name)."""
    helper = LayerHelper("lstm", **locals())
    inputs = _rnn_params(helper, input, hidden_size, 4, param_attr,
                         bias_attr)
    out, last_h, last_c = (helper.create_variable_for_type_inference(
        input.dtype) for _ in range(3))
    helper.append_op(
        type="fused_lstm", inputs=inputs,
        outputs={"Out": [out], "LastH": [last_h], "LastC": [last_c]},
        attrs={"is_reverse": is_reverse})
    return out, last_h, last_c


def gru(input, hidden_size, *, param_attr=None, bias_attr=None,
        is_reverse=False, h0=None, name=None):
    """One GRU layer over [B, S, D] -> ([B, S, H], last hidden): one
    `fused_gru` op; h0 [B, H] is the optional initial hidden state (the
    translator's decode step carries it)."""
    helper = LayerHelper("gru", **locals())
    inputs = _rnn_params(helper, input, hidden_size, 3, param_attr,
                         bias_attr)
    if h0 is not None:
        inputs["H0"] = [h0]
    out, last_h = (helper.create_variable_for_type_inference(input.dtype)
                   for _ in range(2))
    helper.append_op(type="fused_gru", inputs=inputs,
                     outputs={"Out": [out], "LastH": [last_h]},
                     attrs={"is_reverse": is_reverse})
    return out, last_h


# ------------------------------------------ structured and sampled losses


def linear_chain_crf(input, label, param_attr=None, seq_len=None, name=None):
    """CRF negative log likelihood [B, 1]; creates the [(D+2), D]
    transition parameter."""
    helper = LayerHelper("linear_chain_crf", **locals())
    dtype = helper.input_dtype()
    size = input.shape[-1]
    transition = helper.create_parameter(attr=param_attr,
                                         shape=[size + 2, size], dtype=dtype)
    alpha, emission_exps, transition_exps, log_likelihood = (
        helper.create_variable_for_type_inference(dtype) for _ in range(4))
    inputs = {"Emission": [input], "Transition": [transition],
              "Label": [label]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="linear_chain_crf", inputs=inputs,
        outputs={"Alpha": [alpha], "EmissionExps": [emission_exps],
                 "TransitionExps": [transition_exps],
                 "LogLikelihood": [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None, seq_len=None, name=None):
    """Viterbi decode [B, T] with the transition parameter that
    linear_chain_crf created, named by `param_attr` (a name or a
    ParamAttr)."""
    helper = LayerHelper("crf_decoding", **locals())
    transition = helper.main_program.global_block().var(
        param_attr if isinstance(param_attr, str) else param_attr.name)
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    return path


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None, name=None):
    """CTC loss [B, 1] over padded [B, T, C+1] logits."""
    helper = LayerHelper("warpctc", **locals())
    loss = helper.create_variable_for_type_inference(helper.input_dtype())
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op(
        type="warpctc", inputs=inputs, outputs={"Loss": [loss]},
        attrs={"blank": int(blank), "norm_by_times": bool(norm_by_times)})
    return loss


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance [B, 1] and the sequence count [1]."""
    helper = LayerHelper("edit_distance", **locals())
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    inputs = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        inputs["HypsLength"] = [input_length]
    if label_length is not None:
        inputs["RefsLength"] = [label_length]
    helper.append_op(
        type="edit_distance", inputs=inputs,
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": bool(normalized)})
    return out, seq_num


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, sampler="uniform", seed=0,
        name=None):
    """Noise-contrastive estimation cost [B, 1]; creates the [C, D] weight
    and the [C] bias."""
    helper = LayerHelper("nce", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[-1]
    num_neg = int(num_neg_samples) if num_neg_samples is not None else 10
    w = helper.create_parameter(attr=param_attr,
                                shape=[num_total_classes, dim], dtype=dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=bias_attr, shape=[num_total_classes], dtype=dtype,
            is_bias=True)]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    cost, sample_logits = (helper.create_variable_for_type_inference(dtype)
                           for _ in range(2))
    sample_labels = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": num_neg, "sampler": sampler,
               "seed": int(seed)})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid cost [B, 1] over a complete binary tree of the
    classes; creates the [C-1, D] weight and bias."""
    helper = LayerHelper("hierarchical_sigmoid", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[-1]
    w = helper.create_parameter(attr=param_attr, shape=[num_classes - 1, dim],
                                dtype=dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=bias_attr, shape=[num_classes - 1], dtype=dtype,
            is_bias=True)]
    out, pre_out = (helper.create_variable_for_type_inference(dtype)
                    for _ in range(2))
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out], "PreOut": [pre_out]},
                     attrs={"num_classes": int(num_classes)})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss", **locals())
    diff = helper.create_variable_for_type_inference(x.dtype)
    loss = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC (reference layers/metric_op.py auc): the bucket
    counts are two int64 persistables of the program, zeroed by the
    startup; -> (the float64 AUC, [stat_pos, stat_neg])."""
    from ..initializer import ConstantInitializer

    helper = LayerHelper("auc", **locals())
    stat_pos, _ = helper.create_or_get_global_variable(
        helper.name + "_stat_pos", shape=[num_thresholds + 1], dtype="int64")
    stat_neg, _ = helper.create_or_get_global_variable(
        helper.name + "_stat_neg", shape=[num_thresholds + 1], dtype="int64")
    for v in (stat_pos, stat_neg):
        v.stop_gradient = True
        helper.set_variable_initializer(v, ConstantInitializer(0))
    auc_out = helper.create_variable_for_type_inference("float64",
                                                        stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label], "StatPos": [stat_pos],
                "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_len=None):
    """Precision, recall and F1 of chunk detection over dense [B, T]
    labels and an optional seq_len; -> (precision, recall, f1,
    num_infer, num_label, num_correct), the counts int32 as the JAX
    package's."""
    helper = LayerHelper("chunk_eval", **locals())
    outs = {
        name: helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
        for name, dtype in [
            ("Precision", "float32"), ("Recall", "float32"),
            ("F1-Score", "float32"), ("NumInferChunks", "int32"),
            ("NumLabelChunks", "int32"), ("NumCorrectChunks", "int32")]
    }
    inputs = {"Inference": [input], "Label": [label]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="chunk_eval", inputs=inputs,
        outputs={k: [v] for k, v in outs.items()},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    return (outs["Precision"], outs["Recall"], outs["F1-Score"],
            outs["NumInferChunks"], outs["NumLabelChunks"],
            outs["NumCorrectChunks"])


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": axes})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": axes})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": perm})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """num_or_sections: a count of equal parts, or the part sizes; ->
    the list of parts."""
    helper = LayerHelper("split", **locals())
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value)})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper("scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / ||x|| along `axis` (the `norm` op)."""
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def dot_product_attention(querys, keys, values):
    """softmax(Q K^T / sqrt(d)) V from matmul and softmax ops."""
    product = matmul(querys, keys, transpose_y=True,
                     alpha=float(keys.shape[-1]) ** -0.5)
    return matmul(softmax(product), values)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR"):
    """-> bilinear_interp or nearest_interp to out_shape (or the input's
    size times scale)."""
    helper = LayerHelper("image_resize", **locals())
    op_type = "bilinear_interp" if resample == "BILINEAR" else (
        "nearest_interp")
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"out_h": int(out_shape[0]),
                            "out_w": int(out_shape[1])})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "NEAREST")


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": _pair(filter_size),
                            "strides": _pair(stride),
                            "paddings": _pair(padding) + _pair(padding)})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_first_step=None, return_parent_idx=False,
                name=None):
    """reference layers/nn.py:3080 — one beam-search step for user-built
    While decoders.  Dense [B, beam] form (the LoD `level` grouping is the
    explicit batch dim here; the arg is kept for signature parity and
    ignored).  `is_first_step` may be a bool (static) or a bool Variable
    (flipped inside a While body).  Returns (selected_ids,
    selected_scores[, parent_idx if return_parent_idx]) — parent_idx is
    the source-beam gather index for reordering decoder state."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    sel_scores = helper.create_variable_for_type_inference(
        pre_scores.dtype, stop_gradient=True)
    parent = helper.create_variable_for_type_inference("int32",
                                                       stop_gradient=True)
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "ids": [ids], "scores": [scores]}
    attrs = {"beam_size": int(beam_size), "end_id": int(end_id)}
    if isinstance(is_first_step, (bool, np.bool_)):
        attrs["is_first_step"] = bool(is_first_step)
    elif is_first_step is not None:
        if not isinstance(is_first_step, Variable):
            raise TypeError(
                "is_first_step must be a bool or a bool Variable, got "
                f"{type(is_first_step).__name__}")
        inputs["IsFirstStep"] = [is_first_step]
    helper.append_op(
        type="beam_search",
        inputs=inputs,
        outputs={"selected_ids": [sel_ids],
                 "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs=attrs,
    )
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def top_k_gating(logits, k=2, capacity_factor=0.0, renormalize=True,
                 name=None):
    """MoE router over [N, E] logits (ops/moe_ops.py): softmax, the top-k
    experts of each token, GShard capacity.  capacity_factor <= 0 or
    infinite means nothing drops (the serving tier's mode).

    Returns (gates, indices, positions, aux_loss, load, dropped): gates
    [N, k] (capacity-masked, differentiable to the router),
    indices/positions [N, k] int32, aux_loss [1] to fold into the
    objective, load [E] and dropped [1], metrics the serving monitor
    fetches (moe.gating_fetches)."""
    helper = LayerHelper("top_k_gating", **locals())
    dtype = logits.dtype
    gates = helper.create_variable_for_type_inference(dtype)
    indices = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    positions = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    aux = helper.create_variable_for_type_inference(dtype)
    load = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    dropped = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    cf = float(capacity_factor)
    if not np.isfinite(cf):
        cf = 0.0  # "infinite" spelled as the attr's JSON-safe 0
    helper.append_op(
        type="top_k_gating",
        inputs={"Logits": [logits]},
        outputs={"Gates": [gates], "Indices": [indices],
                 "Positions": [positions], "AuxLoss": [aux],
                 "Load": [load], "Dropped": [dropped]},
        attrs={"k": int(k), "capacity_factor": cf,
               "renormalize": bool(renormalize)},
    )
    return gates, indices, positions, aux, load, dropped


def moe_ffn(x, num_experts, d_inner, top_k=2, capacity_factor=0.0,
            act="relu", renormalize=True, name=None):
    """Mixture-of-experts FFN: a router fc (no bias) -> top_k_gating ->
    moe_expert_ffn over expert-major weights; a drop-in for the dense
    fc(d_inner, act) -> fc(d_model) pair at k/E of its FLOPs a token.
    x [..., d_model] routes a token over its leading dims (the ops
    flatten inside).  Parameters carry explicit names, so that the decode
    programs land on the training scope's: `{name}_gate.w_0` [d, E],
    `{name}_moe_w1` [E, d, f], `{name}_moe_b1` [E, f], `{name}_moe_w2`
    [E, f, d], `{name}_moe_b2` [E, d].

    Returns (out, aux_loss); fold aux_loss, scaled, into the objective or
    the router collapses onto one expert."""
    helper = LayerHelper("moe_ffn", **locals())
    dtype = x.dtype
    d_model = int(x.shape[-1])

    def _p(suffix, shape, is_bias=False):
        attr = ParamAttr._to_attr(None)
        attr.name = f"{helper.name}_{suffix}"
        return helper.create_parameter(attr=attr, shape=shape, dtype=dtype,
                                       is_bias=is_bias)

    logits = fc(x, num_experts, num_flatten_dims=len(x.shape) - 1,
                bias_attr=False, name=f"{helper.name}_gate")
    gates, idx, pos, aux, _load, _dropped = top_k_gating(
        logits, k=top_k, capacity_factor=capacity_factor,
        renormalize=renormalize, name=f"{helper.name}_gating")
    w1 = _p("moe_w1", [num_experts, d_model, d_inner])
    b1 = _p("moe_b1", [num_experts, d_inner], is_bias=True)
    w2 = _p("moe_w2", [num_experts, d_inner, d_model])
    b2 = _p("moe_b2", [num_experts, d_model], is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    cf = float(capacity_factor)
    if not np.isfinite(cf):
        cf = 0.0
    helper.append_op(
        type="moe_expert_ffn",
        inputs={"X": [x], "Gates": [gates], "Indices": [idx],
                "Positions": [pos], "W1": [w1], "B1": [b1],
                "W2": [w2], "B2": [b2]},
        outputs={"Out": [out]},
        attrs={"k": int(top_k), "capacity_factor": cf, "act": act},
    )
    return out, aux
