"""Composite networks built from layers (counterpart of
paddle_tpu/nets.py:12-164; reference python/paddle/fluid/nets.py):
`simple_img_conv_pool`, `img_conv_group` (the VGG block),
`sequence_conv_pool`, `glu` and `scaled_dot_product_attention`, the
reference's multi-head attention from primitive ops."""

from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """One conv2d (bias, activation), then one pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """Stacked convs (each optionally followed by a batch norm and a
    dropout), then one pool: the VGG block.  Every per-conv argument is a
    scalar for all convs or a list of one value a conv."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple")

    def _extend(arg):
        if not hasattr(arg, "__len__") or isinstance(arg, str):
            return [arg] * len(conv_num_filter)
        return list(arg)

    conv_padding = _extend(conv_padding)
    conv_filter_size = _extend(conv_filter_size)
    param_attr = _extend(param_attr)
    conv_with_batchnorm = _extend(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _extend(conv_batchnorm_drop_rate)

    tmp = input
    for i, num_filters in enumerate(conv_num_filter):
        tmp = layers.conv2d(
            input=tmp, num_filters=num_filters,
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i],
            act=None if conv_with_batchnorm[i] else conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", seq_len=None):
    """A context conv over time, then a pool over time (the text-conv
    block of understand_sentiment); `seq_len` carries the lengths."""
    conv_out = layers.sequence_conv(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        seq_len=seq_len,
        param_attr=param_attr,
        act=act,
    )
    return layers.sequence_pool(conv_out, pool_type, seq_len=seq_len)


def glu(input, dim=-1):
    """Gated linear unit: input split in half on `dim`, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention from primitive ops: the
    heads split by reshape [0, 0, H, D / H] and transpose [0, 2, 1, 3],
    Q scaled by 1 / sqrt(D / H), softmax(Q K^T) V (with dropout on the
    weights), the heads merged back by transpose and reshape."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if keys.shape[-2] != values.shape[-2]:
        raise ValueError("keys and values must have the same seq length")

    def split_heads(x):
        if num_heads == 1:
            return x
        hidden = x.shape[-1]
        reshaped = layers.reshape(
            x, shape=[0, 0, num_heads, hidden // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def combine_heads(x):
        if len(x.shape) == 3:
            return x
        trans = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            trans, shape=[0, trans.shape[1], trans.shape[2] * trans.shape[3]])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    scaled_q = layers.scale(x=q, scale=float(k.shape[-1]) ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    return combine_heads(layers.matmul(weights, v))
