"""SE-ResNeXt-50: grouped-conv bottlenecks with squeeze-and-excitation
(counterpart of paddle_tpu/models/se_resnext.py; reference
benchmark/fluid/models/se_resnext.py)."""

from __future__ import annotations

from .. import layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None):
    """A bias-free conv2d ("same" padding for odd filters) and a batch
    norm carrying the activation.  The 3x3 convs are grouped (groups 32
    over 128-1024 channels), never depthwise."""
    conv = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act)


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    """Global average pool, a relu fc of C / r, a sigmoid fc of C, then
    the [N, C, H, W] input scaled by the [N, C] gate (axis 0)."""
    pool = layers.pool2d(input=input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    return layers.elementwise_mul(x=input, y=excitation, axis=0)


def _shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride, cardinality=32,
                     reduction_ratio=16):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride)
    return layers.elementwise_add(x=short, y=scale, act="relu")


def se_resnext50(input, class_dim):
    """A 7x7 stem and a 3x3 max pool, 3-4-6-3 bottlenecks of 128, 256,
    512 and 1024 filters (cardinality 32, reduction 16), a global average
    pool, dropout 0.5 and a softmax fc."""
    cardinality, reduction_ratio = 32, 16
    depth = [3, 4, 6, 3]
    num_filters = [128, 256, 512, 1024]
    x = conv_bn_layer(input, 64, 7, stride=2, act="relu")
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for block, (d, f) in enumerate(zip(depth, num_filters)):
        for i in range(d):
            x = bottleneck_block(
                x, f, stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio)
    x = layers.pool2d(input=x, pool_type="avg", global_pooling=True)
    x = layers.dropout(x=x, dropout_prob=0.5)
    return layers.fc(input=x, size=class_dim, act="softmax")


def build(image_shape=(3, 224, 224), class_dim=1000):
    """-> (loss, prediction, accuracy)."""
    img = layers.data(name="img", shape=list(image_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    prediction = se_resnext50(img, class_dim)
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return loss, prediction, acc
