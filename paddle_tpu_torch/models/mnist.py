"""MNIST digit recognition, MLP and conv-pool variants (counterpart of
paddle_tpu/models/mnist.py; reference benchmark/fluid/models/mnist.py and
tests/book/test_recognize_digits.py)."""

from __future__ import annotations

from .. import layers, nets


def _inputs(img, label):
    if img is None:
        img = layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")
    return img, label


def _head(x, label):
    prediction = layers.fc(input=x, size=10, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return loss, prediction, acc


def build_mlp(img=None, label=None, hidden=(200, 200)):
    """relu fcs of `hidden` widths, then a softmax fc of 10 -> (loss,
    prediction, accuracy)."""
    img, label = _inputs(img, label)
    x = img
    for h in hidden:
        x = layers.fc(input=x, size=h, act="relu")
    return _head(x, label)


def build_conv(img=None, label=None):
    """Two 5x5 conv-pool stages (20 and 50 filters, relu, 2x2 max pools),
    then a softmax fc of 10 -> (loss, prediction, accuracy)."""
    img, label = _inputs(img, label)
    c1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2, pool_stride=2,
        act="relu")
    c2 = nets.simple_img_conv_pool(
        input=c1, filter_size=5, num_filters=50, pool_size=2, pool_stride=2,
        act="relu")
    return _head(c2, label)


def feed_shapes(batch_size):
    return {
        "img": ((batch_size, 1, 28, 28), "float32"),
        "label": ((batch_size, 1), "int64"),
    }
