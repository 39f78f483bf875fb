"""AlexNet (counterpart of paddle_tpu/models/alexnet.py; reference
benchmark/README.md rows 33-40): 5 convs and 3 fcs, with local response
normalisation after the first two conv stages."""

from __future__ import annotations

from .. import layers


def alexnet(img, class_dim=1000):
    conv1 = layers.conv2d(input=img, num_filters=64, filter_size=11,
                          stride=4, padding=2, act="relu")
    lrn1 = layers.lrn(input=conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(input=lrn1, pool_size=3, pool_stride=2,
                          pool_type="max")
    conv2 = layers.conv2d(input=pool1, num_filters=192, filter_size=5,
                          padding=2, act="relu")
    lrn2 = layers.lrn(input=conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(input=lrn2, pool_size=3, pool_stride=2,
                          pool_type="max")
    conv3 = layers.conv2d(input=pool2, num_filters=384, filter_size=3,
                          padding=1, act="relu")
    conv4 = layers.conv2d(input=conv3, num_filters=256, filter_size=3,
                          padding=1, act="relu")
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                          padding=1, act="relu")
    pool5 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2,
                          pool_type="max")
    fc6 = layers.fc(input=pool5, size=4096, act="relu")
    drop6 = layers.dropout(x=fc6, dropout_prob=0.5)
    fc7 = layers.fc(input=drop6, size=4096, act="relu")
    drop7 = layers.dropout(x=fc7, dropout_prob=0.5)
    return layers.fc(input=drop7, size=class_dim, act="softmax")


def build(image_shape=(3, 224, 224), class_dim=1000):
    """-> (loss, prediction, accuracy)."""
    img = layers.data(name="img", shape=list(image_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    prediction = alexnet(img, class_dim)
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return loss, prediction, acc
