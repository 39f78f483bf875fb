"""GoogLeNet / Inception-v1 (counterpart of paddle_tpu/models/googlenet.py,
the second gen-1 headline benchmark).

The nine-inception-module topology, its parameter names and attrs are
the JAX package's, so both packages build the same Program: max pools
with ceil_mode, 1x1/3x3/5x5 branches concatenated over channels, two
auxiliary heads (5x5/3 average pool, 1x1 conv, fc over the 4-D map,
dropout 0.7) joining the loss with the paper's 0.3 weight, and dropout
0.4 before the classifier.  bench.py's googlenet leg trains `build()` at
batch 128 on 3x224x224 images (the topology fixes the size: the last
average pool is 7x7) with Momentum(0.01, 0.9) under bf16 AMP.
"""

from __future__ import annotations

from .. import layers


def _inception(x, c1, c3r, c3, c5r, c5, pool_proj):
    b1 = layers.conv2d(input=x, num_filters=c1, filter_size=1, act="relu")
    b3 = layers.conv2d(input=x, num_filters=c3r, filter_size=1, act="relu")
    b3 = layers.conv2d(input=b3, num_filters=c3, filter_size=3, padding=1,
                       act="relu")
    b5 = layers.conv2d(input=x, num_filters=c5r, filter_size=1, act="relu")
    b5 = layers.conv2d(input=b5, num_filters=c5, filter_size=5, padding=2,
                       act="relu")
    bp = layers.pool2d(input=x, pool_size=3, pool_stride=1, pool_padding=1,
                       pool_type="max")
    bp = layers.conv2d(input=bp, num_filters=pool_proj, filter_size=1,
                       act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def _aux_head(x, class_dim):
    p = layers.pool2d(input=x, pool_size=5, pool_stride=3, pool_type="avg")
    c = layers.conv2d(input=p, num_filters=128, filter_size=1, act="relu")
    f = layers.fc(input=c, size=1024, act="relu")
    d = layers.dropout(x=f, dropout_prob=0.7)
    return layers.fc(input=d, size=class_dim, act="softmax")


def googlenet(img, class_dim=1000):
    """-> (main softmax, aux1 softmax, aux2 softmax)."""
    x = layers.conv2d(input=img, num_filters=64, filter_size=7, stride=2,
                      padding=3, act="relu")
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max",
                      ceil_mode=True)
    x = layers.conv2d(input=x, num_filters=64, filter_size=1, act="relu")
    x = layers.conv2d(input=x, num_filters=192, filter_size=3, padding=1,
                      act="relu")
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max",
                      ceil_mode=True)

    x = _inception(x, 64, 96, 128, 16, 32, 32)      # 3a
    x = _inception(x, 128, 128, 192, 32, 96, 64)    # 3b
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max",
                      ceil_mode=True)

    x = _inception(x, 192, 96, 208, 16, 48, 64)     # 4a
    aux1 = x
    x = _inception(x, 160, 112, 224, 24, 64, 64)    # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)    # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)    # 4d
    aux2 = x
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 4e
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max",
                      ceil_mode=True)

    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)  # 5b
    x = layers.pool2d(input=x, pool_size=7, pool_stride=1, pool_type="avg")
    x = layers.dropout(x=x, dropout_prob=0.4)
    main_out = layers.fc(input=x, size=class_dim, act="softmax")
    return main_out, _aux_head(aux1, class_dim), _aux_head(aux2, class_dim)


def build(image_shape=(3, 224, 224), class_dim=1000, with_aux=True):
    """Training graph: (img, label) -> (loss, main softmax, accuracy); with
    `with_aux` the loss adds 0.3 x the two auxiliary heads' losses."""
    img = layers.data(name="img", shape=list(image_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    main_out, aux1, aux2 = googlenet(img, class_dim)
    loss = layers.mean(layers.cross_entropy(input=main_out, label=label))
    if with_aux:
        l1 = layers.mean(layers.cross_entropy(input=aux1, label=label))
        l2 = layers.mean(layers.cross_entropy(input=aux2, label=label))
        loss = layers.elementwise_add(
            loss, layers.scale(layers.elementwise_add(l1, l2), scale=0.3))
    acc = layers.accuracy(input=main_out, label=label)
    return loss, main_out, acc
