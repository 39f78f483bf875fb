"""CTR DeepFM with distributed sparse embeddings (counterpart of
paddle_tpu/models/ctr_deepfm.py, line for line).

BASELINE config "CTR DeepFM sparse embeddings (go/pserver + send/recv
distributed path)"; reference analog: tests/unittests/dist_ctr.py + the
distributed lookup table.  Sparse field embeddings live in the host-side
EmbeddingService (the pserver role); the dense FM + deep tower runs on
the card, its `fc` products as plain matmuls (the JAX package leaves them
to XLA too).  The `<name>@rows` data vars take the prefetched rows and
need their grads, so they do not stop the gradient; sparse.api's
SparseTrainStep fetches `<name>@rows@GRAD` and pushes it to the service.

DeepFM = FM first-order (per-field scalar weights) + FM second-order
(0.5 * ((sum v)^2 - sum v^2) over field embedding vectors) + MLP over the
concatenated field embeddings, all into a sigmoid CTR head.
"""

from __future__ import annotations

from .. import layers
from ..sparse.api import DistributedEmbedding
from ..sparse.embedding_service import EmbeddingService


def build(
    num_fields=8,
    sparse_feature_dim=int(1e5),
    embedding_size=10,
    dense_feature_dim=13,
    mlp_dims=(128, 64),
    service: EmbeddingService = None,
    num_shards=2,
    learning_rate=0.01,
):
    """Returns (loss, auc_like_prob, embeddings, service)."""
    if service is None:
        service = EmbeddingService(
            height=sparse_feature_dim, dim=embedding_size,
            num_shards=num_shards, optimizer="adagrad",
            learning_rate=learning_rate,
        )
    first_order_svc = EmbeddingService(
        height=sparse_feature_dim, dim=1, num_shards=num_shards,
        optimizer="adagrad", learning_rate=learning_rate,
    )

    dense = layers.data(name="dense_x", shape=[dense_feature_dim],
                        dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="float32")

    emb = DistributedEmbedding("sparse_emb", service, seq_len=num_fields)
    emb1 = DistributedEmbedding("sparse_w1", first_order_svc,
                                seq_len=num_fields)

    # FM first order: sum of per-field scalar weights
    first = layers.reduce_sum(layers.reshape(emb1.var, shape=[-1, num_fields]),
                              dim=1, keep_dim=True)
    # FM second order over field vectors v_f: 0.5*((sum v)^2 - sum(v^2))
    sum_v = layers.reduce_sum(emb.var, dim=1)  # [B, D]
    sum_v_sq = layers.elementwise_mul(x=sum_v, y=sum_v)
    v_sq = layers.elementwise_mul(x=emb.var, y=emb.var)
    sq_sum = layers.reduce_sum(v_sq, dim=1)
    second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(x=sum_v_sq, y=sq_sum),
                          dim=1, keep_dim=True),
        scale=0.5,
    )
    # deep tower over concatenated field embeddings + dense features
    deep_in = layers.concat(
        [layers.reshape(emb.var, shape=[-1, num_fields * service.dim]), dense],
        axis=1,
    )
    h = deep_in
    for d in mlp_dims:
        h = layers.fc(input=h, size=d, act="relu")
    deep = layers.fc(input=h, size=1, act=None)

    logit = layers.sums([first, second, deep])
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
    )
    prob = layers.sigmoid(logit)
    return loss, prob, [emb, emb1], service
