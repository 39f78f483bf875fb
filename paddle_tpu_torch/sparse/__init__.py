"""The sparse tier (counterpart of paddle_tpu/sparse): the host-side
sharded embedding service — the pserver role for tables too large for the
device — its TCP shard servers, SelectedRows, and the trainer-side API.

reference: SelectedRows (framework/selected_rows.h:32) as the sparse-grad
currency, the distributed lookup table (transpiler :1033-1276: embedding
rows sharded by id across pservers, trainer-side prefetch RPC, SelectedRows
grads sent sparse) and the Go pserver (go/pserver/) for the CTR story.

The dense model runs on the card; the service holds its tables in host
memory, prefetches the rows a batch needs (they go to the card as a feed)
and applies the sparse grads with the shard's optimizer.  Shards are
in-process (`EmbeddingService`) or shard-server processes behind
`RemoteEmbeddingService` (transport.py, the JAX package's wire).  The
routing table also serves the serving fleet's router.
"""

from .selected_rows import SelectedRows
from .embedding_service import EmbeddingService, Shard
from .routing import RoutingTable
from .transport import (
    MultiShardError,
    RemoteEmbeddingService,
    RemoteShard,
    ShardServer,
    serve_shard,
)

__all__ = [
    "SelectedRows",
    "EmbeddingService",
    "Shard",
    "RoutingTable",
    "MultiShardError",
    "RemoteEmbeddingService",
    "RemoteShard",
    "ShardServer",
    "serve_shard",
]
