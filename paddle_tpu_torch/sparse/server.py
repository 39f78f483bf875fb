"""Shard-server CLI: `python -m paddle_tpu_torch.sparse.server
--shard-index 0 --num-shards 2 --dim 10 --port 0 --ready-file F`
(counterpart of paddle_tpu/sparse/server.py).

The go/pserver main() role (go/pserver/service.go) — one process, one
shard, serving the transport.py protocol until SHUTDOWN.  The endpoint
("host:port") is written to the ready file once the server listens.  A
host process: it creates no CUDA context.  Lives apart from transport.py
so runpy doesn't re-execute an already-imported module.
"""

from .transport import main

if __name__ == "__main__":
    main()
