"""The sparse tier (counterpart of paddle_tpu/sparse): only the routing
table so far, which the serving fleet's router hashes prompts onto.

The embedding service, its shard servers and transport, SelectedRows and
the sparse API are not ported yet (ROADMAP.md A item 8, with bench.py's
ctr_deepfm leg).
"""

from .routing import RoutingTable

__all__ = ["RoutingTable"]
