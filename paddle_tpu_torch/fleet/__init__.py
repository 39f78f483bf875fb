"""Serving fleet: N model replicas behind a prefix-affine router
(counterpart of paddle_tpu/fleet, with the same exports).

One `serving.Scheduler` process is a hard throughput ceiling; this
package is the scale-out tier — the same way
the reference stack fronted its pserver fleet with etcd-resolved
membership (PAPER.md §11), realised with the sparse tier's epoch-stamped
routing table:

  * `FleetRouter` — a wire-compatible serving front end (clients keep
    using `ServingClient`, pointed at the router) that owns an
    epoch-stamped `RoutingTable` over replicas and relays SUBMIT/token
    streams.  Routing is PREFIX-AFFINE: the same `serving.prompt_key`
    the scheduler's prefix cache uses picks the replica, so shared-
    prompt traffic lands where the BlockPool already holds the chain
    and the single-replica prefix hit rate survives scale-out.  A
    replica whose scraped `serving.queue_depth` runs away spills its
    overflow to the least-loaded replica instead.
  * Failover by idempotent resubmit: every SUBMIT carries a request id
    and the relay records delivered tokens; when a replica dies
    mid-stream the router ejects it (epoch bump, its hash slots dealt
    across survivors) and resubmits the generation elsewhere with the
    recorded tokens — the scheduler's evict-and-replay contract makes
    the continuation bitwise-identical, so the client never notices.
  * `FleetSupervisor` — PING-monitors every replica on a side
    connection, scrapes queue depths (the router's spill signal),
    ejects dead replicas, and respawns them via a caller hook.
  * `RollingDeploy` — zero-drop model-version deploys, one replica at a
    time, as an epoch flip: ANNOUNCE (drain mode + traffic re-routes)
    -> DRAIN (in-flight work finishes or is exported for replay)
    -> CUTOVER (swap process, readmit) — the live-reshard shape.

    from paddle_tpu_torch import fleet, serving
    router = fleet.FleetRouter(replica_endpoints).start()
    sup = fleet.FleetSupervisor(router, spawn=respawn_hook).start()
    cli = serving.ServingClient(router.endpoint)
    tokens, status = cli.generate(feed, max_new_tokens=32)

Replica processes: `fleet.replica.spawn_replica(cfg)` launches
`python -m paddle_tpu_torch.fleet.replica '<json>'`, which serves on the
card unless `cfg` says {"place": "cpu"}; {"model": "base"} serves
transformer-base instead of the tiny test model.
"""

from .deploy import RollingDeploy
from .router import FleetRouter, NoReplicaAvailable, probe, scrape_load
from .supervisor import FleetSupervisor

__all__ = [
    "FleetRouter",
    "FleetSupervisor",
    "NoReplicaAvailable",
    "RollingDeploy",
    "probe",
    "scrape_load",
]
