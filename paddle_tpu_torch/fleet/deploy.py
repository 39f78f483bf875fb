"""RollingDeploy — zero-drop model-version deploys as an epoch flip
(counterpart of paddle_tpu/fleet/deploy.py: the same swap contract
and the same deploy record).

Replicas are replaced ONE at a time, each through the live-reshard
state machine (ANNOUNCE -> DRAIN -> CUTOVER), so the fleet never
shrinks by more than one and no accepted request is ever dropped:

  ANNOUNCE — the replica flips to DRAINING in the router's membership
      table (epoch+1: its hash slots deal across the others, new
      traffic routes away) AND server-side drain mode (a SUBMIT that
      races the table flip gets a REJECT reply and the router
      re-routes it — belt and braces).
  DRAIN    — in-flight generations finish streaming through the router
      normally.  Past `drain_grace_s` the stragglers are force-moved:
      `export_requests(cancel=True)` retires them on the old replica
      and every relay resubmits its generation to another replica with
      the recorded tokens — the evict-and-replay contract keeps the
      continuation bitwise-identical, so even the force path drops
      nothing.
  CUTOVER  — the caller's `swap` hook replaces the process (new model
      version), the deploy waits for the new PING, verifies the
      version actually flipped, and READMITS it (epoch+1).  The
      measured ANNOUNCE->readmit window per replica is the deploy MTTR
      the bench reports.

Abort at any point re-opens the replica (drain(False) + readmit) —
nothing in the sequence is destructive until `swap` returns.
"""

from __future__ import annotations

import time

from ..serving.rpc import ServingClient
from ..telemetry import registry as _telem
from .router import probe

__all__ = ["RollingDeploy"]

_C_DEPLOYS = _telem.counter("fleet.deploys")
_H_CUTOVER = _telem.histogram("fleet.deploy_cutover_ms")


class RollingDeploy:
    """One rolling deploy over a FleetRouter's replicas.

        dep = RollingDeploy(router, swap=swap_hook)
        record = dep.run()

    `swap(index, old_endpoint) -> new_endpoint` performs the actual
    version change: stop/replace the old process (or hot-swap weights)
    and return where the new one listens.  It may return the same
    endpoint (in-place restart)."""

    def __init__(self, router, swap, drain_grace_s=10.0,
                 probe_timeout=2.0, expect_version=None):
        self.router = router
        self.swap = swap
        self.drain_grace_s = float(drain_grace_s)
        self.probe_timeout = float(probe_timeout)
        self.expect_version = expect_version

    # -- helpers -------------------------------------------------------------

    def _stats(self, endpoint):
        cli = ServingClient(endpoint, name="deploy")
        try:
            return cli, cli.stats()
        except Exception:
            cli.close()
            raise

    def _drain_one(self, index, tier="decode"):
        """ANNOUNCE + DRAIN for one replica; returns (drain_ms,
        forced_moves)."""
        rep = self.router._tier_replicas(tier)[index]
        t0 = time.monotonic()
        self.router.set_draining(index, True, tier=tier)  # epoch+1
        cli = ServingClient(rep.endpoint, name="deploy")
        try:
            cli.drain(True)                     # replica-side belt
            deadline = t0 + self.drain_grace_s
            forced = 0
            while time.monotonic() < deadline:
                st = cli.stats()
                if st["waiting"] + st["active"] + st["preempted"] == 0:
                    break
                time.sleep(0.02)
            else:
                # stragglers: retire them here; their relays resubmit
                # with recorded tokens (see router._relay), so the
                # force path still drops nothing
                forced = len(cli.export_requests(cancel=True))
                give_up = time.monotonic() + self.drain_grace_s
                while time.monotonic() < give_up:
                    st = cli.stats()
                    if st["waiting"] + st["active"] \
                            + st["preempted"] == 0:
                        break
                    time.sleep(0.02)
            return (time.monotonic() - t0) * 1e3, forced
        finally:
            cli.close()

    # -- the deploy ----------------------------------------------------------

    def run(self, indices=None, tier="decode"):
        """Deploy over `indices` of `tier` (default: every non-DOWN
        replica of that tier, in order).  Returns the deploy record:
        per-replica timings and the fleet-level MTTR summary."""
        replicas = self.router._tier_replicas(tier)
        if indices is None:
            indices = [r.index for r in replicas if r.state != "down"]
        record = {"replicas": [], "started": time.time(), "tier": tier}
        t_all = time.monotonic()
        for index in indices:
            rep = replicas[index]
            old_ep, old_ver = rep.endpoint, rep.version
            t0 = time.monotonic()
            try:
                drain_ms, forced = self._drain_one(index, tier=tier)
                t_swap = time.monotonic()
                new_ep = self.swap(index, old_ep)
                meta = self._await_up(new_ep)
                if self.expect_version is not None \
                        and meta.get("version") != self.expect_version:
                    raise RuntimeError(
                        f"replica {index} came back as version "
                        f"{meta.get('version')!r}, expected "
                        f"{self.expect_version!r}")
                self.router.readmit(index, endpoint=new_ep,
                                    version=meta.get("version"),
                                    tier=tier)
            except Exception:
                # abort: re-open the old replica if it still answers
                try:
                    probe(old_ep, timeout=self.probe_timeout)
                    ServingClient(old_ep, name="deploy").drain(False)
                    self.router.set_draining(index, False, tier=tier)
                except (OSError, ConnectionError):
                    self.router.eject(index, reason="deploy failed",
                                      tier=tier)
                raise
            mttr_ms = (time.monotonic() - t0) * 1e3
            cutover_ms = (time.monotonic() - t_swap) * 1e3
            _C_DEPLOYS.inc()
            _H_CUTOVER.observe(cutover_ms)
            self.router._log("deployed", index,
                             f"{old_ver} -> {meta.get('version')}")
            record["replicas"].append({
                "index": index,
                "old_endpoint": old_ep, "new_endpoint": new_ep,
                "old_version": old_ver,
                "new_version": meta.get("version"),
                "drain_ms": round(drain_ms, 1),
                "forced_moves": forced,
                "cutover_ms": round(cutover_ms, 1),
                "mttr_ms": round(mttr_ms, 1),
            })
        record["total_ms"] = round((time.monotonic() - t_all) * 1e3, 1)
        record["max_mttr_ms"] = max(
            (r["mttr_ms"] for r in record["replicas"]), default=0.0)
        return record

    def _await_up(self, endpoint, timeout_s=120.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                meta = probe(endpoint, timeout=self.probe_timeout)
                if meta.get("ok") and not meta.get("draining"):
                    return meta
            except (OSError, ConnectionError):
                pass
            time.sleep(0.05)
        raise TimeoutError(f"new replica at {endpoint} never came up")
