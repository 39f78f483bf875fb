"""FleetSupervisor — replica health, load scraping, and respawn
(counterpart of paddle_tpu/fleet/supervisor.py).

The `ShardSupervisor` loop re-cut for the serving fleet: one background
monitor PINGs every replica on a side connection each
`fleet_ping_interval_ms`, and in the same cycle scrapes its queue depth
(STATUS gauge / STATS fallback) into the router's membership table —
the spill signal is only as fresh as this loop.

A replica that misses `down_after` consecutive probes is EJECTED from
the router (epoch bump; its hash slots deal across survivors; in-flight
relays resubmit their generations elsewhere with recorded tokens — the
router does that part on its own the moment a relay faults, so the
probe path is the slow backstop, not the only detector).  With a
`spawn` hook the supervisor then respawns the replica — the go/pserver
restart-under-etcd idiom — waits for its PING to come back, and
readmits it; MTTR (eject -> readmitted) lands in the
`fleet.mttr_ms` histogram and the router's event log.
"""

from __future__ import annotations

import threading
import time

from ..telemetry import registry as _telem
from .router import DOWN, probe

__all__ = ["FleetSupervisor"]

_C_RESPAWNS = _telem.counter("fleet.respawns")
_H_MTTR = _telem.histogram("fleet.mttr_ms")


class FleetSupervisor:
    """Health/monitor loop over a FleetRouter's replicas.

        sup = FleetSupervisor(router, spawn=lambda i, ep: new_ep).start()

    `spawn(index, old_endpoint) -> new_endpoint` relaunches a dead
    replica's process (subprocess, container, whatever the deployment
    uses) and returns where it now listens; None disables respawn (the
    fleet just runs degraded on the survivors)."""

    def __init__(self, router, spawn=None, ping_interval_ms=None,
                 down_after=2, probe_timeout=2.0):
        from .. import flags

        self.router = router
        self.spawn = spawn
        self.interval = (flags.get("fleet_ping_interval_ms")
                         if ping_interval_ms is None
                         else ping_interval_ms) / 1e3
        self.down_after = int(down_after)
        self.probe_timeout = float(probe_timeout)
        self.events = []          # (ts, kind, index, detail)
        self.mttrs_ms = []        # completed recoveries
        self._stop = threading.Event()
        self._thread = None
        self._recovering = set()  # replica indices mid-respawn
        self._lock = threading.Lock()

    def _log(self, kind, index, detail=""):
        self.events.append((time.monotonic(), kind, index, detail))

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-supervisor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- the monitor loop ----------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            self.check_once()
            self._stop.wait(self.interval)

    def check_once(self):
        """One probe+scrape cycle over every replica (public so tests
        and benches can drive it deterministically)."""
        for rep in list(self.router.replicas):
            if self._stop.is_set():
                return
            if rep.state == DOWN:
                with self._lock:
                    recovering = rep.index in self._recovering
                if not recovering and self.spawn is not None:
                    self._begin_recovery(rep.index)
                continue
            try:
                meta = probe(rep.endpoint, timeout=self.probe_timeout)
                rep.failures = 0
                rep.version = meta.get("version", rep.version)
                rep.loadavg = meta.get("loadavg", rep.loadavg)
                try:
                    self.router.scrape(rep.index,
                                       timeout=self.probe_timeout)
                except (OSError, ConnectionError):
                    pass  # ping ok, scrape raced a restart — next cycle
            except (OSError, ConnectionError) as e:
                rep.failures += 1
                if rep.failures >= self.down_after:
                    if self.router.eject(rep.index,
                                         reason=f"probe: {e!r}"):
                        self._log("down", rep.index, repr(e))
                        if self.spawn is not None:
                            self._begin_recovery(rep.index)

    # -- recovery ------------------------------------------------------------

    def _begin_recovery(self, index):
        with self._lock:
            if index in self._recovering:
                return
            self._recovering.add(index)
        threading.Thread(target=self._recover, args=(index,), daemon=True,
                         name=f"fleet-recover-{index}").start()

    def _recover(self, index):
        t0 = time.monotonic()
        rep = self.router.replicas[index]
        try:
            new_ep = self.spawn(index, rep.endpoint)
            deadline = time.monotonic() + 120.0
            meta = None
            while time.monotonic() < deadline and not self._stop.is_set():
                try:
                    meta = probe(new_ep, timeout=self.probe_timeout)
                    if meta.get("ok"):
                        break
                except (OSError, ConnectionError):
                    time.sleep(0.05)
            else:
                self._log("recover_timeout", index, new_ep)
                return
            self.router.readmit(index, endpoint=new_ep,
                                version=(meta or {}).get("version"))
            mttr_ms = (time.monotonic() - t0) * 1e3
            self.mttrs_ms.append(mttr_ms)
            _C_RESPAWNS.inc()
            _H_MTTR.observe(mttr_ms)
            self._log("recovered", index,
                      f"{new_ep} in {mttr_ms:.0f} ms")
        except Exception as e:  # noqa: BLE001 — recovery must not kill
            # the monitor; the replica stays DOWN and the next cycle
            # (or an operator) retries
            self._log("recover_failed", index, repr(e))
        finally:
            with self._lock:
                self._recovering.discard(index)
