"""ChaosProxy — deterministic TCP fault injection for resilience tests
(counterpart of paddle_tpu/resilience/chaos.py; pure sockets, the same
knobs, counters and seeded schedule).

A transparent proxy that sits in front of any endpoint of the host-side
runtime (a serving replica, the fleet router) and injects faults into
the byte stream.  It is the harness that PROVES the resilience layer:
channel retry/reconnect, the router's failover and resubmit, and the
desync guard are all demonstrated by driving real clients through a
misbehaving wire instead of monkeypatching sockets.

Two control surfaces:

  * scripted (exact, for regression tests):
      - stall_next(n, seconds): delay the next n server->client chunks
        past the client deadline — the "late reply" desync scenario.
      - drop_next(n): hard-close the connection on the next n chunks.
      - kill_connections(): reset every live connection now.
      - blackhole: accept + swallow bytes, never forward (dead-peer
        timeouts without a RST).
      - refuse: accept then immediately close (crash-looping server).
  * randomized (seeded, for soaks): per-forwarded-chunk probabilities
    drop_rate / truncate_rate / delay_rate drawn from one
    random.Random(seed) under a lock — the same seed replays the same
    fault schedule for a single-threaded client.

Faults observed by clients map onto the RpcPolicy classification:
drops/resets/refusals and stalls are retryable transport errors; nothing
the proxy does can forge a server-side OP_ERROR reply.
"""

from __future__ import annotations

import collections
import random
import socket
import threading
import time

__all__ = ["ChaosProxy"]

_CHUNK = 65536


class ChaosProxy:
    """TCP fault-injection proxy in front of ``upstream`` ("host:port")."""

    def __init__(self, upstream, host="127.0.0.1", port=0, seed=0,
                 drop_rate=0.0, truncate_rate=0.0, delay_rate=0.0,
                 delay_s=0.05):
        self.upstream = upstream
        self.drop_rate = float(drop_rate)
        self.truncate_rate = float(truncate_rate)
        self.delay_rate = float(delay_rate)
        self.delay_s = float(delay_s)
        self.blackhole = False
        self.refuse = False
        self.counters = collections.Counter()
        self._rng = random.Random(seed)
        self._ctl = threading.Lock()  # guards rng draws + scripted queues
        self._stalls = []             # [seconds] for next downstream chunks
        self._drop_next = 0
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        # poll timeout so stop() doesn't wait on a blocked accept()
        self._listener.settimeout(0.25)
        self._stopped = threading.Event()
        self._conns = set()           # live sockets (both sides)
        self._conns_lock = threading.Lock()
        self._accept_thread = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def endpoint(self):
        h, p = self._listener.getsockname()[:2]
        return f"{h}:{p}"

    def start(self):
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-accept")
        self._accept_thread.start()
        return self

    def stop(self):
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.kill_connections()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    # -- scripted fault controls ------------------------------------------
    def stall_next(self, n=1, seconds=1.0):
        """Delay the next ``n`` server->client chunks by ``seconds`` —
        the reply arrives LATE, after the client's deadline."""
        with self._ctl:
            self._stalls.extend([float(seconds)] * int(n))

    def drop_next(self, n=1):
        """Hard-close the connection carrying the next ``n`` chunks."""
        with self._ctl:
            self._drop_next += int(n)

    def kill_connections(self):
        """Reset every live proxied connection immediately."""
        with self._conns_lock:
            victims = list(self._conns)
            self._conns.clear()
        for s in victims:
            # shutdown() first: close() alone does not interrupt a pump
            # thread blocked in recv() on the same socket (the fd stays
            # referenced inside the syscall), so no FIN would reach the
            # peers and a blackholed client would sit out its full
            # timeout instead of seeing the reset
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if victims:
            self.counters["killed_conns"] += len(victims) // 2 or 1

    def set_upstream(self, endpoint):
        """Re-point future connections (failover target moved)."""
        self.upstream = endpoint

    def set_fault(self, **kw):
        """Adjust randomized rates / blackhole / refuse at runtime."""
        for key, val in kw.items():
            if key not in ("drop_rate", "truncate_rate", "delay_rate",
                           "delay_s", "blackhole", "refuse"):
                raise ValueError(f"unknown fault knob {key!r}")
            setattr(self, key, val)

    # -- internals ---------------------------------------------------------
    def _track(self, *socks):
        with self._conns_lock:
            self._conns.update(socks)

    def _untrack_close(self, *socks):
        with self._conns_lock:
            for s in socks:
                self._conns.discard(s)
        for s in socks:
            # shutdown first, same as kill_connections(): a pump torn
            # down by its partner's reset closes BOTH sockets, and a
            # plain close() racing ahead of kill_connections' shutdown
            # leaves the peer of the other socket with no FIN (its fd
            # is still referenced by the other pump's blocked recv)
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                client, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            client.settimeout(None)  # pumps block; don't inherit the poll
            if self.refuse:
                self.counters["refused"] += 1
                try:
                    client.close()
                except OSError:
                    pass
                continue
            self.counters["conns"] += 1
            host, port = self.upstream.rsplit(":", 1)
            try:
                server = socket.create_connection((host, int(port)), 10.0)
            except OSError:
                self.counters["upstream_unreachable"] += 1
                try:
                    client.close()
                except OSError:
                    pass
                continue
            server.settimeout(None)  # ditto: don't keep the connect poll
            self._track(client, server)
            for src, dst, direction in ((client, server, "up"),
                                        (server, client, "down")):
                threading.Thread(
                    target=self._pump, args=(src, dst, direction),
                    daemon=True, name=f"chaos-{direction}",
                ).start()

    def _decide(self, direction):
        """(action, arg) for one forwarded chunk; one rng draw keeps the
        schedule deterministic for a given seed + chunk sequence."""
        with self._ctl:
            if self.blackhole:
                return "blackhole", None
            if self._drop_next > 0:
                self._drop_next -= 1
                return "drop", None
            if direction == "down" and self._stalls:
                return "stall", self._stalls.pop(0)
            r = self._rng.random()
            if r < self.drop_rate:
                return "drop", None
            r -= self.drop_rate
            if r < self.truncate_rate:
                return "truncate", None
            r -= self.truncate_rate
            if r < self.delay_rate:
                return "delay", self.delay_s
            return "forward", None

    def _pump(self, src, dst, direction):
        try:
            while not self._stopped.is_set():
                data = src.recv(_CHUNK)
                if not data:
                    break
                action, arg = self._decide(direction)
                if action == "blackhole":
                    self.counters["blackholed_chunks"] += 1
                    continue
                if action == "drop":
                    self.counters["dropped_conns"] += 1
                    break
                if action == "truncate":
                    self.counters["truncated_conns"] += 1
                    dst.sendall(data[:max(1, len(data) // 2)])
                    break
                if action == "stall":
                    self.counters["stalled_chunks"] += 1
                    time.sleep(arg)
                elif action == "delay":
                    self.counters["delayed_chunks"] += 1
                    time.sleep(arg)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            self._untrack_close(src, dst)
