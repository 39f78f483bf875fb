"""Replica process entry point — `python -m paddle_tpu_torch.fleet.replica`
(counterpart of paddle_tpu/fleet/replica.py).

Builds a deterministic transformer decode spec from a JSON config and
serves it (`serving.ServingServer` over a `serving.Scheduler`).  Exists
so fleet drills and benches can run replicas as REAL processes — a
`kill -9` only proves failover when there is a pid to kill — while
every replica still initializes bitwise-identical weights: the graph is
built under `unique_name.guard()` with the same config, and the
Executor's startup draws from a torch generator reseeded from the
program's random_seed and a run counter, a pure function of (seed, var
order).  N separate processes therefore agree without ever exchanging a
checkpoint — on one device type: the card's Philox draws are not the
CPU generator's, so every replica of a fleet, and any reference
Generator its tokens are held against, runs its startup on the same
device type.  That weight agreement is what makes cross-replica
resubmit-with-recorded-tokens bitwise-safe.

Config (JSON object on argv[1], all keys optional; the JAX package's
keys and defaults, so a default replica builds the JAX package's graph):
    vocab, max_length, n_layer, src_len, prefix_len, max_len — spec
    max_batch, block_size, num_blocks, flush_deadline_ms,
    paged_kv, prefill_chunk, chunk_len (chunked prefill tier)  — scheduler
    host, port, version, telemetry                            — serving
and the port's two keys:
    place — "cuda" (the default: the replica serves on the card) or
            "cpu";
    model — "tiny" (the default: `transformer.tiny(vocab, max_length)`
            with `n_layer` layers, head_dim 16, which every attention
            gate sends to the composite) or "base" (`transformer.base()`
            whole: vocab, max_length and n_layer are not applied;
            src_len, prefix_len, max_len and the Scheduler keys are).

Prints exactly one READY line to stdout once serving:
    FLEET_REPLICA READY <host:port> pid=<pid> version=<v>
then blocks until killed or OP_SHUTDOWN.

`spawn_replica(cfg)` is the in-tree launcher (benches, drills, supervisor
spawn hooks): Popen + wait-for-READY -> (proc, endpoint).  The child's
stderr goes to a log file under the checkout's `build/fleet_logs/`; a
replica that dies before READY raises with that file's path and its last
lines.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time

__all__ = ["DEFAULT_CONFIG", "build_spec_scope", "spawn_replica", "main"]

DEFAULT_CONFIG = {
    "vocab": 40, "max_length": 16, "n_layer": 1,
    "src_len": 8, "prefix_len": 3, "max_len": 28,
    "max_batch": 4, "block_size": 4, "num_blocks": 40,
    "paged_kv": None, "prefill_chunk": None, "chunk_len": None,
    "host": "127.0.0.1", "port": 0, "version": "v1",
    "telemetry": False,
    "place": "cuda", "model": "tiny",
}

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
LOG_DIR = os.path.join(_REPO, "build", "fleet_logs")
_LOG_TAIL = 20   # stderr lines quoted in a launch failure


def _place(cfg):
    from ..framework import CPUPlace, CUDAPlace

    place = cfg.get("place", "cuda")
    if place == "cpu":
        return CPUPlace()
    if place == "cuda":
        return CUDAPlace(0)
    raise ValueError(f"replica place {place!r}: 'cuda' or 'cpu'")


def build_spec_scope(cfg):
    """(spec, scope) for a replica config — the deterministic function
    shared by the replica process, the reference generator in benches,
    and in-process test fleets."""
    from ..framework import unique_name
    from ..framework.scope import Scope
    from ..models import transformer as T

    model = cfg.get("model", "tiny")
    if model == "base":
        tc = T.base()
    elif model == "tiny":
        tc = T.tiny(vocab=cfg["vocab"], max_length=cfg["max_length"])
        tc.n_layer = cfg["n_layer"]
    else:
        raise ValueError(f"replica model {model!r}: 'tiny' or 'base'")
    with unique_name.guard():
        # chunk_len builds the chunk/encode programs into the spec;
        # decode-tier replicas set it WITHOUT prefill_chunk so both
        # tiers build the identical graph (deterministic weight init
        # agreement) while only the prefill tier schedules chunks
        spec = T.build_decode(tc, src_len=cfg["src_len"],
                              prefix_len=cfg["prefix_len"],
                              max_len=cfg["max_len"],
                              chunk_len=cfg.get("prefill_chunk")
                              or cfg.get("chunk_len"))
    return spec, Scope()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = dict(DEFAULT_CONFIG)
    if argv:
        cfg.update(json.loads(argv[0]))

    if cfg.get("telemetry"):
        from .. import telemetry as telem

        telem.enable()
    from ..serving.rpc import ServingServer
    from ..serving.scheduler import Scheduler

    spec, scope = build_spec_scope(cfg)
    sched = Scheduler(spec, scope=scope, place=_place(cfg),
                      max_batch=cfg["max_batch"],
                      block_size=cfg["block_size"],
                      num_blocks=cfg["num_blocks"],
                      paged_kv=cfg.get("paged_kv"),
                      prefill_chunk=cfg.get("prefill_chunk")).start()
    srv = ServingServer(sched, host=cfg["host"], port=cfg["port"],
                        version=cfg.get("version"))
    print(f"FLEET_REPLICA READY {srv.endpoint} pid={os.getpid()} "
          f"version={cfg.get('version')}", flush=True)
    try:
        # blocks on the MAIN thread; an OP_SHUTDOWN handler thread calls
        # srv.shutdown() and this returns -> clean process exit
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        sched.close()
    return 0


def _log_tail(path, n=_LOG_TAIL):
    try:
        with open(path, errors="replace") as f:
            return "".join(collections.deque(f, maxlen=n))
    except OSError:
        return ""


def spawn_replica(cfg=None, timeout_s=180.0, env=None, cpus=None):
    """Launch one replica subprocess; returns (proc, endpoint) once its
    READY line arrives.  The replica serves on the card unless `cfg`
    says {"place": "cpu"}.  `proc.log_path` is the file the child's
    stderr goes to; a child that exits (or stays silent past
    `timeout_s`) before READY raises with that path and its last lines.

    `cpus` pins the replica to a cpuset (parallel.environment.
    apply_affinity) right after fork — host-packed replicas on disjoint
    cpusets measure scaling instead of core contention."""
    merged = dict(DEFAULT_CONFIG)
    if cfg:
        merged.update(cfg)
    child_env = dict(os.environ)
    # the child must resolve paddle_tpu_torch no matter the caller's cwd
    child_env["PYTHONPATH"] = _REPO + os.pathsep \
        + child_env.get("PYTHONPATH", "")
    if env:
        child_env.update(env)
    os.makedirs(LOG_DIR, exist_ok=True)
    with tempfile.NamedTemporaryFile(
            "w", dir=LOG_DIR, delete=False, suffix=".log",
            prefix=f"replica-{merged.get('version')}-") as err:
        log_path = err.name
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.fleet.replica",
             json.dumps(merged)],
            stdout=subprocess.PIPE, stderr=err, text=True, env=child_env)
    proc.log_path = log_path
    if cpus:
        from ..parallel.environment import apply_affinity

        # pin before the heavy imports start executing, so even the
        # replica's imports and kernel loads land on its own cores
        apply_affinity(proc.pid, cpus)
    lines = queue.Queue()

    def pump():
        # reads every stdout line for the child's whole life, so that a
        # chatty child can never block on a full pipe after READY
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True,
                     name=f"replica-{proc.pid}-stdout").start()
    deadline = time.monotonic() + timeout_s
    while True:
        remaining = deadline - time.monotonic()
        try:
            line = lines.get(timeout=max(0.0, remaining))
        except queue.Empty:
            proc.kill()
            proc.wait()
            raise TimeoutError(
                f"replica not READY within {timeout_s}s (stderr in "
                f"{log_path}):\n{_log_tail(log_path)}") from None
        if line is None:
            rc = proc.wait()
            raise RuntimeError(
                f"replica exited rc={rc} before READY (stderr in "
                f"{log_path}):\n{_log_tail(log_path)}")
        if line.startswith("FLEET_REPLICA READY "):
            return proc, line.split()[2]


if __name__ == "__main__":
    sys.exit(main())
