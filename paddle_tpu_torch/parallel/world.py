"""A world of N rank processes on this host, each in one torch.distributed
process group, running the calls it is given.

The port runs one process per rank (a DTensor program is SPMD: every rank
runs the same ops on its own blocks), so a multi-device run on one
machine needs N processes, not N threads.  `World` spawns them, brings
the process group up in each (`environment.init_distributed` through a
file rendezvous), and `run("module:function", *args)` calls that
function on every rank at once and returns the N results in rank order.
A rank that raises fails the call with its traceback; a call that does
not return in `timeout` seconds ends the world.

    with World(4, "/tmp/rdzv", device_type="cpu") as world:
        losses = world.run("my_cases:train_dp", 3)
"""

from __future__ import annotations

import datetime
import importlib
import os
import queue
import traceback

__all__ = ["World"]


def _rank_main(rank, n, init_file, device_type, timeout, inq, outq):
    import faulthandler

    import torch

    from .environment import init_distributed

    faulthandler.enable()

    if device_type == "cpu":
        torch.set_num_threads(1)
    try:
        init_distributed("file://" + init_file, n, rank,
                         device_type=device_type,
                         timeout=datetime.timedelta(seconds=timeout))
        outq.put((rank, True, None))
    except Exception:
        outq.put((rank, False, traceback.format_exc()))
        return
    while True:
        msg = inq.get()
        if msg is None:
            break
        path, args, kwargs = msg
        try:
            mod, fn = path.split(":")
            result = getattr(importlib.import_module(mod), fn)(*args,
                                                               **kwargs)
            outq.put((rank, True, result))
        except Exception:
            outq.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class World:
    """N spawned rank processes; see the module docstring.  `device_type`
    "cuda" puts rank r on card r % device_count (all on one card when
    there is one); the backend follows `comm.backend_for`."""

    def __init__(self, n, init_file, device_type="cuda", timeout=300.0):
        import multiprocessing as mp

        if os.path.exists(init_file):
            os.remove(init_file)
        ctx = mp.get_context("spawn")
        self.n = n
        self.timeout = timeout
        self._in = [ctx.Queue() for _ in range(n)]
        self._out = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main,
                        args=(r, n, init_file, device_type, timeout,
                              self._in[r], self._out),
                        daemon=True)
            for r in range(n)]
        for p in self._procs:
            p.start()
        self._collect(timeout)

    def _collect(self, timeout):
        import time

        got, errors = {}, []
        deadline = time.monotonic() + timeout
        while len(got) + len(errors) < self.n:
            try:
                rank, ok, value = self._out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    codes = [self._procs[r].exitcode for r in dead]
                    self.close()
                    raise TimeoutError(
                        f"ranks {dead} of the {self.n}-rank world exited "
                        f"(exit codes {codes})"
                        if dead else f"a rank of the {self.n}-rank world "
                        f"did not answer in {timeout} s") from None
                continue
            if ok:
                got[rank] = value
            else:
                errors.append((rank, value))
        if errors:
            self.close()
            raise RuntimeError("\n".join(f"rank {r}:\n{tb}"
                                         for r, tb in sorted(errors)))
        return [got[r] for r in range(self.n)]

    def run(self, path, *args, timeout=None, **kwargs):
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("the world is closed")
        for q in self._in:
            q.put((path, args, kwargs))
        return self._collect(timeout or self.timeout)

    def close(self):
        for q in self._in:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
