"""Trainer-side API for distributed (host-sharded) embeddings
(counterpart of paddle_tpu/sparse/api.py).

The reference rewires lookup_table ops into prefetch RPCs
(transpiler :1033 _replace_lookup_table_op_with_prefetch) and ships
SelectedRows grads to pservers.  Here the same dataflow runs at the step
boundary, which is where TPUs want it anyway (host gather -> one HBM DMA ->
dense compute -> sparse grad back to host):

    svc = EmbeddingService(height=1e6, dim=16, num_shards=4)
    emb = distributed_embedding("user_id", service=svc, seq_len=1, dim=16)
    ... model over emb.var ...
    runner = SparseTrainStep(exe, program, [emb], loss)
    runner.run(feed={"user_id@ids": ids, ...})  # prefetch+train+push

reference parity: prefetch == RequestPrefetch (grpc_server.cc:157), push ==
SendGrad with SelectedRows (go/pserver/service.go:285), async barrier-free
updates.

The device step is `Executor.run`, which on the card replays the
program's captured CUDA graph; the prefetched rows are a host feed that
the graph copies into its own buffer, and the rows' grads are fetched
like the loss.  Fetches come back as numpy (`return_numpy`, the
Executor's default): the device-to-host copy of the grads ends before
`run` returns, on the caller's thread, after the replay that wrote them.
In the JAX package the push thread's `np.asarray(g)` is that copy; here
the push thread gets host arrays, so it never reads a card tensor that
another stream may still be writing.  The overlap of `run_pipelined` is
therefore push(i) and prefetch(i+1) against step i+1, as there.
"""

from __future__ import annotations

import sys

import numpy as np

from ..framework.framework import grad_var_name
from .embedding_service import EmbeddingService
from .selected_rows import SelectedRows


class DistributedEmbedding:
    """Graph-side handle: a data var `<name>@rows` the runner fills with
    prefetched rows each step; ids are fed as `<name>@ids`."""

    def __init__(self, name, service: EmbeddingService, seq_len, dim=None):
        from ..layer_helper import LayerHelper

        dim = dim or service.dim
        assert dim == service.dim
        self.name = name
        self.service = service
        self.seq_len = seq_len
        self.ids_feed_name = f"{name}@ids"
        helper = LayerHelper(name)
        self.var = helper.create_global_variable(
            name=f"{name}@rows",
            shape=(-1, seq_len, dim),
            dtype="float32",
            is_data=True,
        )
        self.var.stop_gradient = False  # grads flow back to the rows
        self.var.is_data = True


class SparseTrainStep:
    """Wraps Executor.run with prefetch/push for distributed embeddings.

    Two drive modes:
      * run(feed): synchronous — prefetch, device step, push, in order.
        Deterministic; every batch reads rows that include every earlier
        batch's updates.
      * run_pipelined(feeds): the reference's ASYNC pserver loop
        (listen_and_serv_op.cc:175 RunAsyncLoop), overlapped at the step
        boundary — batch i+1's rows prefetch on a worker thread and batch
        i's sparse grads push on another while batch i (then i+1)
        computes on-device.  Barrier-free like the reference's async
        mode: a prefetch may read rows a not-yet-applied push would have
        updated — prefetch(i+1) is submitted before push(i), and push
        (i-1) may also still be in flight, so rows can be up to TWO
        updates stale.  Shard locks make the concurrent prefetch/push
        safe.

    Resilience: with a RemoteEmbeddingService the prefetch/push RPCs ride
    ResilientChannels — transient transport faults retry transparently and
    a ShardSupervisor (resilience.supervisor) makes shard death recoverable
    under this runner unchanged.  `on_push_error(emb, selected_rows, exc)
    -> bool` is the degradation hook for deployments that prefer dropping a
    sparse update to stopping the step loop (async-pserver semantics):
    return True to swallow the failed push, False/None to re-raise.
    """

    def __init__(self, exe, program, embeddings, loss, on_push_error=None):
        self.exe = exe
        self.program = program
        self.embeddings = list(embeddings)
        self.loss = loss
        self.on_push_error = on_push_error

    def _prefetch(self, feed):
        """(model_feed, ids_per_emb): pop id feeds, fetch rows from the
        service, stage them under the @rows var names."""
        feed = dict(feed)
        ids_per_emb = []
        for emb in self.embeddings:
            ids = np.asarray(feed.pop(emb.ids_feed_name), dtype=np.int64)
            ids_per_emb.append(ids)
            rows = emb.service.prefetch(ids.reshape(-1))
            feed[emb.var.name] = rows.reshape(
                ids.shape[0], emb.seq_len, emb.service.dim
            )
        return feed, ids_per_emb

    def _push_grads(self, ids_per_emb, grads):
        """Ship SelectedRows grads (host arrays: the Executor fetched them
        as numpy) to the service shards — in pipelined mode on the push
        thread, overlapped with the next step."""
        for emb, ids, g in zip(self.embeddings, ids_per_emb, grads):
            if g is None:
                continue
            flat_ids = ids.reshape(-1)
            flat_g = np.asarray(g).reshape(len(flat_ids), emb.service.dim)
            rows = SelectedRows(flat_ids, flat_g, emb.service.height)
            try:
                emb.service.push_sparse_grad(rows)
            except Exception as e:  # noqa: BLE001 — routed to the hook
                if not (self.on_push_error is not None
                        and self.on_push_error(emb, rows, e)):
                    raise

    def run(self, feed, fetch_list=None, scope=None):
        fetch_list = list(fetch_list or [self.loss])
        feed, ids_per_emb = self._prefetch(feed)
        grad_names = [grad_var_name(e.var.name) for e in self.embeddings]
        outs = self.exe.run(
            self.program, feed=feed,
            fetch_list=fetch_list + grad_names, scope=scope,
        )
        fetches, grads = outs[: len(fetch_list)], outs[len(fetch_list):]
        self._push_grads(ids_per_emb, grads)
        return fetches

    def run_pipelined(self, feeds, fetch_list=None, scope=None):
        """Generator over `feeds` (iterable of feed dicts) yielding each
        step's fetches; prefetch/push overlap the device step (see class
        docstring).  All pushes have been applied when the generator is
        exhausted (or closed) — checkpoint/read service state after that
        barrier, not mid-stream."""
        import concurrent.futures as cf

        fetch_list = list(fetch_list or [self.loss])
        grad_names = [grad_var_name(e.var.name) for e in self.embeddings]
        pre_pool = cf.ThreadPoolExecutor(1, "sparse-prefetch")
        push_pool = cf.ThreadPoolExecutor(1, "sparse-push")
        push_futs = []
        try:
            it = iter(feeds)
            try:
                nxt = pre_pool.submit(self._prefetch, next(it))
            except StopIteration:
                return
            while nxt is not None:
                model_feed, ids_per_emb = nxt.result()
                try:
                    nxt = pre_pool.submit(self._prefetch, next(it))
                except StopIteration:
                    nxt = None
                outs = self.exe.run(
                    self.program, feed=model_feed,
                    fetch_list=fetch_list + grad_names, scope=scope,
                )
                fetches = outs[: len(fetch_list)]
                grads = outs[len(fetch_list):]
                # one ordered push worker: surfacing a failed push is
                # deferred to the next submit or the final barrier
                done = [f for f in push_futs if f.done()]
                for f in done:
                    f.result()  # raise push errors promptly
                # prune against `done`, not a second f.done() probe — a
                # future completing between the two probes would vanish
                # without ever having result() called
                push_futs = [f for f in push_futs if f not in done]
                push_futs.append(
                    push_pool.submit(self._push_grads, ids_per_emb, grads))
                yield fetches
        finally:
            # barrier: wait for EVERY push (a failed one must not skip
            # the rest — a still-running push would race any post-exit
            # read of service state), then shut the pools, THEN raise
            errs = []
            for f in push_futs:
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)
            pre_pool.shutdown(wait=True)
            push_pool.shutdown(wait=True)
            if errs:
                inflight = sys.exc_info()[1]
                if inflight is None:
                    raise errs[0]
                # an exception is already propagating (device step failed,
                # or generator.close() injected GeneratorExit): raising
                # here would REPLACE it.  Attach the push error as context
                # instead so both survive in the traceback.
                if errs[0] is not inflight:
                    inflight.__context__ = errs[0]
