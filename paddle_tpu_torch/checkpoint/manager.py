"""CheckpointManager: fault-tolerant, async, serial-numbered checkpoints
(counterpart of paddle_tpu/checkpoint/manager.py).  A step directory is
the JAX package's layout, so each package restores the other's and
tools/ckpt_fsck.py checks the port's.  The dense state goes through
io.py's sharded checkpoint in its single-process form; MoE expert
placements (`moe=`) ride beside it as `moe_<name>.json`.  What needs
several devices (`gather=True`, a `mesh`) raises until it is ported
(ROADMAP.md A item 7).

The durability layer the reference spread across CheckpointConfig
(contrib/trainer.py: periodic serial snapshots + LRU cleanup) and
checkpoint_notify_op.cc (pserver snapshot fan-out), rebuilt as one
subsystem with the guarantees a preemptible fleet needs:

- COMPLETE state: dense params + optimizer moments (via
  io.snapshot_sharded), sparse EmbeddingService shards + adagrad
  accumulators (state_dict), RNG seeds, epoch/step counters, and the
  trace-affecting flag signature — one `step_<N>/` directory holds
  everything a resume needs.
- ATOMIC commit: all payload goes into `step_<N>.tmp/`, a manifest.json
  with per-file sha256 + file census is written last, then one
  os.replace renames the directory into existence.  A crash at any
  point leaves either the previous committed checkpoint or a `.tmp`
  that scan() quarantines — never a half-readable "latest".
- ASYNC save: card tensors are copied to host numpy on the caller
  thread (the only part that must see a consistent scope); a background
  writer thread serializes, checksums, commits, and garbage-collects.
  `wait()` barriers; writer errors surface on wait() AND on the next
  save() — an async failure can never be silently dropped.
- RETENTION: keep-last-k plus keep-every-n survivors, applied only to
  COMMITTED checkpoints after each commit.
- PREEMPTION: install_preemption_hook() latches SIGTERM into
  `.preempted` so the training loop can cut a final checkpoint at the
  next step boundary instead of dying mid-step.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import signal
import threading
import warnings

from . import manifest as _manifest

__all__ = ["CheckpointManager", "STEP_DIR_RE"]

STEP_DIR_RE = re.compile(r"^step_(\d+)$")
_TMP_SUFFIX = ".tmp"
_QUARANTINE_SUFFIX = ".quarantine"
_STATE_FILE = "train_state.json"
_DENSE_DIR = "dense"
_SPARSE_PREFIX = "sparse_"
_MOE_PREFIX = "moe_"


class CheckpointManager:
    """Serial-numbered checkpoints under `root/step_<N>/`.

        mgr = checkpoint.CheckpointManager("/ckpt/run7", keep_last_k=3)
        mgr.save(step, scope=scope, main_program=main,
                 services={"emb": svc}, epoch=epoch)   # returns fast (async)
        ...
        mgr.wait()                                     # barrier + error check
        state = mgr.restore(scope=scope, main_program=main,
                            services={"emb": svc})     # newest valid
        start_step = state["step"] + 1

    async_save=None reads flags.get("ckpt_async"); keep_last_k=None reads
    flags.get("ckpt_keep").  keep_every_n > 0 additionally exempts every
    n-th step from garbage collection (milestone checkpoints)."""

    def __init__(self, root, keep_last_k=None, keep_every_n=0,
                 async_save=None):
        from .. import flags

        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep_last_k = (flags.get("ckpt_keep") if keep_last_k is None
                            else int(keep_last_k))
        self.keep_every_n = int(keep_every_n)
        self.async_save = (bool(flags.get("ckpt_async")) if async_save is None
                           else bool(async_save))
        self._queue = queue.Queue()
        self._writer = None
        self._error = None          # (exc) from the writer, pending surfacing
        self._error_lock = threading.Lock()
        self._inflight = set()      # tmp dir names owned by our writer
        self._inflight_lock = threading.Lock()
        self._preempted = threading.Event()
        self._prev_handlers = {}
        # test/fault-injection hook: called on the WRITER thread right
        # before a job's payload is written (block it to hold a save
        # in-flight; raise from it to inject a writer error)
        self._before_write = None

    # ------------------------------------------------------------------
    # paths + scanning
    # ------------------------------------------------------------------
    def step_path(self, step):
        return os.path.join(self.root, f"step_{int(step)}")

    def steps(self):
        """Committed step numbers, ascending (no validation)."""
        out = []
        for name in os.listdir(self.root):
            m = STEP_DIR_RE.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def _quarantine(self, name):
        """Move a partial/corrupt directory aside (never delete evidence)."""
        src = os.path.join(self.root, name)
        dst = src + _QUARANTINE_SUFFIX
        n = 1
        while os.path.exists(dst):
            n += 1
            dst = f"{src}{_QUARANTINE_SUFFIX}.{n}"
        os.replace(src, dst)
        warnings.warn(
            f"checkpoint: quarantined {name!r} -> {os.path.basename(dst)} "
            "(partial or corrupt — not restorable)",
            RuntimeWarning, stacklevel=3,
        )
        return dst

    def _sweep_stale_tmp(self):
        """Quarantine `.tmp` leftovers from a crashed writer — but never a
        tmp dir our own writer currently owns."""
        with self._inflight_lock:
            inflight = set(self._inflight)
        for name in os.listdir(self.root):
            if name.endswith(_TMP_SUFFIX) and name not in inflight:
                base = name[:-len(_TMP_SUFFIX)]
                if STEP_DIR_RE.match(base):
                    self._quarantine(name)

    def latest(self, deep=True):
        """Newest step whose directory verifies against its manifest.
        Scans newest-first; invalid candidates are quarantined and the
        scan moves on.  Returns None when nothing is restorable."""
        self._sweep_stale_tmp()
        for step in sorted(self.steps(), reverse=True):
            ok, _problems = _manifest.verify_checkpoint_dir(
                self.step_path(step), deep=deep)
            if ok:
                return step
            self._quarantine(f"step_{step}")
        return None

    # ------------------------------------------------------------------
    # error surfacing
    # ------------------------------------------------------------------
    def check_error(self):
        """Raise (and clear) a pending background-writer error."""
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "checkpoint: background writer failed for a previous "
                "save()"
            ) from err

    def wait(self):
        """Barrier: block until every enqueued save has committed, then
        surface any writer error."""
        self._queue.join()
        self.check_error()

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, step, scope=None, main_program=None, services=None,
             epoch=None, extras=None, sync=None, moe=None,
             reader_cursor=None, gather=False):
        """Snapshot the complete training state as checkpoint `step`.

        The device->host snapshot happens on THIS thread (so the scope may
        mutate freely afterwards); serialization + atomic commit happen on
        the background writer unless sync (or async_save=False).  Returns
        the final committed path (which exists only after commit in async
        mode).  Raises a pending writer error from an earlier async save
        before doing anything.

        Stamped into the train state: the step, epoch, the program's
        random_seed, the trace-affecting flag signature, each sparse
        service's shard count and routing epoch (`sparse_topology`), and
        `reader_cursor`, a dict like {"step": N, "seed": S} recording the
        data-stream position the checkpoint was cut at (restore() returns
        it).  A program annotated by parallel.apply_zero would also stamp
        `zero_topology`; the port has no such program yet.

        `moe` is {layer_name: ExpertPlacement} (moe.placements_for_program
        builds it): each placement's expert -> shard table is written as
        `moe_<name>.json` and stamped into the state's `moe_topology`, as
        sparse services stamp `sparse_topology`, so a resume sees the
        placement epoch the expert params were saved at.

        `gather=True` (the multi-process single-writer mode) raises until
        multi-device training is ported (ROADMAP.md A item 7)."""
        self.check_error()
        from .. import flags
        from ..io import snapshot_sharded

        step = int(step)
        arrays, index, skipped = snapshot_sharded(scope, main_program,
                                                  gather=gather)
        if skipped:
            warnings.warn(
                f"checkpoint: {len(skipped)} persistable var(s) absent "
                f"from the scope not saved: {sorted(skipped)[:8]}",
                RuntimeWarning, stacklevel=2,
            )
        sparse_states = {
            name: svc.state_dict()
            for name, svc in (services or {}).items()
        }
        program = main_program
        if program is None:
            from ..framework.framework import default_main_program

            program = default_main_program()
        state = {
            "step": step,
            "epoch": epoch,
            "random_seed": getattr(program, "random_seed", 0),
            "trace_signature": [list(kv) for kv in flags.trace_signature()],
            "sparse_services": sorted(sparse_states),
            # topology in the world stamp: the shard count + routing
            # epoch each sparse service was saved at, so a resume can
            # detect (and fsck can cross-check) a mid-reshard world
            "sparse_topology": {
                name: {
                    "num_shards": sstate["meta"].get("num_shards"),
                    "routing_epoch": (sstate["meta"].get("routing") or {})
                    .get("epoch"),
                }
                for name, sstate in sparse_states.items()
            },
            "extras": extras or {},
            "reader_cursor": reader_cursor,
        }
        zero_meta = getattr(program, "_zero_meta", None)
        state["zero_topology"] = dict(zero_meta) if zero_meta else None
        moe_metas = {name: p.to_meta() for name, p in (moe or {}).items()}
        state["moe_topology"] = {
            name: {
                "num_experts": meta.get("num_experts"),
                "num_shards": meta.get("num_shards"),
                "placement_epoch": (meta.get("routing") or {}).get("epoch"),
            }
            for name, meta in moe_metas.items()
        }
        job = {"step": step, "arrays": arrays, "index": index,
               "sparse": sparse_states, "moe": moe_metas, "state": state}
        use_async = self.async_save if sync is None else not sync
        if use_async:
            self._ensure_writer()
            with self._inflight_lock:
                self._inflight.add(f"step_{step}{_TMP_SUFFIX}")
            self._queue.put(job)
        else:
            self._write_commit(job)
        return self.step_path(step)

    def _ensure_writer(self):
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._writer.start()

    def _writer_loop(self):
        while True:
            job = self._queue.get()
            try:
                self._write_commit(job)
            except BaseException as e:  # surfaced on wait()/next save
                with self._error_lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._inflight_lock:
                    self._inflight.discard(
                        f"step_{job['step']}{_TMP_SUFFIX}")
                self._queue.task_done()

    def _write_commit(self, job):
        """Serialize one snapshot into step_<N>.tmp/, manifest it, and
        atomically rename into step_<N>/ (the commit point)."""
        from ..io import write_sharded
        from ..sparse.embedding_service import EmbeddingService

        step = job["step"]
        final = self.step_path(step)
        tmp = final + _TMP_SUFFIX
        if os.path.exists(tmp):
            shutil.rmtree(tmp)  # stale tmp from our own earlier attempt
        os.makedirs(tmp)
        hook = self._before_write
        if hook is not None:
            hook(step)
        write_sharded(os.path.join(tmp, _DENSE_DIR), job["arrays"],
                      job["index"])
        for name, sstate in job["sparse"].items():
            EmbeddingService.write_state(
                os.path.join(tmp, _SPARSE_PREFIX + name), sstate)
        for name, meta in job["moe"].items():
            with open(os.path.join(tmp, _MOE_PREFIX + name + ".json"),
                      "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
        with open(os.path.join(tmp, _STATE_FILE), "w") as f:
            json.dump(job["state"], f, indent=1, sort_keys=True)
        _manifest.write_manifest(
            tmp, step=step,
            sharding={"world": 1,
                      "vars": {n: len(e) for n, e in job["index"].items()}},
            state={"epoch": job["state"]["epoch"]},
        )
        if os.path.exists(final):
            shutil.rmtree(final)  # re-save of the same serial
        os.replace(tmp, final)  # COMMIT
        self._gc()

    # ------------------------------------------------------------------
    # retention
    # ------------------------------------------------------------------
    def _gc(self):
        """keep-last-k + keep-every-n over COMMITTED checkpoints."""
        if self.keep_last_k <= 0:
            return
        steps = self.steps()
        keep = set(steps[-self.keep_last_k:])
        if self.keep_every_n > 0:
            keep |= {s for s in steps if s % self.keep_every_n == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_path(s), ignore_errors=True)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def restore(self, step=None, scope=None, main_program=None, mesh=None,
                services=None, moe=None, place=None):
        """Restore the newest valid checkpoint (or exactly `step`).

        Verifies the manifest (full sha256) before loading; scan mode
        quarantines failed candidates and falls back to the next-newest.
        Loads dense state via io.load_sharded, sparse services by name, and
        re-applies the saved program random_seed.  Returns the train_state dict (step, epoch,
        extras, path, restored_vars) or None when no restorable
        checkpoint exists.  Warns if the saved trace-affecting flag
        signature differs from the current one (the resumed run would
        compile different executables).

        `moe` is {layer_name: ExpertPlacement}: each placement adopts the
        checkpointed `moe_<name>.json` table (load_meta checks the expert
        and shard counts), so a resumed run has the placement epoch its
        expert params were saved at.  A placement the checkpoint lacks
        raises IOError.  `mesh` (re-staging under a device mesh) raises
        until multi-device training is ported (ROADMAP.md A item 7;
        io.load_sharded raises on it).

        A dense var the scope already holds is overwritten in place;
        others are created on `place` (default: the card), see
        io.load_sharded."""
        # drain our own in-flight saves first: restoring "latest" while
        # the writer is mid-commit must not race the rename
        if self._writer is not None:
            self.wait()
        from ..io import load_sharded

        if step is not None:
            path = self.step_path(step)
            ok, problems = _manifest.verify_checkpoint_dir(path)
            if not ok:
                raise IOError(
                    f"checkpoint step {step} at {path!r} failed "
                    f"verification: {problems}"
                )
            chosen = int(step)
        else:
            chosen = self.latest(deep=True)
            if chosen is None:
                return None
            path = self.step_path(chosen)
        with open(os.path.join(path, _STATE_FILE)) as f:
            state = json.load(f)
        restored = load_sharded(os.path.join(path, _DENSE_DIR), scope=scope,
                                main_program=main_program, mesh=mesh,
                                place=place)
        # ZeRO cross-check: a stamp with no matching annotations on the
        # restoring program means the moments just restored REPLICATED —
        # numerically correct (load_sharded assembled the global value)
        # but the 1/dp memory saving the save-side run had is gone, which
        # on a real fleet is the difference between fitting and OOM.
        # A different dp extent is NOT warned: elastic restore is the
        # point (load_sharded re-partitions deterministically).
        saved_zero = state.get("zero_topology")
        cur_zero = (getattr(main_program, "_zero_meta", None)
                    if main_program is not None else None)
        if saved_zero and main_program is not None and not cur_zero:
            warnings.warn(
                f"checkpoint: step {chosen} was saved with ZeRO stage "
                f"{saved_zero.get('stage')} over "
                f"{saved_zero.get('axis')}={saved_zero.get('axis_size')} "
                "but the restoring program has no apply_zero annotations "
                "— optimizer moments restore replicated",
                RuntimeWarning, stacklevel=2,
            )
        for name, svc in (services or {}).items():
            sdir = os.path.join(path, _SPARSE_PREFIX + name)
            if not os.path.isdir(sdir):
                raise IOError(
                    f"checkpoint step {chosen} has no sparse service "
                    f"{name!r} (saved: {state.get('sparse_services')})"
                )
            svc.load(sdir)
        for name, placement in (moe or {}).items():
            mpath = os.path.join(path, _MOE_PREFIX + name + ".json")
            if not os.path.isfile(mpath):
                raise IOError(
                    f"checkpoint step {chosen} has no MoE placement "
                    f"{name!r} (saved: "
                    f"{sorted(state.get('moe_topology') or {})})"
                )
            with open(mpath) as f:
                placement.load_meta(json.load(f))
        from .. import flags

        now_sig = [list(kv) for kv in flags.trace_signature()]
        saved_sig = state.get("trace_signature")
        if saved_sig is not None and saved_sig != now_sig:
            warnings.warn(
                "checkpoint: trace-affecting flag signature changed since "
                f"save (saved {saved_sig} != current {now_sig}) — the "
                "resumed run will compile different executables",
                RuntimeWarning, stacklevel=2,
            )
        if main_program is not None and state.get("random_seed") is not None:
            main_program.random_seed = state["random_seed"]
        state["path"] = path
        state["restored_vars"] = restored
        return state

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------
    def preemption_save(self, step, scope=None, main_program=None,
                        services=None, epoch=None, extras=None, moe=None,
                        reader_cursor=None, gather=False):
        """The SIGTERM drain: fence the background writer, then cut a
        final SYNCHRONOUS checkpoint and return its committed path.

        The fence order matters.  A preemption save races whatever async
        save is still in flight: without the wait(), _write_commit runs
        concurrently on this thread and on the writer thread over the
        same directory tree, and each commit's _gc()/_sweep_stale_tmp()
        can observe (and quarantine or delete) the other's half-renamed
        step dir.  wait() first drains the queue and surfaces any writer
        error; only then is the final snapshot taken — so it also
        captures any scope mutations that happened while the writer was
        catching up — and committed on the calling thread."""
        self.wait()
        return self.save(step, scope=scope, main_program=main_program,
                         services=services, epoch=epoch, extras=extras,
                         sync=True, moe=moe, reader_cursor=reader_cursor,
                         gather=gather)

    def install_preemption_hook(self, signals=(signal.SIGTERM,)):
        """Latch the given signals into `.preempted` so the training loop
        can request a final save at the next step boundary.  Chains to a
        previously installed Python handler (never to SIG_DFL — the point
        is to NOT die mid-step).  No-op off the main thread (signal
        handlers are main-thread-only in CPython)."""
        for sig in signals:
            try:
                prev = signal.signal(sig, self._on_preempt_signal)
            except ValueError:  # not on the main thread
                return False
            self._prev_handlers.setdefault(sig, prev)
        return True

    def uninstall_preemption_hook(self):
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers = {}

    def _on_preempt_signal(self, signum, frame):
        self._preempted.set()
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)

    @property
    def preempted(self):
        """True once a hooked signal arrived — save and stop at the next
        step boundary."""
        return self._preempted.is_set()
