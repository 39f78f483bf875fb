"""Fault-tolerant checkpoint subsystem (counterpart of
paddle_tpu/checkpoint).

Async CheckpointManager with atomic commit (tmp-dir + manifest + rename),
per-file sha256 integrity manifests, keep-last-k/keep-every-n retention,
SIGTERM preemption latch, and newest-valid auto-resume — the durability
tier the reference split across contrib/trainer.py CheckpointConfig and
checkpoint_notify_op.cc.

    from paddle_tpu_torch import checkpoint
    mgr = checkpoint.CheckpointManager(root)
    mgr.save(step, scope=scope, main_program=main, services={"emb": svc})
    ...
    state = mgr.restore(scope=scope, main_program=main,
                        services={"emb": svc})
"""

from .manager import CheckpointManager, STEP_DIR_RE
from .manifest import (
    MANIFEST_NAME,
    file_sha256,
    load_manifest,
    verify_checkpoint_dir,
    write_manifest,
)

__all__ = [
    "CheckpointManager",
    "STEP_DIR_RE",
    "MANIFEST_NAME",
    "file_sha256",
    "load_manifest",
    "verify_checkpoint_dir",
    "write_manifest",
]
