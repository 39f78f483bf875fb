"""Checkpoint integrity manifest: per-file sha256 + census of a snapshot
(counterpart of paddle_tpu/checkpoint/manifest.py, the same format, so
tools/ckpt_fsck.py checks either package's checkpoints).

A committed checkpoint directory carries a `manifest.json` written LAST
(after every payload file): its presence is the commit record, its
checksums are the integrity proof.  restore/fsck verify the manifest
before trusting a directory — a partial write (crash between payload and
manifest), a truncated npz, or a bit-flipped file all fail verification
and get quarantined instead of restored (reference durability analog:
the pserver snapshot + CheckpointConfig serial dirs, contrib/trainer.py;
design analog: Orbax-style commit-via-rename for TPU training stacks).
"""

from __future__ import annotations

import hashlib
import json
import os

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1

__all__ = ["MANIFEST_NAME", "file_sha256", "write_manifest", "load_manifest",
           "verify_checkpoint_dir"]


def file_sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _payload_files(dirname):
    """Relative paths of every file under dirname except the manifest."""
    rels = []
    for base, _dirs, files in os.walk(dirname):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), dirname)
            if rel != MANIFEST_NAME:
                rels.append(rel)
    return sorted(rels)


def write_manifest(dirname, step=None, sharding=None, state=None, extra=None):
    """Checksum every file currently under `dirname` and write
    manifest.json (the commit record — call after all payload writes).
    The manifest is fsynced so a commit that returned survives the page
    cache; returns the manifest dict."""
    files = {}
    for rel in _payload_files(dirname):
        path = os.path.join(dirname, rel)
        files[rel] = {"sha256": file_sha256(path),
                      "bytes": os.path.getsize(path)}
    manifest = {
        "format": FORMAT_VERSION,
        "step": step,
        "file_count": len(files),
        "files": files,
    }
    if sharding is not None:
        manifest["sharding"] = sharding
    if state is not None:
        manifest["state"] = state
    if extra:
        manifest.update(extra)
    path = os.path.join(dirname, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return manifest


def load_manifest(dirname):
    with open(os.path.join(dirname, MANIFEST_NAME)) as f:
        return json.load(f)


def verify_checkpoint_dir(dirname, deep=True):
    """Validate a checkpoint directory against its manifest.

    Returns (ok, problems): problems is a list of human-readable strings —
    empty means the directory is restore-ready.  deep=False skips the
    sha256 recompute (existence + size census only), for cheap scans."""
    problems = []
    if not os.path.isdir(dirname):
        return False, [f"not a directory: {dirname}"]
    mpath = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return False, ["no manifest.json (uncommitted or partial write)"]
    try:
        manifest = load_manifest(dirname)
    except (ValueError, OSError) as e:
        return False, [f"manifest unreadable: {e}"]
    files = manifest.get("files")
    if not isinstance(files, dict):
        return False, ["manifest has no 'files' census"]
    if manifest.get("file_count") != len(files):
        problems.append(
            f"file_count {manifest.get('file_count')} != census size "
            f"{len(files)}"
        )
    for rel, meta in sorted(files.items()):
        path = os.path.join(dirname, rel)
        if not os.path.exists(path):
            problems.append(f"missing file: {rel}")
            continue
        size = os.path.getsize(path)
        if size != meta.get("bytes"):
            problems.append(
                f"size mismatch: {rel} is {size} bytes, manifest says "
                f"{meta.get('bytes')}"
            )
            continue
        if deep and file_sha256(path) != meta.get("sha256"):
            problems.append(f"checksum mismatch: {rel}")
    extra = set(_payload_files(dirname)) - set(files)
    if extra:
        # extra files are not fatal for restore, but they mean the
        # directory is not exactly what was committed — report them
        problems.append(f"files not in manifest: {sorted(extra)}")
    return not problems, problems
