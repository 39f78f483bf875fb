"""Build and load the port's CUDA kernels.

Each `paddle_tpu_torch/csrc/<name>.cu` is compiled on first use by its own
`nvcc` process into a shared library with a plain C interface, loaded with
ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

The libraries land in `build/torch_kernels/` at the root of the checkout,
named by a hash of the source, of every header it includes from `csrc/`
(`#include "..."`, followed recursively) and of the flags, so an edited
source or header builds anew and an unchanged one is reused.  `build()`
starts one nvcc for every source that needs it, all at once, and waits
for them all; nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("mha_block", "mha_block_bwd", "flash_decode",
           "flash_decode_paged", "flash_attention_fwd", "flash_attention_bwd",
           "bn_relu_conv1x1")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are built from "
        "paddle_tpu_torch/csrc on the machine with the card")


def _source_files(name: str) -> list:
    """csrc/<name>.cu and every csrc header it includes, directly or
    through another header, each once, in the order first reached."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.exists():
                todo.append(header)
    return files


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together.  Returns {name: {"path", "seconds",
    "log"}}; "log" holds nvcc's -Xptxas -v report (empty when the library
    was already built).  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    for name in names:
        out = lib_path(name)
        info[name] = {"path": str(out), "seconds": 0.0, "log": ""}
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        info[name]["seconds"] = time.perf_counter() - t0
        info[name]["log"] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
