"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` into ``csrc/build/lib<name>-<hash>.so`` (the hash
covers the source and the flags, so an edited source rebuilds). The build
directory is listed in ``.gitignore``. Nothing here runs at import time.

``build`` starts one ``nvcc`` per missing library, all at once, and waits
for them together, so a script that needs several kernels pays for the
slowest build only. Processes that build at once (the ranks of
``torchrun`` on a cold build directory) take turns under a file lock: the
first compiles, the others find the libraries built. Each library is
compiled under a temporary name and renamed into place, so no process
ever loads a partial file.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source on first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, in
    parallel. Returns the compiler output per name built now (ptxas's
    register and spill report); raises if any build fails."""
    if all(library_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not library_path(n).exists()]
        return _compile(todo) if todo else {}


def _compile(todo: Sequence[str]) -> Dict[str, str]:
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
