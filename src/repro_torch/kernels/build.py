"""Build the Hopper kernels from `csrc/` with ``nvcc`` and load them.

Each source under ``csrc/`` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded
with `ctypes`.  Builds go to ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of the source, of every ``csrc/`` header it
includes (``#include "..."``, followed through headers) and of the flags,
so an edited source or header never loads a stale library.  Nothing
builds at import time: the first CUDA launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the Hopper kernels "
                           "cannot be built on this host")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` files it includes with quotes,
    transitively, in the order first met."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_source(name: str, *, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` into its library and return ``nvcc``'s
    output (with ``verbose``, ``-Xptxas -v``'s registers and shared
    memory).  Raises if the build fails."""
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
         "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


_LOAD_LOCK = threading.Lock()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, compiled on first use
    (one build per process however many threads launch at once: the
    temporary file is named by the process)."""
    with _LOAD_LOCK:
        path = library_path(name)
        if not path.exists():
            compile_source(name)
        return ctypes.CDLL(str(path))
