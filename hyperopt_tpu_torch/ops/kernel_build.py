"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, loaded
with ``ctypes`` (no PyTorch headers: that build takes seconds, not
minutes).  Libraries go to ``build/kernels/`` at the root of the checkout,
named by a hash of their source and of the shared headers (``*.cuh``)
so an edited kernel or header is rebuilt; they are
built at first use, or all at once, in parallel, by :func:`build`.
Nothing here runs when the module is imported.  One module lock
serializes :func:`load`'s check, build and load, so two threads' first
launch of one kernel run ``nvcc`` once; each build writes its own
temporary file and publishes it with ``os.replace``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded = {}  # guarded-by: _lock
# kernel-library cache accounting (the compile ledger's cache counters):
# a load that found its library on disk is a hit, one that ran nvcc a miss
_cache_events = {"hits": 0, "misses": 0}  # guarded-by: _lock


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in hyperopt_tpu_torch/csrc")


def nvcc_command(src, out) -> list:
    """The ``nvcc`` command that builds CUDA source ``src`` into the shared
    library ``out`` with the kernels' flags."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: named by a hash of its source,
    every shared header in ``csrc/`` and the flags, so an edit to any of
    them builds a new library."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns, per name,
    ``{"path", "seconds", "ptxas"}`` (``ptxas`` is the compiler's
    ``-Xptxas -v`` report, empty when the library was already built).
    Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"path": str(out), "seconds": 0.0, "ptxas": ""}
            continue
        # unique per build: two builds of one library never share a file
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f"{out.name}.", suffix=".tmp")
        os.close(fd)
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp)
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            with contextlib.suppress(FileNotFoundError):
                os.unlink(tmp)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        report[name] = {"path": str(out), "seconds": time.perf_counter() - t0,
                        "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def set_build_dir(path) -> Path:
    """Build and load kernel libraries under ``path`` from now on (the
    service's ``--compile-cache-dir``: a restart on the same directory
    loads the libraries an earlier process built)."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    return BUILD_DIR


def cache_events() -> dict:
    """``{"hits", "misses"}``: library loads that found their library
    built, and those that built it."""
    with _lock:
        return dict(_cache_events)


def n_loaded() -> int:
    """How many kernel libraries this process has loaded so far."""
    with _lock:
        return len(_loaded)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.  The
    first caller builds and loads it under the module lock; a concurrent
    caller waits and gets the same library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if path.exists():
                _cache_events["hits"] += 1
            else:
                _cache_events["misses"] += 1
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
