"""ctypes loader/builder for the native FileTrials queue scan.

Reference parity: ``hyperopt_tpu/native.py``.  The C++ fast path for the
legacy per-doc queue layout (``native/fastqueue.cpp``, shared read-only
with the JAX package) is built on demand with g++ into the port's own
ignored ``build/native/`` and loaded via ctypes.  The build writes a
temporary file and renames it into place, so a process loading the
library never maps a half-written one.  Every native entry point returns
None when the library is missing or a doc does not parse, and the caller
then takes the exact Python path.  This is a host scan, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "fastqueue.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB = os.path.join(_BUILD_DIR, "libfastqueue.so")

_lock = threading.Lock()
# Double-checked load: _lock guards every WRITE of the two state
# globals; the lock-free fast-path reads in load_fastqueue are benign
# (each global flips exactly once, unset -> settled) and are marked
# inline where they occur.
_lib = None  # guarded-by: _lock
_lib_failed = False  # guarded-by: _lock


def _build():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build aside, then rename: concurrent builders (test workers, queue
    # workers starting together) each publish a whole library
    tmp = f"{_LIB}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_fastqueue():
    """The fastqueue library handle, or None if unavailable."""
    global _lib, _lib_failed
    # lock-free fast path of the double-checked load (benign: settled
    # values never change again)
    if _lib is not None or _lib_failed:  # lint: disable=RL301
        return _lib  # lint: disable=RL301
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
            ):
                _build()
            lib = ctypes.CDLL(_LIB)
            lib.fq_count_states.restype = ctypes.c_int
            lib.fq_count_states.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_long),
            ]
            lib.fq_list_state.restype = ctypes.c_int
            lib.fq_list_state.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_int,
            ]
            lib.fq_try_lock.restype = ctypes.c_int
            lib.fq_try_lock.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            _lib = lib
        except (OSError, subprocess.SubprocessError, FileNotFoundError) as e:
            logger.info("fastqueue native build unavailable: %s", e)
            _lib_failed = True
    # post-settle read outside the lock (benign, see note at the top)
    return _lib  # lint: disable=RL301


def count_states(trials_dir, n_states=8):
    """(counts list, n_docs) via the native scanner; None → use Python."""
    lib = load_fastqueue()
    if lib is None:
        return None
    counts = (ctypes.c_long * n_states)()
    unparsed = ctypes.c_long(0)
    n = lib.fq_count_states(
        trials_dir.encode(), counts, n_states, ctypes.byref(unparsed)
    )
    if n < 0 or unparsed.value > 0:
        return None  # fall back to the exact Python parser
    return list(counts), n


def list_state(trials_dir, state, max_out=1 << 16):
    lib = load_fastqueue()
    if lib is None:
        return None
    tids = (ctypes.c_long * max_out)()
    n = lib.fq_list_state(trials_dir.encode(), int(state), tids, max_out)
    if n < 0:
        return None
    return [tids[i] for i in range(n)]


def try_lock(lock_path, owner):
    """1 locked, 0 already locked, None → use the Python primitive."""
    lib = load_fastqueue()
    if lib is None:
        return None
    r = lib.fq_try_lock(lock_path.encode(), owner.encode())
    return None if r < 0 else r
