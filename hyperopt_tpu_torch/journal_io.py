"""Shared CRC-framed ``O_APPEND`` journal I/O.

Reference parity: ``hyperopt_tpu/journal_io.py``, byte for byte in its
framing: a queue written by either package reads in the other.  Each
record is written by :func:`tracing.format_record` as
``\\n<crc32 hex> <json>`` in ONE buffer and issued as ONE ``os.write``
on an ``O_APPEND`` handle, so:

- a torn tail (power loss, ``kill -9`` mid-append) garbles at most the
  record being written, never an acknowledged one;
- the next append's **leading newline** re-synchronizes the reader
  regardless of where the tear landed;
- concurrent appenders (threads or processes on a local filesystem)
  interleave at record granularity, never mid-record.

Readers (:func:`read_records`) skip torn lines and report their count;
callers decide whether a torn count is routine (an active journal tail
after a crash) or a finding (a sealed, immutable segment).

:func:`compact_records` is the matching rewrite half: the latest live
records land in a fresh file published by atomic replace
(``file_trials._atomic_write`` — tmp sibling, fsync, ``os.replace``),
so a crash mid-compaction leaves either the old file or the new one,
never a half-written hybrid.

The framing expression stays inline in each appending function: one
framed write per append.
"""

from __future__ import annotations

import json
import os
import sys
import time
import zlib

from . import tracing

__all__ = [
    "append_record",
    "append_records",
    "frame_record",
    "read_records",
    "read_records_bytes",
    "compact_records",
]


def _stats():
    """The process-wide StoreStats, at zero import cost when the store
    module was never loaded (a sys.modules miss, not an import)."""
    mod = sys.modules.get("hyperopt_tpu_torch.parallel.file_trials")
    return mod.store_stats() if mod is not None else None


def frame_record(payload, *, default=None) -> bytes:
    """One CRC-framed record (``tracing.format_record``) — for callers
    assembling a compaction/replication blob themselves."""
    return tracing.format_record(payload, default=default)


def append_records(path, payloads, *, default=None, fsync=True,
                   fsync_kind="journal", with_offset=False):
    """Append a batch of records as ONE ``O_APPEND`` write (group
    commit): every payload is CRC-framed individually, the frames are
    joined into a single buffer, and one write + (optionally) one
    ``fsync`` covers the whole batch.  Returns bytes written — or
    ``(bytes_written, end_offset)`` with ``with_offset`` (the segment
    store's post-append seal-race check needs to know exactly where its
    bytes landed).

    ``default`` passes through to ``json.dumps`` for codec-bearing
    payloads (datetimes, bytes — the trial-doc codec).  ``fsync=False``
    is for advisory logs (the chaos injection log) whose loss at a
    crash is acceptable; durable journals must keep the default.
    """
    blob = b"".join(
        tracing.format_record(p, default=default) for p in payloads
    )
    t0 = time.perf_counter()
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    try:
        os.write(fd, blob)  # ONE write: a tear garbles at most this batch
        end = os.lseek(fd, 0, os.SEEK_CUR)
        if fsync:
            os.fsync(fd)
    finally:
        os.close(fd)
    if fsync:
        stats = _stats()
        if stats is not None:
            stats.record_fsync(
                time.perf_counter() - t0, kind=fsync_kind,
                nbytes=len(blob),
            )
    if with_offset:
        return len(blob), end
    return len(blob)


def append_record(path, payload, **kwargs):
    """Append ONE CRC-framed record (see :func:`append_records`)."""
    return append_records(path, [payload], **kwargs)


def read_records_bytes(raw: bytes, *, object_hook=None):
    """(records, n_torn) from raw journal bytes.  Lines failing their
    CRC or JSON parse count as torn and are skipped — after a mid-write
    SIGKILL only the final append can legitimately be torn."""
    records, torn = [], 0
    for line in raw.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            crc_hex, body = line.split(b" ", 1)
            if (zlib.crc32(body) & 0xFFFFFFFF) != int(crc_hex, 16):
                raise ValueError("crc mismatch")
            records.append(
                json.loads(body.decode(), object_hook=object_hook)
            )
        except (ValueError, json.JSONDecodeError, UnicodeDecodeError):
            torn += 1
    return records, torn


def read_records(path, *, object_hook=None, missing_ok=True):
    """(records, n_torn) for a journal file.  A missing file reads as
    empty when ``missing_ok`` (a journal that was never appended to)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        if missing_ok:
            return [], 0
        raise
    return read_records_bytes(raw, object_hook=object_hook)


def compact_records(path, payloads, *, default=None,
                    fsync_kind="journal"):
    """Rewrite ``path`` to exactly ``payloads`` (CRC-framed) by atomic
    replace — the compaction half of the journal discipline.  Crash-safe
    at every instruction: the tmp sibling is fsync'd before ``replace``
    publishes it, so readers see the old file or the new one, never a
    partial rewrite.  Returns bytes written."""
    # late import: journal_io must stay importable without the store
    # package (tracing-only consumers), and file_trials imports journal
    # consumers transitively
    from .parallel.file_trials import _atomic_write

    blob = b"".join(
        tracing.format_record(p, default=default) for p in payloads
    )
    return _atomic_write(path, blob, fsync_kind=fsync_kind)
