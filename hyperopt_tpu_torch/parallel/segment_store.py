"""Segmented append-only trial log — the O(delta) trial store.

Reference parity: ``hyperopt_tpu/parallel/segment_store.py``, with the
same on-disk format, so either package reads a queue the other wrote.

The per-doc layout (``trials/<tid>.json``, one atomic-replace + fsync
per trial-state transition, an O(N) directory scan per refresh) is
correct and simple, but its costs scale with *total* trial count: at
the 100k-trial studies the ROADMAP targets, every refresh re-reads
100k files and every transition pays a full tmp/fsync/replace cycle.
This module promotes the battle-tested ``O_APPEND`` + CRC journal
format (the response journal / compile ledger / trace log discipline,
shared via :mod:`hyperopt_tpu_torch.journal_io`) into the PRIMARY trial
store:

``<queue>/segments/seg-<seq>.log``
    Fixed-size segments of CRC-framed records (``\\n<crc32 hex>
    <json>`` via ``tracing.format_record``), one ``O_APPEND`` write —
    and one fsync — per append *call*; a batch of docs group-commits as
    ONE write + ONE fsync.  A torn tail garbles at most the record
    being written; the next append's leading newline re-synchronizes
    every reader.

``<queue>/segments/MANIFEST.json``
    The recovery protocol, in one CRC-trailed doc published by atomic
    replace: the ordered list of **sealed** (immutable) segments — each
    pinned to an exact byte length, record count, and CRC32 — plus the
    name of the single **active** segment appends go to.  Recovery =
    replay segments in manifest order; replication = ship sealed
    segments (the reference's ``service.replicas.SegmentMirror``, not
    ported yet).

Refresh is O(delta): every reader keeps a per-segment byte cursor and
replays only the unseen tail — a stat of the manifest plus a read of
the new bytes — instead of re-reading N doc files.  The in-memory
materialized view (latest doc per tid, plus per-state tid sets) is
what ``FileJobs`` serves ``all_docs``/``count_states``/``reserve``
scans from, which is how the serve hot path reaches ZERO O(N)
directory scans (StoreStats-reconciled).

Compaction folds the latest doc per tid into a fresh base segment
(atomic publish), swaps the manifest (epoch bump), re-homes any
straggler records a concurrent appender landed in the old active, and
only then unlinks the retired segments.  A SIGKILL at any point leaves
either the old manifest (old segments intact) or the new one (retired
segments at worst orphaned on disk — the reference's fsck, FS412,
reclaims them).

Concurrent multi-process appenders are safe on a local/NFS-close
filesystem: ``O_APPEND`` writes interleave at record granularity, and
every appender re-checks the manifest AFTER its write — if a
concurrent seal or compaction cut the segment under it, the appender
re-appends its records to the current active (replay is latest-wins
per tid, so the superseded copy is harmless).
"""

from __future__ import annotations

import copy
import glob
import json
import logging
import os
import threading
import time
import zlib

from .. import journal_io
from ..base import JOB_STATES

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
SEGMENT_GLOB = "seg-*.log"
DEFAULT_SEGMENT_MAX_BYTES = 4 * 1024 * 1024
# auto-compaction: once superseded (dead) records outnumber live tids
# by this factor AND at least one segment has sealed, fold the log
DEFAULT_COMPACT_DEAD_FACTOR = 8


def _codec():
    """(dumps-default, loads-object-hook): THE trial-doc codec, shared
    with the per-doc layout so docs round-trip datetimes/bytes
    identically whichever backend wrote them."""
    from .file_trials import _json_default, _json_object_hook

    return _json_default, _json_object_hook


def _active_chaos():
    import sys

    mod = sys.modules.get("hyperopt_tpu_torch.resilience.chaos")
    return mod.get_active() if mod is not None else None


def _stats():
    from .file_trials import store_stats

    return store_stats()


def segment_name(seq: int) -> str:
    return f"seg-{int(seq):08d}.log"


def parse_segment_chunk(chunk: bytes, object_hook=None):
    """Incremental frame parser: ``(records, consumed, n_torn,
    n_pending)`` from a byte range of a segment file.

    ``consumed`` is the offset just past the last VALID record — a
    trailing line that fails its CRC is **left unconsumed** (``n_pending``
    counts it) because it may be a concurrent append still in flight;
    the next read re-attempts it.  Invalid lines that are *followed* by
    a valid record are genuinely torn (``n_torn``) and are consumed by
    the leading-newline resync."""
    records, consumed, torn, pending = [], 0, 0, 0
    n = len(chunk)
    start = 0
    while start < n:
        end = chunk.find(b"\n", start + 1)
        if end == -1:
            end = n
        line = chunk[start:end].strip()
        if line:
            try:
                crc_hex, body = line.split(b" ", 1)
                if (zlib.crc32(body) & 0xFFFFFFFF) != int(crc_hex, 16):
                    raise ValueError("crc mismatch")
                rec = json.loads(body.decode(), object_hook=object_hook)
            except (ValueError, json.JSONDecodeError, UnicodeDecodeError):
                pending += 1
                start = end
                continue
            records.append(rec)
            consumed = end
            torn += pending
            pending = 0
        start = end
    return records, consumed, torn, pending


class SegmentStore:
    """One study's segmented trial log + its materialized view.

    Thread-safe; cross-process safe for concurrent appenders (see the
    module docstring for the seal/compaction race protocol).  All disk
    state lives under ``<root>/segments``; the manifest's existence IS
    the "this queue is segmented" marker ``FileJobs`` detects.
    """

    # lock-order: _lock (never held across another SegmentStore's lock)
    def __init__(self, root, segment_max_bytes=DEFAULT_SEGMENT_MAX_BYTES,
                 compact_dead_factor=DEFAULT_COMPACT_DEAD_FACTOR,
                 auto_compact=True):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "segments")
        self.segment_max_bytes = int(segment_max_bytes)
        self.compact_dead_factor = int(compact_dead_factor)
        self.auto_compact = bool(auto_compact)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        # materialized view — guarded-by: _lock
        self._view = {}            # tid -> latest doc
        self._state_tids = {s: set() for s in JOB_STATES}
        self._manifest = None      # last manifest doc we loaded
        self._manifest_sig = None  # (st_mtime_ns, st_size, st_ino)
        self._offsets = {}         # segment name -> bytes applied
        self._applied_records = 0  # records replayed into the view
        # consumer-cursor log: tids in apply order, so readers with their
        # own cursor (FileTrials' delta refresh) never miss docs another
        # reader's refresh already folded into the shared view
        self._log = []             # guarded-by: _lock
        self._log_gen = 0          # bumped on every full replay
        self._load()

    # -- paths ---------------------------------------------------------
    @property
    def manifest_path(self):
        return os.path.join(self.dir, MANIFEST_NAME)

    def segment_path(self, name):
        return os.path.join(self.dir, name)

    @staticmethod
    def is_segmented(root) -> bool:
        """Does ``root`` carry a segmented store (manifest present)?"""
        return os.path.exists(
            os.path.join(os.path.abspath(root), "segments", MANIFEST_NAME)
        )

    # -- manifest ------------------------------------------------------
    def _read_manifest(self):
        """(manifest, stat-sig) from disk; (None, None) when absent or
        persistently unreadable (fsck's FS411 owns the repair)."""
        from .file_trials import _read_doc

        try:
            st = os.stat(self.manifest_path)
        except FileNotFoundError:
            return None, None
        sig = (st.st_mtime_ns, st.st_size, st.st_ino)
        doc = _read_doc(self.manifest_path, quarantine=False)
        return doc, sig

    def _write_manifest(self, manifest):
        """Publish a manifest revision by atomic replace and refresh the
        cached stat-sig so our own write is not re-read as news."""
        from .file_trials import _write_doc

        _write_doc(self.manifest_path, manifest, fsync_kind="segment")
        st = os.stat(self.manifest_path)
        self._manifest = manifest
        self._manifest_sig = (st.st_mtime_ns, st.st_size, st.st_ino)

    def _fresh_manifest(self):
        return {
            "version": 1,
            "epoch": 0,
            "next_seq": 2,
            "active": segment_name(1),
            "sealed": [],
        }

    def _load(self):
        with self._lock:
            manifest, sig = self._read_manifest()
            if manifest is None:
                # fresh store (or a pre-segment dir being initialized):
                # publish the empty manifest so every other process —
                # and fsck — sees the segmented layout marker
                manifest = self._fresh_manifest()
                self._write_manifest(manifest)
            else:
                self._manifest = manifest
                self._manifest_sig = sig
            self._replay_locked()

    # -- replay / refresh ---------------------------------------------
    def _apply(self, doc):
        tid = int(doc["tid"])
        old = self._view.get(tid)
        if old is not None:
            self._state_tids[old["state"]].discard(tid)
        self._view[tid] = doc
        self._state_tids[doc["state"]].add(tid)
        self._applied_records += 1
        self._log.append(tid)  # lint: disable=RL301  caller holds _lock

    def _segment_ranges(self):
        """(name, limit) pairs in replay order: sealed segments pinned
        to their manifest byte length, then the unbounded active."""
        out = []
        for entry in self._manifest.get("sealed", ()):
            out.append((entry["name"], int(entry["bytes"])))
        out.append((self._manifest["active"], None))
        return out

    def _replay_locked(self, full=False):
        """Replay unseen segment bytes into the view.  Returns the list
        of docs applied (the delta).  ``full`` resets the cursor and
        view first (initial load, post-compaction epoch change)."""
        _, object_hook = _codec()
        if full:
            self._view = {}
            self._state_tids = {s: set() for s in JOB_STATES}
            self._offsets = {}
            self._applied_records = 0
            self._log = []  # lint: disable=RL301  caller holds _lock
            self._log_gen += 1
        delta = []
        n_torn = 0
        for name, limit in self._segment_ranges():
            path = self.segment_path(name)
            applied = self._offsets.get(name, 0)
            if limit is None:
                try:
                    limit = os.path.getsize(path)
                except FileNotFoundError:
                    continue
            if limit <= applied:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(applied)
                    chunk = f.read(limit - applied)
            except FileNotFoundError:
                continue
            sealed = name != self._manifest["active"]
            records, consumed, torn, pending = parse_segment_chunk(
                chunk, object_hook=object_hook
            )
            if sealed:
                # nothing can be in flight in an immutable segment: a
                # pending (trailing-invalid) line is simply torn
                n_torn += torn + pending
                self._offsets[name] = limit
            else:
                n_torn += torn
                self._offsets[name] = applied + consumed
            for rec in records:
                self._apply(rec)
                delta.append(rec)
        stats = _stats()
        if stats is not None:
            if n_torn:
                stats.record_segment_torn(n_torn)
            stats.record_segment_replay(len(delta), full=full)
        return delta

    def refresh(self):
        """O(delta) tail replay: stat the manifest, reload it if it
        moved (seal/compaction), read only unseen segment bytes.
        Returns the delta docs (copies) in replay order."""
        with self._lock:
            delta = self._refresh_locked()
            return [copy.deepcopy(d) for d in delta]

    def _refresh_locked(self):
        manifest, sig = self._read_manifest()
        if manifest is not None and sig != self._manifest_sig:
            epoch_changed = manifest.get("epoch") != self._manifest.get(
                "epoch"
            )
            self._manifest = manifest
            self._manifest_sig = sig
            if epoch_changed:
                # a compaction rewrote history: replay the new lineage
                # from scratch (the folded base carries the same view)
                return self._replay_locked(full=True)
        return self._replay_locked()

    # -- reads (view) --------------------------------------------------
    def get(self, tid):
        with self._lock:
            self._refresh_locked()
            doc = self._view.get(int(tid))
            return copy.deepcopy(doc) if doc is not None else None

    def all_docs(self):
        """Every live doc, tid-ascending — from the view, ZERO directory
        scans (the whole point)."""
        with self._lock:
            self._refresh_locked()
            return [
                copy.deepcopy(self._view[tid])
                for tid in sorted(self._view)
            ]

    def count_states(self):
        with self._lock:
            self._refresh_locked()
            return {s: len(self._state_tids[s]) for s in JOB_STATES}

    def tids_in_state(self, state):
        with self._lock:
            self._refresh_locked()
            return sorted(self._state_tids.get(state, ()))

    def docs_since(self, cursor):
        """(new_cursor, delta_docs) for a consumer holding its own
        cursor — docs whose latest apply happened after ``cursor``, in
        apply order, deduped to the newest version per tid.

        The shared view advances whenever ANY reader refreshes
        (``count_states`` in a poll loop, ``get`` on the serve path), so
        a consumer that wants "everything since I last looked" cannot
        use :meth:`refresh`'s delta — it would miss docs a sibling
        reader already folded in.  Cursors are opaque; pass ``None`` to
        start from the beginning (full initial sync).  A full replay
        (compaction epoch change, :meth:`delete_all`) invalidates old
        cursors: they restart from zero, which is idempotent for
        latest-wins consumers."""
        with self._lock:
            self._refresh_locked()
            idx = 0
            if cursor is not None:
                gen, pos = cursor
                if gen == self._log_gen and pos <= len(self._log):
                    idx = pos
            seen = set()
            tids = []
            for tid in reversed(self._log[idx:]):
                if tid not in seen:
                    seen.add(tid)
                    tids.append(tid)
            tids.reverse()
            delta = [
                copy.deepcopy(self._view[tid])
                for tid in tids
                if tid in self._view
            ]
            return (self._log_gen, len(self._log)), delta

    def __len__(self):
        with self._lock:
            return len(self._view)

    # -- appends -------------------------------------------------------
    def append(self, doc):
        self.append_many([doc])

    def append_many(self, docs):  # protocol: cursor-advance
        """Group-commit a batch of trial-state transitions: ONE
        ``O_APPEND`` write + ONE fsync covers every doc in ``docs``
        (the ≥10x fsyncs-per-transition win over per-doc at batch
        sizes the service's fused suggest already produces)."""
        if not docs:
            return
        default, _ = _codec()
        with self._lock:
            self._refresh_locked()
            active = self._manifest["active"]
            path = self.segment_path(active)
            nbytes, end = journal_io.append_records(
                path, docs, default=default, fsync_kind="segment",
                with_offset=True,
            )
            stats = _stats()
            if stats is not None:
                stats.record_segment_append(len(docs), nbytes)
            chaos = _active_chaos()
            if chaos is not None:
                chaos.maybe_torn_segment(path, docs[0].get("tid", 0))
            # post-write manifest re-check: a concurrent seal or
            # compaction may have cut the segment under us — if our
            # bytes fell outside the surviving range, re-home them
            manifest, sig = self._read_manifest()
            if manifest is not None and sig != self._manifest_sig:
                if not self._write_survives(manifest, active, end):
                    self._manifest = manifest
                    self._manifest_sig = sig
                    journal_io.append_records(
                        self.segment_path(manifest["active"]), docs,
                        default=default, fsync_kind="segment",
                        with_offset=True,
                    )
                    logger.info(
                        "segment store %s: re-homed %d record(s) cut by "
                        "a concurrent seal/compaction", self.dir,
                        len(docs),
                    )
            for doc in docs:
                self._apply(copy.deepcopy(doc))
            # our own appended bytes are already in the view: advance
            # the cursor so the next refresh does not replay them — but
            # ONLY when our write is contiguous with it.  Under
            # O_APPEND another process's records may have landed in
            # [cursor, end - nbytes) between our refresh above and our
            # write; jumping the cursor to `end` would skip those bytes
            # forever.  Leaving the cursor put lets the next refresh
            # replay the gap; re-replaying our own records is harmless
            # (latest-wins per tid).
            if self._offsets.get(active, 0) == end - nbytes:
                self._offsets[active] = end
            self._maybe_seal_locked()
            if self.auto_compact and self._compaction_due_locked():
                self._compact_locked()

    @staticmethod
    def _write_survives(manifest, segment, end_offset):
        """Under ``manifest``, do bytes ``[..end_offset)`` of
        ``segment`` still get replayed?"""
        if manifest.get("active") == segment:
            return True
        for entry in manifest.get("sealed", ()):
            if entry["name"] == segment:
                return int(entry["bytes"]) >= end_offset
        return False

    # -- sealing -------------------------------------------------------
    def _seal_lock_acquire(self, timeout=10.0):  # protocol: lock-break
        """Cross-process seal/compaction mutex: O_CREAT|O_EXCL lock
        file, stale-broken after 30s (a SIGKILL'd sealer must not wedge
        the store forever)."""
        lock = os.path.join(self.dir, ".seal.lock")
        deadline = time.monotonic() + timeout
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                return lock
            except FileExistsError:
                try:
                    if time.time() - os.path.getmtime(lock) > 30.0:
                        # break the stale lock by renaming it to a
                        # private name first: only ONE breaker wins the
                        # rename, so two processes that both judged the
                        # lock stale cannot end up holding the mutex
                        # concurrently (unlinking the shared path
                        # directly could remove a fresh lock another
                        # breaker just re-created)
                        stale = "%s.stale-%d-%d" % (
                            lock, os.getpid(), time.monotonic_ns()
                        )
                        os.rename(lock, stale)  # durability: exempt(lock break: the lock file carries no data; the rename IS the mutual exclusion)
                        os.unlink(stale)
                        continue
                except OSError:
                    continue
                if time.monotonic() > deadline:
                    return None
                time.sleep(0.01)

    def _maybe_seal_locked(self):
        active = self._manifest["active"]
        try:
            size = os.path.getsize(self.segment_path(active))
        except FileNotFoundError:
            return
        if size < self.segment_max_bytes:
            return
        self._seal_active_locked()

    def seal_active(self):
        """Force-seal the active segment (replication cut points and
        graceful handoff ship ONLY sealed segments).  No-op when the
        active segment holds no records."""
        with self._lock:
            self._refresh_locked()
            self._seal_active_locked()

    def _seal_active_locked(self):
        lock = self._seal_lock_acquire()
        if lock is None:
            return  # another process is sealing; it will land
        try:
            # re-read under the seal lock: the seal may already be done
            manifest, sig = self._read_manifest()
            if manifest is not None:
                self._manifest = manifest
                self._manifest_sig = sig
            active = self._manifest["active"]
            path = self.segment_path(active)
            try:
                size = os.path.getsize(path)
            except FileNotFoundError:
                return
            if size == 0:
                return
            with open(path, "rb") as f:
                raw = f.read(size)
            _, object_hook = _codec()
            records, consumed, _torn, _pending = parse_segment_chunk(
                raw, object_hook=object_hook
            )
            if not records:
                return
            # the sealed range ends at the last valid record: a torn or
            # in-flight tail line stays outside the seal and is re-homed
            # by its writer's post-append manifest check
            sealed_bytes = consumed
            entry = {
                "name": active,
                "bytes": int(sealed_bytes),
                "records": len(records),
                "crc32": "%08x" % (zlib.crc32(raw[:sealed_bytes])
                                   & 0xFFFFFFFF),
            }
            manifest = dict(self._manifest)
            manifest["sealed"] = list(manifest.get("sealed", ())) + [entry]
            manifest["active"] = segment_name(manifest["next_seq"])
            manifest["next_seq"] = int(manifest["next_seq"]) + 1
            self._write_manifest(manifest)
            stats = _stats()
            if stats is not None:
                stats.record_segment_seal()
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    # -- compaction ----------------------------------------------------
    def _compaction_due_locked(self):
        live = max(len(self._view), 1)
        dead = self._applied_records - len(self._view)
        return (
            dead > self.compact_dead_factor * live
            and len(self._manifest.get("sealed", ())) > 0
        )

    def compact(self):
        """Fold the latest doc per tid into a fresh base segment, swap
        the manifest (epoch bump), re-home straggler records, retire the
        old segments.  Crash-safe at every step: the old manifest and
        segments survive until the new manifest is published; after
        that, the old files are at worst orphans fsck FS412 reclaims."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self):
        lock = self._seal_lock_acquire()
        if lock is None:
            return
        try:
            default, object_hook = _codec()
            # re-sync under the seal lock so the fold sees every record
            self._refresh_locked()
            old_manifest = self._manifest
            old_names = [n for n, _ in self._segment_ranges()]
            old_active = old_manifest["active"]
            old_active_consumed = self._offsets.get(old_active, 0)
            base_name = segment_name(old_manifest["next_seq"])
            docs = [self._view[tid] for tid in sorted(self._view)]
            blob = b"".join(
                journal_io.frame_record(d, default=default) for d in docs
            )
            from .file_trials import _atomic_write

            # the base segment is PUBLISHED atomically at its final
            # name; a crash before the manifest swap leaves it an
            # unreferenced orphan (FS412), never a half-truth
            _atomic_write(
                self.segment_path(base_name), blob, fsync_kind="segment"
            )
            manifest = {
                "version": 1,
                "epoch": int(old_manifest.get("epoch", 0)) + 1,
                "next_seq": int(old_manifest["next_seq"]) + 2,
                "active": segment_name(old_manifest["next_seq"] + 1),
                "sealed": [{
                    "name": base_name,
                    "bytes": len(blob),
                    "records": len(docs),
                    "crc32": "%08x" % (zlib.crc32(blob) & 0xFFFFFFFF),
                }],
            }
            self._write_manifest(manifest)
            chaos = _active_chaos()
            if chaos is not None:
                # the mid-compaction kill window: manifest swapped, old
                # segments not yet unlinked (FS412 orphans)
                chaos.maybe_compaction_kill(self.dir, manifest["epoch"])
            # re-home stragglers: records a concurrent appender landed
            # in the old active after our fold (their own post-append
            # check also covers this; latest-wins replay dedupes)
            try:
                with open(self.segment_path(old_active), "rb") as f:
                    f.seek(old_active_consumed)
                    tail = f.read()
            except FileNotFoundError:
                tail = b""
            if tail:
                stragglers, _, _, _ = parse_segment_chunk(
                    tail, object_hook=object_hook
                )
                if stragglers:
                    journal_io.append_records(
                        self.segment_path(manifest["active"]),
                        stragglers, default=default,
                        fsync_kind="segment", with_offset=True,
                    )
                    for rec in stragglers:
                        self._apply(rec)
            # retire the folded lineage
            for name in old_names:
                if name == base_name:
                    continue
                try:
                    os.unlink(self.segment_path(name))
                except FileNotFoundError:
                    pass
            # the view IS the folded base: reset the cursor to match
            self._offsets = {base_name: len(blob)}
            self._applied_records = len(docs)
            stats = _stats()
            if stats is not None:
                stats.record_segment_compaction(
                    n_retired=len(old_names) - (
                        1 if base_name in old_names else 0
                    )
                )
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    # -- maintenance ---------------------------------------------------
    def delete_all(self):
        """Wipe the log and view (``FileTrials.delete_all``)."""
        with self._lock:
            for p in glob.glob(os.path.join(self.dir, SEGMENT_GLOB)):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
            self._view = {}
            self._state_tids = {s: set() for s in JOB_STATES}
            self._offsets = {}
            self._applied_records = 0
            self._log = []
            self._log_gen += 1  # invalidate consumer cursors
            fresh = self._fresh_manifest()
            fresh["epoch"] = int(self._manifest.get("epoch", 0)) + 1
            self._write_manifest(fresh)

    def sealed_entries(self):
        """The manifest's sealed-segment entries (copies), replay-
        ordered — the replication unit list."""
        with self._lock:
            self._refresh_locked()
            return [dict(e) for e in self._manifest.get("sealed", ())]

    def epoch(self):
        with self._lock:
            return int(self._manifest.get("epoch", 0))

    def status(self):
        with self._lock:
            return {
                "epoch": int(self._manifest.get("epoch", 0)),
                "n_sealed": len(self._manifest.get("sealed", ())),
                "active": self._manifest.get("active"),
                "live_docs": len(self._view),
                "applied_records": self._applied_records,
            }


def migrate_queue_dir(root) -> int:
    """One-way migration: fold every legacy ``trials/*.json`` doc into
    a fresh segmented store at ``root`` and remove the doc files.
    Returns the number of docs migrated.  Crash-safe: docs are only
    unlinked after the segment append (one group commit) fsync'd; a
    crash mid-unlink re-migrates the survivors idempotently (latest-
    wins replay by tid)."""
    from .file_trials import _read_doc

    root = os.path.abspath(root)
    store = SegmentStore(root)
    paths = sorted(glob.glob(os.path.join(root, "trials", "*.json")))
    docs = []
    for p in paths:
        doc = _read_doc(p, quarantine=False)
        if doc is not None:
            docs.append(doc)
    if docs:
        store.append_many(docs)
    for p in paths:
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass
    return len(docs)
