"""FileTrials: durable filesystem work queue for multi-worker fmin.

Reference parity (SURVEY.md §2 #17): ``hyperopt/mongoexp.py`` —
``MongoJobs`` (jobs collection + **atomic ``reserve`` via
``find_one_and_update`` owner-stamping** ~L160-500), ``MongoTrials(Trials)``
(~L500-750), ``MongoCtrl`` (~L750-800); port of
``hyperopt_tpu/parallel/file_trials.py`` with the same on-disk layout, so
a queue directory written by either package opens in the other (only the
pickled ``FMinIter_Domain`` attachment is package-specific).

Hosts running a study share a filesystem (NFS, a local disk), not a
MongoDB deployment, so the durable queue is a directory:

    <queue>/trials/<tid>.json     one JSON doc per trial (atomic replace)
    <queue>/locks/<tid>.lock      reservation: O_CREAT|O_EXCL exclusive
                                  create IS the mutual-exclusion primitive
                                  (the find_one_and_update analog)
    <queue>/leases/<tid>.lease    renewable heartbeat lease (JSON: owner,
                                  expiry epoch, attempt) written at
                                  reservation and renewed by the worker;
                                  the driver-side reaper reclaims trials
                                  whose lease expired
    <queue>/attachments/<key>     blob store (GridFS analog) — including
                                  the pickled Domain under
                                  'FMinIter_Domain'
    <queue>/ids.counter           monotonic trial-id allocator (lock-file
                                  protected)
    <queue>/leases.mutex          flock(2) target serializing every lease
                                  write and unlink (port only: a renewal
                                  never undoes a reclaim)

Durability semantics match Mongo: re-run fmin with the same queue dir (and
exp_key) to resume; workers are stateless and restartable at any time.
Recovery goes beyond the reference: a reserved-but-dead worker's job kept
its lock forever there (``owner`` stays set); here its lease expires and
the :class:`hyperopt_tpu_torch.resilience.leases.LeaseReaper` re-queues the
trial automatically (the manual ``requeue_stale`` survives for scripted
cleanup).
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import glob
import json
import logging
import os
import pickle
import re
import socket
import sys
import threading
import time
import zlib
from collections.abc import MutableMapping

from .. import native as _native
from .. import tracing
from ..base import (
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATES,
    Ctrl,
    Trials,
)
from ..utils import coarse_utcnow

logger = logging.getLogger(__name__)

_DT_KEY = "$datetime"

# Reservation lease time-to-live.  A worker heartbeats at ttl/3; the
# driver-side reaper reclaims a RUNNING trial once its lease has been
# silent this long.  Must comfortably exceed worst-case heartbeat jitter
# (NFS attribute-cache latency + a descheduled worker thread).
DEFAULT_LEASE_TTL = 30.0


def _active_chaos():
    """The process-wide chaos monkey, at zero import cost when the chaos
    harness was never loaded (a sys.modules miss, not an import)."""
    mod = sys.modules.get("hyperopt_tpu_torch.resilience.chaos")
    return mod.get_active() if mod is not None else None


# Process-wide storage-plane telemetry (observability.StoreStats).  The
# optimization service installs one at startup; standalone fmin/worker
# runs leave it None and every record site is a single global read.
_store_stats = None


def set_store_stats(stats):
    """Install (or with None, remove) the process-wide StoreStats every
    queue operation in this module records into."""
    global _store_stats
    _store_stats = stats


def store_stats():
    """The installed process-wide StoreStats (None when uninstalled)."""
    return _store_stats


def _json_default(o):
    if isinstance(o, datetime.datetime):
        return {_DT_KEY: o.isoformat()}
    if isinstance(o, bytes):
        return {"$bytes": o.hex()}
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(o)


def _json_object_hook(d):
    if _DT_KEY in d and len(d) == 1:
        return datetime.datetime.fromisoformat(d[_DT_KEY])
    if "$bytes" in d and len(d) == 1:
        return bytes.fromhex(d["$bytes"])
    return d


def _atomic_write(path, data: bytes, fsync_kind="doc"):
    tmp = f"{path}.tmp.{os.getpid()}.{time.monotonic_ns()}"
    t0 = time.perf_counter()
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    stats = _store_stats
    if stats is not None:
        stats.record_fsync(
            time.perf_counter() - t0, kind=fsync_kind, nbytes=len(data)
        )
    os.replace(tmp, path)
    return len(data)


# Crash-consistency trailer on every trial doc: `\n#crc32:<crc>:<len>\n`
# appended after the JSON payload.  A torn disk write (power loss, a
# writer SIGKILL'd by the chaos harness mid-write) truncates or garbles
# the payload; the trailer lets `_read_doc` tell "torn" apart from
# "racing an atomic replace" and quarantine the file instead of crashing
# `all_docs`.  A JSON comment-style line after the payload is invisible
# to the native fast scanner (it greps for `"state":` textually) and to
# any legacy doc without one (the trailer is optional on read).
_DOC_TRAILER_RE = re.compile(rb"\n#crc32:([0-9a-f]{8}):(\d+)\n?$")


def _encode_doc(doc) -> bytes:
    payload = json.dumps(doc, default=_json_default, sort_keys=True).encode()
    return payload + b"\n#crc32:%08x:%d\n" % (
        zlib.crc32(payload) & 0xFFFFFFFF, len(payload)
    )


class DocCorrupt(ValueError):
    """A trial doc failed its CRC/length trailer or does not parse."""


def _decode_doc(raw: bytes):
    """Parse one doc blob, verifying the CRC trailer when present.
    Raises :class:`DocCorrupt` for torn/garbled payloads."""
    m = _DOC_TRAILER_RE.search(raw)
    if m is not None:
        length = int(m.group(2))
        payload = raw[:m.start()]
        if len(payload) != length or (
            zlib.crc32(payload) & 0xFFFFFFFF
        ) != int(m.group(1), 16):
            raise DocCorrupt("doc payload fails its length/CRC32 trailer")
    else:
        payload = raw  # legacy doc written before the trailer existed
    try:
        return json.loads(payload.decode(), object_hook=_json_object_hook)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise DocCorrupt(str(e))


def quarantine_path(path) -> str:
    """Destination a corrupt doc is renamed to (never re-globbed as a
    trial doc: the ``.corrupt`` suffix defeats both the ``*.json`` glob
    and the native scanner's name filter)."""
    dest = f"{path}.corrupt"
    if os.path.exists(dest):  # a second tear of the same tid
        dest = f"{path}.corrupt.{time.monotonic_ns()}"
    return dest


def attachment_filename(key) -> str:
    """THE attachment-key → filename sanitization.  Shared with
    resilience.fsck, which must read exactly the files the queue
    writes — a second copy of this mapping could silently diverge."""
    return str(key).replace("/", "_").replace(":", "_")


def _write_doc(path, doc, fsync_kind="doc"):
    return _atomic_write(path, _encode_doc(doc), fsync_kind=fsync_kind)


def _read_doc(path, quarantine=True):
    for _ in range(5):
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            time.sleep(0.01)  # racing an atomic replace; retry
            continue
        try:
            return _decode_doc(raw)
        except DocCorrupt:
            time.sleep(0.01)  # a re-write may be landing; re-read
    if quarantine and os.path.exists(path):
        # persistently corrupt: a torn write, not a race.  Move it aside
        # so all_docs/fsck stop tripping on it; the service journal (or
        # an operator) can restore the doc from its own record.
        dest = quarantine_path(path)
        try:
            os.replace(path, dest)
            logger.warning("quarantined corrupt doc %s -> %s", path, dest)
            stats = _store_stats
            if stats is not None:
                stats.record_quarantine()
        except OSError:
            logger.warning("could not quarantine corrupt doc %s", path)
    return None


def default_backend(root) -> str:
    """Which trial-store backend a queue directory carries.

    - a ``segments/MANIFEST.json`` marker → ``"segment"``;
    - legacy per-doc layout (``trials/*.json`` present, no manifest) →
      ``"doc"`` — old queues keep working untouched;
    - a fresh directory → the ``HYPEROPT_TPU_STORE_BACKEND`` env var if
      set, else ``"segment"`` (the default backend: the per-doc layout
      does one fsync'd atomic replace per transition and an O(N)
      directory scan per refresh; the segmented log group-commits and
      replays O(delta) tails — see ``parallel.segment_store``).
    """
    from . import segment_store

    root = os.path.abspath(root)
    if segment_store.SegmentStore.is_segmented(root):
        return "segment"
    if glob.glob(os.path.join(root, "trials", "*.json")):
        return "doc"
    return os.environ.get("HYPEROPT_TPU_STORE_BACKEND", "segment")


class FileJobs:
    """Low-level queue operations (the MongoJobs analog).

    Two interchangeable trial-doc backends behind one API:

    - ``"segment"`` (default for new queues): the append-only segment
      log of :mod:`hyperopt_tpu_torch.parallel.segment_store` — one
      CRC-framed ``O_APPEND`` group commit per write call, an in-memory
      materialized view served to ``all_docs``/``count_states``/
      ``reserve``, refresh = O(delta) tail replay, ZERO O(N) directory
      scans;
    - ``"doc"`` (legacy, auto-detected): one ``trials/<tid>.json`` per
      trial, atomic replace per write, directory scans on read.

    Locks, leases, attachments, and the id counter are backend-
    independent — the reservation protocol is untouched.
    """

    def __init__(self, root, lease_ttl=DEFAULT_LEASE_TTL, backend=None):
        self.root = os.path.abspath(root)
        self.lease_ttl = float(lease_ttl)
        for sub in ("trials", "locks", "leases", "attachments"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        self.backend = backend or default_backend(self.root)
        if self.backend not in ("segment", "doc"):
            raise ValueError(f"unknown trial-store backend {self.backend!r}")
        self.segments = None
        if self.backend == "segment":
            from .segment_store import SegmentStore

            self.segments = SegmentStore(self.root)
        # Process-local gate in FRONT of the cross-process counter file
        # lock: threads of one process queue on a cheap mutex instead of
        # contending on the O_CREAT|O_EXCL spin loop (10 ms sleeps).
        self._counter_lock = threading.Lock()
        # High-water mark of ids this process allocated: a counter file
        # that reads BELOW it means the file regressed (NFS rollback,
        # manual truncation, a second queue mounted over the first) and
        # continuing would silently re-issue duplicate trial ids.
        self._last_id = -1  # guarded-by: _counter_lock

    # -- paths ---------------------------------------------------------
    def trial_path(self, tid):
        return os.path.join(self.root, "trials", f"{int(tid):012d}.json")

    def lock_path(self, tid):
        return os.path.join(self.root, "locks", f"{int(tid):012d}.lock")

    def lease_path(self, tid):
        return os.path.join(self.root, "leases", f"{int(tid):012d}.lease")

    def attachment_path(self, key):
        return os.path.join(
            self.root, "attachments", attachment_filename(key)
        )

    # -- id allocation --------------------------------------------------
    def new_trial_ids(self, n):
        counter = os.path.join(self.root, "ids.counter")
        lock = counter + ".lock"
        with self._counter_lock:
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.close(fd)
                    break
                except FileExistsError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"id-counter lock stuck: {lock}")
                    time.sleep(0.01)
            try:
                start = 0
                if os.path.exists(counter):
                    with open(counter) as f:
                        start = int(f.read().strip() or 0)
                if start < self._last_id + 1:
                    # a regressed counter would re-issue ids this process
                    # already handed out — refuse before corrupting docs
                    raise RuntimeError(
                        f"id counter {counter} regressed to {start} below "
                        f"already-allocated id {self._last_id} (rolled-back "
                        f"or truncated queue directory?)"
                    )
                # atomic replace, not truncate-then-write: a writer
                # SIGKILL'd between the truncate and the write would
                # leave an EMPTY counter, and the next reader would
                # restart ids at 0 — duplicate tids
                _atomic_write(
                    counter, str(start + n).encode(), fsync_kind="counter"
                )
                self._last_id = start + n - 1
                return list(range(start, start + n))
            finally:
                os.unlink(lock)

    def reset_id_counter(self):
        """Forget the allocation high-water mark (the queue was wiped —
        ``FileTrials.delete_all`` — so restarting ids from 0 is intended,
        not a regression)."""
        with self._counter_lock:
            self._last_id = -1

    # -- docs -----------------------------------------------------------
    def insert(self, doc):
        # tracing.span is a no-op singleton unless the calling thread
        # has a request trace bound (the optimization service's store
        # writes do; driver/worker writes normally don't)
        if self.segments is not None:
            with tracing.span("store.segment_append", tid=int(doc["tid"])):
                self.segments.append(doc)
            chaos = _active_chaos()
            if chaos is not None:
                chaos.maybe_torn_lock(self, doc["tid"])
            return
        with tracing.span("store.write_doc", tid=int(doc["tid"])):
            nbytes = _write_doc(self.trial_path(doc["tid"]), doc)
        stats = _store_stats
        if stats is not None:
            stats.record_doc_write(nbytes)
        chaos = _active_chaos()
        if chaos is not None:
            chaos.maybe_torn_lock(self, doc["tid"])
            chaos.maybe_torn_doc(self.trial_path(doc["tid"]), doc["tid"])

    def insert_many(self, docs):
        """Insert a batch — ONE group-committed segment append (one
        O_APPEND write + one fsync for the whole batch) on the
        segmented backend; a per-doc loop on the legacy one."""
        if not docs:
            return
        if self.segments is not None:
            with tracing.span("store.segment_append", n_docs=len(docs)):
                self.segments.append_many(docs)
            chaos = _active_chaos()
            if chaos is not None:
                chaos.maybe_torn_lock(self, docs[0]["tid"])
            return
        for doc in docs:
            self.insert(doc)

    def write(self, doc):
        if self.segments is not None:
            with tracing.span("store.segment_append", tid=int(doc["tid"])):
                self.segments.append(doc)
            return
        with tracing.span("store.write_doc", tid=int(doc["tid"])):
            nbytes = _write_doc(self.trial_path(doc["tid"]), doc)
        stats = _store_stats
        if stats is not None:
            stats.record_doc_write(nbytes)
        chaos = _active_chaos()
        if chaos is not None:
            chaos.maybe_torn_doc(self.trial_path(doc["tid"]), doc["tid"])

    def read_doc(self, tid):
        """One trial doc by id (None if absent/unreadable)."""
        if self.segments is not None:
            return self.segments.get(tid)
        return _read_doc(self.trial_path(tid))

    def all_docs(self):
        if self.segments is not None:
            # the materialized view: an O(delta) tail replay then an
            # in-memory read — ZERO directory scans on this path
            return self.segments.all_docs()
        docs = []
        paths = sorted(glob.glob(os.path.join(self.root, "trials", "*.json")))
        stats = _store_stats
        if stats is not None:
            # THE O(N) directory scan the segmented-store roadmap item
            # exists to kill — every one is on the record
            stats.record_scan(len(paths))
        for p in paths:
            doc = _read_doc(p)
            if doc is not None:
                docs.append(doc)
        return docs

    def locked_tids(self):
        """Trial ids with a reservation lock file present."""
        out = []
        for p in glob.glob(os.path.join(self.root, "locks", "*.lock")):
            stem = os.path.basename(p)[: -len(".lock")]
            try:
                out.append(int(stem))
            except ValueError:
                continue
        return sorted(out)

    def tmp_droppings(self):
        """`*.tmp.*` files a writer killed between ``open`` and
        ``os.replace`` in ``_atomic_write`` left behind, across every
        queue subdirectory.  Invisible to doc globs (the names end in
        pid/nanosecond digits, not ``.json``) but they accumulate
        forever without a GC."""
        out = []
        for sub in ("trials", "locks", "leases", "attachments", "segments"):
            out.extend(
                glob.glob(os.path.join(self.root, sub, "*.tmp.*"))
            )
        # the id counter's atomic-replace tmp lives at the queue root
        out.extend(glob.glob(os.path.join(self.root, "*.tmp.*")))
        return sorted(out)

    def gc_tmp_droppings(self, max_age_secs=None) -> int:
        """Delete tmp droppings older than ``max_age_secs`` (default:
        the lease TTL — younger ones may be a write in flight)."""
        max_age = (
            self.lease_ttl if max_age_secs is None else float(max_age_secs)
        )
        now = time.time()
        n = 0
        for p in self.tmp_droppings():
            try:
                if now - os.path.getmtime(p) <= max_age:
                    continue
                os.unlink(p)
                n += 1
            except OSError:
                continue  # vanished under us, or unreadable mtime
        return n

    # -- leases ----------------------------------------------------------
    # Reservations are renewable heartbeat leases: ``reserve`` grants one,
    # the worker renews it (hyperopt_tpu_torch.resilience.leases.LeaseHeartbeat)
    # while the objective runs, and the driver-side LeaseReaper reclaims
    # RUNNING trials whose lease went silent past the TTL.  The lease file
    # is advisory state *about* the lock, never the mutual-exclusion
    # primitive itself — the O_CREAT|O_EXCL lock file keeps that role.
    #
    # Every write or unlink of a lease file runs under ``_lease_mutex``, so
    # a renewal's read→check→write is a compare-and-swap: a reaper's clear
    # (or a re-reservation's grant) that lands between the renewal's read
    # and its write cannot be undone by that write.
    @contextlib.contextmanager
    def _lease_mutex(self):
        """flock(2) on ``<queue>/leases.mutex``: one holder at a time
        across the queue's threads and processes."""
        fd = os.open(os.path.join(self.root, "leases.mutex"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # releases the flock

    def grant_lease(self, tid, owner, ttl=None, attempt=1):
        ttl = self.lease_ttl if ttl is None else float(ttl)
        with self._lease_mutex():
            now = time.time()
            _write_doc(
                self.lease_path(tid),
                {
                    "owner": owner,
                    "granted_at": now,
                    "expires_at": now + ttl,
                    "attempt": int(attempt),
                },
                fsync_kind="lease",
            )
        stats = _store_stats
        if stats is not None:
            stats.record_lease("grant")

    def read_lease(self, tid):
        """The lease doc for ``tid`` (None if absent or torn)."""
        try:
            with open(self.lease_path(tid), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        try:
            return _decode_doc(raw)
        except DocCorrupt:
            return None  # torn write: the reaper treats it as expired

    def renew_lease(self, tid, owner, ttl=None):
        """Extend ``tid``'s lease iff ``owner`` still holds it; False
        means the lease was reclaimed (or never granted) and the caller
        must drop its in-flight result.  The check and the write hold the
        lease mutex, so a lease cleared or re-granted after the check is
        never written back."""
        ttl = self.lease_ttl if ttl is None else float(ttl)
        with self._lease_mutex():
            lease = self.read_lease(tid)
            if lease is None or lease.get("owner") != owner:
                return False
            lease["expires_at"] = time.time() + ttl
            _write_doc(self.lease_path(tid), lease, fsync_kind="lease")
        stats = _store_stats
        if stats is not None:
            stats.record_lease("renew")
        return True

    def lease_owner(self, tid):
        lease = self.read_lease(tid)
        return lease.get("owner") if lease is not None else None

    def clear_lease(self, tid):
        try:
            with self._lease_mutex():
                os.unlink(self.lease_path(tid))
        except FileNotFoundError:
            return
        stats = _store_stats
        if stats is not None:
            stats.record_lease("clear")

    # -- fast queue scan (native C++ with Python fallback) ---------------
    def count_states(self):
        """{state: count} over all docs — the poll-loop primitive.

        Uses the native scanner (``native/fastqueue.cpp``) when built; a
        parse mismatch or missing toolchain falls back to exact parsing.
        On the segmented backend the materialized view answers in O(1)
        after an O(delta) tail refresh — no directory scan at all.
        """
        if self.segments is not None:
            counts = self.segments.count_states()
            return {s: counts.get(s, 0) for s in JOB_STATES}
        res = _native.count_states(os.path.join(self.root, "trials"))
        if res is not None:
            counts, _ = res
            stats = _store_stats
            if stats is not None:
                # the native scan still reads every directory entry —
                # it is FASTER, not O(1); the scan counter says so
                # (the native scan's counts are a list, one per state)
                stats.record_scan(sum(counts))
            return {s: counts[s] for s in JOB_STATES}
        counts = {s: 0 for s in JOB_STATES}
        for doc in self.all_docs():
            counts[doc["state"]] = counts.get(doc["state"], 0) + 1
        return counts

    def _new_tids(self):
        if self.segments is not None:
            return self.segments.tids_in_state(JOB_STATE_NEW)
        tids = _native.list_state(
            os.path.join(self.root, "trials"), JOB_STATE_NEW
        )
        if tids is not None:
            stats = _store_stats
            if stats is not None:
                stats.record_scan(len(tids))
            return tids
        return [
            doc["tid"] for doc in self.all_docs() if doc["state"] == JOB_STATE_NEW
        ]

    def running_tids(self):
        """Trial ids currently in JOB_STATE_RUNNING — the lease reaper's
        scan primitive (native fast path; the reaper polls every few
        seconds and must not re-parse the whole queue each time)."""
        if self.segments is not None:
            return self.segments.tids_in_state(JOB_STATE_RUNNING)
        tids = _native.list_state(
            os.path.join(self.root, "trials"), JOB_STATE_RUNNING
        )
        if tids is not None:
            stats = _store_stats
            if stats is not None:
                stats.record_scan(len(tids))
            return tids
        return [
            doc["tid"]
            for doc in self.all_docs()
            if doc["state"] == JOB_STATE_RUNNING
        ]

    @staticmethod
    def _unlock_if_owner(lock, owner):
        """Atomic rename-then-verify unlock.

        A read-then-unlink unlock has a TOCTOU hole: between our owner
        check and our unlink, ``requeue_stale`` can unlink the lock and
        another worker recreate it — our unlink then destroys THEIR
        reservation.  Instead the lock is renamed aside to a unique name
        first (rename(2) is atomic: exactly one process possesses the
        inode afterwards), the owner is verified on the private copy, and
        a lock that turns out not to be ours is restored with link(2)
        (create-iff-absent, so a newer lock at the path is never
        clobbered)."""
        # read-only gate first: a lock that is visibly not ours is never
        # touched (same as the pre-fix behavior — no displacement risk)
        try:
            with open(lock) as f:
                if f.read() != owner:
                    return False
        except FileNotFoundError:
            return False
        # it read as ours: take atomic possession, then RE-verify — this
        # closes the read→unlink window (requeue_stale can unlink our
        # lock and another worker recreate it in between; a plain unlink
        # here would destroy THEIR reservation)
        tmp = f"{lock}.unlock.{os.getpid()}.{time.monotonic_ns()}"
        try:
            os.rename(lock, tmp)
        except FileNotFoundError:
            return False
        with open(tmp) as f:
            mine = f.read() == owner
        if mine:
            os.unlink(tmp)
            return True
        # double race: the lock changed hands between read and rename —
        # restore it with link(2) (create-iff-absent never clobbers a
        # third party's even-newer lock; in that triple-race case their
        # claim stands and the displaced one is dropped with a warning)
        try:
            os.link(tmp, lock)
        except FileExistsError:
            logger.warning(
                "unlock race on %s: displaced a non-owner lock that could "
                "not be restored (a newer lock exists)", lock,
            )
        os.unlink(tmp)
        return False

    def _try_lock(self, lock, owner):
        r = _native.try_lock(lock, owner)
        if r is not None:
            return bool(r)
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            f.write(owner)
        return True

    # -- reservation -----------------------------------------------------
    def reserve(self, owner):
        """Atomically claim one JOB_STATE_NEW trial; None if none available.

        Exclusive lock-file creation is the only synchronization primitive,
        exactly as Mongo's atomic owner-stamping is the reference's.  The
        candidate scan and the lock syscall go through the native fast
        path when available; the doc rewrite stays in Python (the lock
        holder owns the doc).
        """
        for tid in self._new_tids():
            if not self._try_lock(self.lock_path(tid), owner):
                continue  # someone else owns it
            doc = self.read_doc(tid)  # re-read under the lock
            if doc is None or doc["state"] != JOB_STATE_NEW:
                # Lost a race (e.g. grabbed the lock inside requeue_stale's
                # unlink->rewrite window while the doc still reads RUNNING).
                # Release the lock we just created, or the trial would sit
                # NEW-but-locked forever once the rewrite lands — but only
                # if the lock file still carries OUR owner string: requeue
                # may already have unlinked it and another worker recreated
                # it, and deleting theirs would re-open the double-claim.
                self._unlock_if_owner(self.lock_path(tid), owner)
                continue
            # lease before doc rewrite: the lease must cover the window in
            # which the doc still reads NEW, or a crash here would strand
            # a locked trial with nothing for the reaper to expire
            attempt = int(doc.get("misc", {}).get("attempts", 0)) + 1
            self.grant_lease(tid, owner, attempt=attempt)
            doc["state"] = JOB_STATE_RUNNING
            doc["owner"] = owner
            doc.setdefault("misc", {})["attempts"] = attempt
            doc["book_time"] = coarse_utcnow()
            doc["refresh_time"] = coarse_utcnow()
            self.write(doc)
            return doc
        return None

    def requeue_stale(self, max_age_secs):
        """Re-queue RUNNING trials whose reservation is older than
        ``max_age_secs`` (recovery beyond the reference's capability —
        Mongo leaves dead workers' jobs reserved forever).  Also GCs the
        ``*.tmp.*`` droppings a writer killed mid-``_atomic_write``
        leaves behind — scripted cleanup must not strand them."""
        n = 0
        now = coarse_utcnow()
        for doc in self.all_docs():
            if doc["state"] != JOB_STATE_RUNNING:
                continue
            booked = doc.get("book_time")
            if booked is None or (now - booked).total_seconds() > max_age_secs:
                self.clear_lease(doc["tid"])
                try:
                    os.unlink(self.lock_path(doc["tid"]))
                except FileNotFoundError:
                    pass
                doc["state"] = JOB_STATE_NEW
                doc["owner"] = None
                doc["book_time"] = None
                self.write(doc)
                n += 1
        self.gc_tmp_droppings(max_age_secs)
        return n

    # -- attachments -----------------------------------------------------
    def set_attachment(self, key, value: bytes):
        _atomic_write(
            self.attachment_path(key), value, fsync_kind="attachment"
        )
        stats = _store_stats
        if stats is not None:
            stats.record_attachment_write(len(value))

    def get_attachment(self, key) -> bytes:
        with open(self.attachment_path(key), "rb") as f:
            return f.read()

    def has_attachment(self, key):
        return os.path.exists(self.attachment_path(key))

    def del_attachment(self, key):
        os.unlink(self.attachment_path(key))

    def attachment_keys(self):
        d = os.path.join(self.root, "attachments")
        return sorted(os.listdir(d))


class _FileAttachments(MutableMapping):
    def __init__(self, jobs: FileJobs):
        self._jobs = jobs

    def __getitem__(self, key):
        try:
            return self._jobs.get_attachment(key)
        except FileNotFoundError:
            raise KeyError(key)

    def __setitem__(self, key, value):
        if not isinstance(value, bytes):
            value = pickle.dumps(value)
        self._jobs.set_attachment(key, value)

    def __delitem__(self, key):
        try:
            self._jobs.del_attachment(key)
        except FileNotFoundError:
            raise KeyError(key)

    def __iter__(self):
        return iter(self._jobs.attachment_keys())

    def __len__(self):
        return len(self._jobs.attachment_keys())


class FileTrials(Trials):
    """Durable multi-process Trials store over a shared directory."""

    asynchronous = True
    poll_interval_secs = 0.25

    def __init__(self, queue_dir, exp_key=None, refresh=True,
                 lease_ttl=DEFAULT_LEASE_TTL, backend=None):
        self.jobs = FileJobs(queue_dir, lease_ttl=lease_ttl, backend=backend)
        self._seg_cursor = None  # SegmentStore.docs_since consumer cursor
        self._tid_pos = None     # tid -> index into _dynamic_trials
        super().__init__(exp_key=exp_key, refresh=False)
        self.attachments = _FileAttachments(self.jobs)
        if refresh:
            self.refresh()

    def refresh(self):
        stats = _store_stats
        if stats is not None:
            stats.record_refresh(local=False)
        segs = self.jobs.segments
        if segs is None:
            self._dynamic_trials = self.jobs.all_docs()
        else:
            # O(delta) refresh: only docs appended (anywhere — this
            # process or another) since our cursor, NOT an O(N) rebuild
            self._seg_cursor, delta = segs.docs_since(self._seg_cursor)
            if self._tid_pos is None:
                self._tid_pos = {
                    d["tid"]: i for i, d in enumerate(self._dynamic_trials)
                }
            for doc in delta:
                self._apply_dynamic_doc(doc)
        super().refresh()

    def _apply_dynamic_doc(self, doc):
        """Fold one delta doc into ``_dynamic_trials`` latest-wins."""
        pos = self._tid_pos.get(doc["tid"])
        if pos is None:
            self._tid_pos[doc["tid"]] = len(self._dynamic_trials)
            self._dynamic_trials.append(doc)
        else:
            self._dynamic_trials[pos] = doc

    def refresh_local(self):
        """Recompute the derived views (``_trials``, the SoA history)
        from the IN-MEMORY docs without re-reading the queue directory.

        For a single-writer owner — the optimization service, which
        inserts and mutates every doc itself and write-throughs each
        change via ``jobs.write`` — the in-memory docs are authoritative
        and the O(N)-file disk scan of :meth:`refresh` per report would
        dominate the serving hot path.  Multi-writer users (fmin driver
        + out-of-process workers) must keep calling :meth:`refresh`,
        which is the only way to observe other processes' writes."""
        stats = _store_stats
        if stats is not None:
            stats.record_refresh(local=True)
        super().refresh()

    def _insert_trial_docs(self, docs):
        docs = list(docs)
        # ONE group-committed segment append for the whole batch (the
        # legacy backend falls back to a per-doc loop inside insert_many)
        self.jobs.insert_many(docs)
        if self._tid_pos is not None:
            for doc in docs:
                self._apply_dynamic_doc(doc)
        else:
            self._dynamic_trials.extend(docs)
        return [doc["tid"] for doc in docs]

    def new_trial_ids(self, n):
        ids = self.jobs.new_trial_ids(n)
        self._ids.update(ids)
        return ids

    def delete_all(self):
        if self.jobs.segments is not None:
            self.jobs.segments.delete_all()
        self._seg_cursor = None
        self._tid_pos = None
        for p in glob.glob(os.path.join(self.jobs.root, "trials", "*.json")):
            os.unlink(p)
        for p in glob.glob(
            os.path.join(self.jobs.root, "trials", "*.corrupt*")
        ):
            os.unlink(p)
        for p in self.jobs.tmp_droppings():
            os.unlink(p)
        for p in glob.glob(os.path.join(self.jobs.root, "locks", "*.lock")):
            os.unlink(p)
        for p in glob.glob(os.path.join(self.jobs.root, "leases", "*.lease")):
            os.unlink(p)
        for k in list(self.attachments):
            del self.attachments[k]
        counter = os.path.join(self.jobs.root, "ids.counter")
        if os.path.exists(counter):
            os.unlink(counter)
        self.jobs.reset_id_counter()
        self._dynamic_trials = []
        from ..base import _TrialsHistory

        self._history = _TrialsHistory()
        self.refresh()

    def count_by_state_unsynced(self, arg):
        if self._exp_key is None:
            # poll fast path: native state counting, no doc materialization
            counts = self.jobs.count_states()
            if arg in JOB_STATES:
                return counts.get(arg, 0)
            if hasattr(arg, "__iter__"):
                return sum(counts.get(s, 0) for s in arg)
        self.refresh()
        return super().count_by_state_unsynced(arg)


class FileCtrl(Ctrl):
    """Ctrl whose checkpoint persists partial results to the queue
    (the MongoCtrl analog)."""

    def __init__(self, trials: FileTrials, current_trial):
        super().__init__(trials, current_trial)

    def checkpoint(self, result=None):
        if result is not None:
            self.current_trial["result"] = result
        self.current_trial["refresh_time"] = coarse_utcnow()
        self.trials.jobs.write(self.current_trial)


def default_owner():
    return f"{socket.gethostname()}:{os.getpid()}"
