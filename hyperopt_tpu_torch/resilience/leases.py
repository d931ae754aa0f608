"""Heartbeat leases and the driver-side reaper for the FileTrials queue.

Reference parity: ``hyperopt_tpu/resilience/leases.py``.

The reference's known flaw (SURVEY.md §5): a dead worker's job keeps its
``owner`` stamp forever — Mongo there, the reservation lock file here.
The seed port shipped a manual ``requeue_stale`` that nothing invoked.
This module replaces it with an automatic protocol:

- **Lease grant** — ``FileJobs.reserve`` writes
  ``<queue>/leases/<tid>.lease`` (JSON: owner, expiry epoch, attempt)
  atomically next to the lock file, and stamps the trial doc's
  ``misc["attempts"]`` execution counter.
- **Heartbeat** — the worker renews the lease (:class:`LeaseHeartbeat`,
  a daemon thread at ``ttl/3`` cadence) while the objective runs and
  between poll iterations; a renewal that discovers the lease gone or
  re-owned flips ``lost`` and the worker drops its result instead of
  clobbering the reclaimed trial.
- **Reap** — the driver runs a :class:`LeaseReaper` thread for the
  duration of ``FMinIter.run``: RUNNING trials whose lease expired are
  reclaimed (lock + lease removed, doc back to ``JOB_STATE_NEW``) until
  ``misc["attempts"]`` reaches the policy's ``max_attempts``, at which
  point the trial is quarantined in ``JOB_STATE_ERROR`` — excluded from
  the TPE fit, never blocking run completion.  Torn or orphaned lock
  files (a worker that died between lock creation and doc rewrite, or a
  chaos-injected garbage lock) older than the TTL are cleared so they
  cannot strand a NEW trial.

Deliberately conservative about races with *live* workers: reclamation
re-reads the doc immediately before rewriting it and aborts if the state
moved off RUNNING, and the worker side re-verifies lease ownership
before its final result write — between them, a slow-but-alive worker
either lands its result or has it dropped, never half of each.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ..base import (
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
)
from ..utils import coarse_utcnow
from .retry import RetryPolicy

logger = logging.getLogger(__name__)


class LeaseHeartbeat:
    """Daemon thread renewing one reservation's lease until stopped.

    ``lost`` flips permanently when a renewal finds the lease missing or
    owned by someone else (the reaper reclaimed it): the worker must then
    discard its in-flight result."""

    def __init__(self, jobs, tid, owner, ttl=None, interval=None, stats=None):
        self.jobs = jobs
        self.tid = int(tid)
        self.owner = owner
        self.ttl = float(ttl if ttl is not None else jobs.lease_ttl)
        self.interval = float(
            interval if interval is not None else max(self.ttl / 3.0, 0.01)
        )
        self.stats = stats
        self._stop = threading.Event()
        self._lost = threading.Event()
        self._thread = None

    @property
    def lost(self) -> bool:
        return self._lost.is_set()

    def renew_now(self) -> bool:
        """One synchronous renewal; False (and ``lost``) if the lease is
        no longer ours."""
        ok = self.jobs.renew_lease(self.tid, self.owner, ttl=self.ttl)
        if ok:
            if self.stats is not None:
                self.stats.record("heartbeat")
        else:
            self._lost.set()
        return ok

    def _run(self):
        while not self._stop.wait(self.interval):
            if not self.renew_now():
                return

    def start(self):
        self._thread = threading.Thread(
            target=self._run,
            name=f"hyperopt-lease-heartbeat-{self.tid}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class LeaseReaper:
    """Driver-side reclamation of expired leases (+ stale-lock GC).

    Owned by ``FMinIter`` for async FileTrials runs (started/stopped
    around ``run``); also usable standalone — ``reap_once`` is the whole
    protocol, the thread just repeats it every ``interval`` seconds.
    """

    # lock-order: _state_lock
    def __init__(self, trials, policy: RetryPolicy | None = None,
                 stats=None, interval: float | None = None):
        self.jobs = trials.jobs
        self.policy = policy if policy is not None else RetryPolicy()
        self.stats = stats
        self.interval = float(
            interval
            if interval is not None
            else self.policy.effective_reap_interval
        )
        self._stop = threading.Event()
        self._thread = None
        self._state_lock = threading.Lock()
        self._n_reclaimed = 0  # guarded-by: _state_lock
        self._n_quarantined = 0  # guarded-by: _state_lock
        self._n_stale_locks = 0  # guarded-by: _state_lock

    # -- counters ------------------------------------------------------
    @property
    def n_reclaimed(self):
        with self._state_lock:
            return self._n_reclaimed

    @property
    def n_quarantined(self):
        with self._state_lock:
            return self._n_quarantined

    @property
    def n_stale_locks(self):
        with self._state_lock:
            return self._n_stale_locks

    def _record(self, event):
        if self.stats is not None:
            self.stats.record(event)

    @staticmethod
    def _record_store_lease(event):
        """Mirror a reap-protocol event into the process-wide storage
        telemetry (observability.StoreStats) when one is installed —
        the lease-churn axis of the SL6xx storage-plane evidence."""
        from ..parallel.file_trials import store_stats

        stats = store_stats()
        if stats is not None:
            stats.record_lease(event)

    # -- the protocol --------------------------------------------------
    def _lease_expired(self, tid, now) -> bool:
        lease = self.jobs.read_lease(tid)
        if lease is not None:
            try:
                return float(lease["expires_at"]) <= now
            except (KeyError, TypeError, ValueError):
                return True  # torn/garbage lease: treat as expired
        # no lease: the worker died between lock and lease write, or the
        # queue predates leases — fall back to the lock file's age
        try:
            age = now - os.path.getmtime(self.jobs.lock_path(tid))
        except OSError:
            return True  # RUNNING with neither lease nor lock: orphaned
        return age > self.jobs.lease_ttl

    def _reclaim(self, doc):
        tid = doc["tid"]
        attempts = int(doc.get("misc", {}).get("attempts", 1))
        self.jobs.clear_lease(tid)
        try:
            os.unlink(self.jobs.lock_path(tid))
        except FileNotFoundError:
            pass
        # the worker may have completed in the scan window — re-read and
        # leave a finished doc alone (its result is valid; re-running it
        # would only burn an attempt)
        fresh = self.jobs.read_doc(tid)
        if fresh is None or fresh["state"] != JOB_STATE_RUNNING:
            return
        doc = fresh
        if attempts >= self.policy.max_attempts:
            doc["state"] = JOB_STATE_ERROR
            doc.setdefault("misc", {})["error"] = (
                "LeaseExpired",
                f"worker lease expired on attempt {attempts}/"
                f"{self.policy.max_attempts}; trial quarantined",
            )
            self._record("lease_quarantined")
            self._record_store_lease("quarantine")
            with self._state_lock:
                self._n_quarantined += 1
            logger.warning(
                "trial %s quarantined after %d expired lease(s)",
                tid, attempts,
            )
        else:
            doc["state"] = JOB_STATE_NEW
            doc["owner"] = None
            doc["book_time"] = None
            self._record("lease_reclaimed")
            self._record_store_lease("reap")
            with self._state_lock:
                self._n_reclaimed += 1
            logger.info(
                "reclaimed expired lease for trial %s (attempt %d/%d)",
                tid, attempts, self.policy.max_attempts,
            )
        doc["refresh_time"] = coarse_utcnow()
        self.jobs.write(doc)

    def reap_once(self) -> int:
        """One full scan; returns the number of trials reclaimed or
        quarantined."""
        now = time.time()
        n = 0
        # native fast scan for RUNNING ids; docs are materialized only
        # for candidates whose lease actually expired
        running_tids = set(int(t) for t in self.jobs.running_tids())
        for tid in sorted(running_tids):
            if not self._lease_expired(tid, now):
                continue
            doc = self.jobs.read_doc(tid)
            if doc is None or doc["state"] != JOB_STATE_RUNNING:
                continue  # finished while we scanned
            self._record("lease_expired")
            self._reclaim(doc)
            n += 1
        # stale/torn lock GC: a lock file whose trial is NOT running
        # (crashed mid-reserve, chaos-torn, or plain orphaned) blocks
        # re-reservation forever if left in place
        for tid in self.jobs.locked_tids():
            if tid in running_tids:
                continue
            lock = self.jobs.lock_path(tid)
            try:
                age = now - os.path.getmtime(lock)
            except OSError:
                continue  # already gone
            if age <= self.jobs.lease_ttl:
                continue  # may be a reservation in flight
            try:
                os.unlink(lock)
            except FileNotFoundError:
                continue
            self.jobs.clear_lease(tid)
            self._record("stale_lock_cleared")
            with self._state_lock:
                self._n_stale_locks += 1
            logger.info("cleared stale lock for trial %s", tid)
        # tmp-dropping GC: `*.tmp.*` files from a writer killed between
        # open and os.replace in _atomic_write.  Age-gated by the lease
        # TTL so an in-flight write is never yanked out from under its
        # writer.
        n_tmp = self.jobs.gc_tmp_droppings()
        if n_tmp:
            if self.stats is not None:
                self.stats.record("tmp_dropping_cleared", n_tmp)
            logger.info("cleared %d torn tmp file(s)", n_tmp)
        return n

    # -- thread lifecycle ----------------------------------------------
    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.reap_once()
            except Exception:
                # the reaper must outlive transient queue errors (NFS
                # blips, concurrent delete_all) — log and keep scanning
                logger.exception("lease reaper scan failed; continuing")

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hyperopt-lease-reaper", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
