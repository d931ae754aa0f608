"""Worker daemon for the FileTrials queue.

Reference parity (SURVEY.md §2 #17): ``hyperopt/mongoexp.py`` —
``MongoWorker.run_one`` (reserve → temp workdir → unpickle domain from the
'FMinIter_Domain' attachment → ``domain.evaluate`` → write result,
error → ``JOB_STATE_ERROR``) (~L800-1050) and the
``hyperopt-mongo-worker`` CLI (``main_worker_helper``: ``--poll-interval``,
``--max-consecutive-failures``, ``--reserve-timeout``, ``--workdir``,
``--last-job-timeout``) (~L1050-1300); port of
``hyperopt_tpu/parallel/worker.py``.  A worker runs the objective on the
host and never touches the card: the unpickled ``Domain`` holds no
tensors, and the worker logs at exit whether anything in its process
initialised CUDA.

Fault tolerance beyond the reference (:mod:`hyperopt_tpu_torch.resilience`):

- every reservation is a renewable **heartbeat lease** — a
  :class:`~hyperopt_tpu_torch.resilience.leases.LeaseHeartbeat` daemon renews
  it at poll-interval cadence while the objective runs, so the
  driver-side reaper can tell a slow worker from a dead one;
- the final result write re-verifies lease ownership and **drops stale
  results** (the trial was reclaimed and re-queued while this worker
  evaluated — writing would clobber the retry);
- objective exceptions are retried **in place** with the run's
  :class:`~hyperopt_tpu_torch.resilience.retry.RetryPolicy` (read from the
  ``FMinIter_RetryPolicy`` queue attachment, overridable per worker),
  with exponential backoff, deterministic jitter, and a per-attempt
  watchdog timeout; a trial that exhausts ``max_attempts`` is
  quarantined in ``JOB_STATE_ERROR``;
- ``--last-job-timeout`` is enforced *inside* the reserve wait too (the
  deadline caps the poll loop, so a worker cannot overshoot it by a full
  ``--reserve-timeout``), and ``--max-consecutive-failures`` ends the
  daemon with a nonzero exit as documented.

Run one or more workers per host::

    python -m hyperopt_tpu_torch.parallel.worker --queue /shared/q --workdir /tmp/w

(or the ``hyperopt-tpu-torch-worker`` console script).  The objective's
module must be importable: give workers an absolute ``PYTHONPATH``, since
each trial runs inside its workdir.

Workers are stateless: kill and restart at any time; elasticity falls out
of the shared queue (SURVEY.md §5), and killed workers' trials are
re-queued automatically by the driver's lease reaper.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import sys
import time
from timeit import default_timer as timer

from ..base import JOB_STATE_DONE, JOB_STATE_ERROR, spec_from_misc
from ..observability import FaultStats
from ..utils import coarse_utcnow, temp_dir, working_dir
from .file_trials import (
    DEFAULT_LEASE_TTL,
    FileCtrl,
    FileTrials,
    _active_chaos,
    default_owner,
)

logger = logging.getLogger(__name__)

RETRY_POLICY_ATTACHMENT = "FMinIter_RetryPolicy"


class ReserveTimeout(Exception):
    """No job became available within --reserve-timeout."""


class FileWorker:
    poll_interval = 1.0

    def __init__(
        self,
        queue_dir,
        poll_interval=1.0,
        workdir=None,
        exp_key=None,
        logfilename=None,
        lease_ttl=None,
        retry_policy="attachment",
        stats=None,
    ):
        # lease_ttl None = defer to the driver's published retry policy
        # (FMinIter_RetryPolicy attachment), falling back to the queue
        # default; an explicit value (the --lease-ttl flag) always wins
        self._explicit_lease_ttl = lease_ttl is not None
        self.trials = FileTrials(
            queue_dir, exp_key=exp_key,
            lease_ttl=lease_ttl if lease_ttl is not None else DEFAULT_LEASE_TTL,
        )
        self.poll_interval = poll_interval
        self.workdir = workdir
        self.owner = default_owner()
        self.stats = stats if stats is not None else FaultStats()
        self._domain = None
        self._domain_blob = None
        # "attachment": read the driver's policy from the queue (re-read
        # each trial, parsed only when the blob changes — a long-lived
        # worker spanning several driver runs follows the CURRENT run's
        # policy); None: never retry in place (pre-resilience behavior);
        # a RetryPolicy: explicit per-worker override.
        self._retry_policy_arg = retry_policy
        self._retry_policy_cache = None
        self._retry_policy_blob = None

    def _load_domain(self):
        blob = self.trials.attachments["FMinIter_Domain"]
        if blob != self._domain_blob:
            self._domain = pickle.loads(blob)
            self._domain_blob = blob
        return self._domain

    def _retry_policy(self):
        if self._retry_policy_arg != "attachment":
            return self._retry_policy_arg
        try:
            blob = self.trials.attachments[RETRY_POLICY_ATTACHMENT]
        except KeyError:
            blob = None
        if blob != self._retry_policy_blob:
            self._retry_policy_blob = blob
            if blob is None:
                self._retry_policy_cache = None
            else:
                from ..resilience.retry import RetryPolicy

                try:
                    self._retry_policy_cache = RetryPolicy.from_json(blob)
                except Exception:
                    logger.exception(
                        "unreadable %s attachment; running without "
                        "in-place retries", RETRY_POLICY_ATTACHMENT,
                    )
                    self._retry_policy_cache = None
            if (
                self._retry_policy_cache is not None
                and not self._explicit_lease_ttl
            ):
                # adopt the driver's lease TTL so the heartbeat cadence,
                # the granted leases, and the reaper's clock all agree
                self.trials.jobs.lease_ttl = self._retry_policy_cache.lease_ttl
        return self._retry_policy_cache

    def _finish(self, job, heartbeat, owner):
        """Ownership-checked terminal write: land the doc and release the
        reservation, or drop a result whose lease was reclaimed while the
        objective ran (the trial is already re-queued — writing over it
        would clobber the retry).  Returns True iff the doc was written.

        Three stale signals are checked, narrowing the inherent TOCTOU
        window of a filesystem queue (no compare-and-swap) to the
        read→write gap: the heartbeat noticed the loss, the lease is no
        longer ours *or has already expired* (a stalled-but-alive worker
        whose heartbeat thread also stalled must not trust a lease the
        reaper is entitled to reclaim), or the doc itself was re-owned."""
        jobs = self.trials.jobs
        tid = job["tid"]
        lease = jobs.read_lease(tid)
        stale = (
            heartbeat.lost
            or lease is None
            or lease.get("owner") != owner
            or float(lease.get("expires_at", 0)) <= time.time()
        )
        if not stale:
            # the lease read can race the reaper: re-verify the doc is
            # still stamped with our ownership (a reclaim clears it, a
            # re-reservation re-stamps another worker's)
            current = jobs.read_doc(tid)
            stale = current is not None and current.get("owner") != owner
        if stale:
            self.stats.record("stale_result_dropped")
            logger.warning(
                "trial %s: lease reclaimed or expired while evaluating; "
                "dropping this worker's result", tid,
            )
            return False
        jobs.write(job)
        # stop the heartbeat BEFORE releasing: a renewal racing the
        # clear (read-lease before the unlink, write after it) would
        # re-create the lease file and strand it for the reaper
        heartbeat.stop()
        jobs.clear_lease(tid)
        jobs._unlock_if_owner(jobs.lock_path(tid), owner)
        return True

    def run_one(self, host_id=None, reserve_timeout=None,
                erase_created_workdir=False, deadline=None,
                stop_event=None):
        """Reserve and execute one trial; raises ReserveTimeout if none.

        ``deadline``: absolute ``timer()`` value past which the reserve
        wait gives up (the CLI's --last-job-timeout enforcement).
        ``stop_event``: a ``threading.Event`` that aborts the reserve
        wait when set (the CLI's graceful-shutdown path: a SIGTERM mid
        -poll must not strand the worker for a full --reserve-timeout).
        Once a trial IS reserved the event is ignored — the in-flight
        trial runs to completion and releases its lock+lease normally."""
        from ..resilience.leases import LeaseHeartbeat
        from ..resilience.retry import execute_with_retry

        start = timer()
        owner = host_id or self.owner
        job = None
        while job is None:
            if stop_event is not None and stop_event.is_set():
                raise ReserveTimeout("shutdown requested during reserve wait")
            job = self.trials.jobs.reserve(owner)
            if job is None:
                now = timer()
                if reserve_timeout is not None and now - start > reserve_timeout:
                    raise ReserveTimeout(
                        f"no job within {reserve_timeout}s at {self.trials.jobs.root}"
                    )
                if deadline is not None and now > deadline:
                    raise ReserveTimeout(
                        f"--last-job-timeout deadline reached at "
                        f"{self.trials.jobs.root}"
                    )
                time.sleep(self.poll_interval)

        tid = job["tid"]
        logger.info("worker %s reserved trial %s (attempt %s)",
                    owner, tid, job["misc"].get("attempts", 1))
        spec = spec_from_misc(job["misc"])
        ctrl = FileCtrl(self.trials, job)
        policy = self._retry_policy()
        chaos = _active_chaos()
        ttl = self.trials.jobs.lease_ttl
        heartbeat = LeaseHeartbeat(
            self.trials.jobs, tid, owner, ttl=ttl,
            interval=min(self.poll_interval, ttl / 3.0),
            stats=self.stats,
        ).start()
        try:
            # chaos kill points sit OUTSIDE the error-writing try below:
            # a killed worker must leave the doc RUNNING and the lock in
            # place, exactly like a SIGKILL'd process — recovery is the
            # reaper's job, not this (dead) worker's
            if chaos is not None:
                chaos.maybe_kill_worker(tid, "pre")

            try:
                domain = self._load_domain()
                workdir = self.workdir or os.path.join(
                    self.trials.jobs.root, "workdir", str(tid)
                )

                def _evaluate():
                    return domain.evaluate(spec, ctrl)

                # the workdir chdir wraps the WHOLE retry loop on this
                # thread, not the per-attempt watchdog thread: an
                # abandoned (timed-out) attempt must never chdir the
                # process out from under a live retry, and the temp-dir
                # cleanup must never delete the directory a later
                # attempt is executing in
                with temp_dir(workdir, erase_after=erase_created_workdir), \
                        working_dir(workdir):
                    if policy is None:
                        result = _evaluate()
                    else:
                        def _on_retry(attempt, err):
                            # checkpoint the attempt counter so a crash
                            # mid-backoff doesn't reset the budget, and
                            # keep the lease warm through the sleep
                            job["misc"]["attempts"] = attempt + 1
                            job["refresh_time"] = coarse_utcnow()
                            self.trials.jobs.write(job)
                            heartbeat.renew_now()

                        result, attempts = execute_with_retry(
                            _evaluate,
                            policy,
                            key=tid,
                            stats=self.stats,
                            first_attempt=int(job["misc"].get("attempts", 1)),
                            on_retry=_on_retry,
                        )
                        job["misc"]["attempts"] = attempts
            except Exception as e:
                logger.error("trial %s failed: %s", tid, e)
                job["state"] = JOB_STATE_ERROR
                job["misc"]["error"] = (str(type(e)), str(e))
                job["refresh_time"] = coarse_utcnow()
                self._finish(job, heartbeat, owner)
                raise
            if chaos is not None:
                chaos.maybe_kill_worker(tid, "post")
                if chaos.should_delay_result(tid):
                    # model a frozen worker process: the heartbeat
                    # stalls WITH the result write, so past the TTL the
                    # reaper reclaims the trial and _finish drops this
                    # (now stale) result
                    heartbeat.stop()
                    logger.info(
                        "chaos: stalling worker %.2fs before the result "
                        "write of trial %s",
                        chaos.config.delay_seconds, tid,
                    )
                    time.sleep(chaos.config.delay_seconds)
            job["result"] = result
            job["state"] = JOB_STATE_DONE
            job["refresh_time"] = coarse_utcnow()
            wrote = self._finish(job, heartbeat, owner)
            if wrote and chaos is not None and chaos.should_duplicate_result(tid):
                # at-least-once delivery: the doc write is idempotent
                self.trials.jobs.write(job)
            return job
        finally:
            heartbeat.stop()


def _install_graceful_shutdown():
    """SIGTERM/SIGINT → a threading.Event instead of abrupt death.

    The default dispositions strand state: SIGTERM kills the process
    mid-objective (the doc stays RUNNING and the lock+lease sit until
    the reaper expires them), SIGINT raises KeyboardInterrupt at an
    arbitrary bytecode.  With the handlers installed the worker finishes
    the in-flight trial (the terminal write releases lock+lease as
    usual), skips reserving another, and exits 0.  Returns the event,
    or None when handlers cannot be installed (not the main thread —
    in-process test workers keep their current behavior)."""
    import signal
    import threading

    stop_event = threading.Event()

    def _handler(signum, frame):
        if stop_event.is_set():
            # second signal: the operator means it (the in-flight
            # objective may be hung and nothing else would ever
            # interrupt it) — restore the default disposition and
            # re-deliver for the conventional hard exit; the reaper
            # reclaims the stranded lease
            logger.warning("second signal %d: exiting immediately", signum)
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        logger.info(
            "signal %d: finishing the in-flight trial, then exiting",
            signum,
        )
        stop_event.set()

    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    except ValueError:
        return None
    return stop_event


def main_worker_helper(options):
    if options.max_consecutive_failures <= 0:
        raise ValueError("--max-consecutive-failures must be positive")
    worker = FileWorker(
        options.queue,
        poll_interval=options.poll_interval,
        workdir=options.workdir,
        exp_key=options.exp_key,
        lease_ttl=options.lease_ttl,
    )
    stop_event = _install_graceful_shutdown()
    # the readiness line: the signal handlers are installed from here on
    logger.info("worker %s ready on %s", worker.owner, worker.trials.jobs.root)
    try:
        return _worker_loop(worker, options, stop_event)
    finally:
        import torch

        logger.info(
            "worker %s exiting; cuda initialized: %s",
            worker.owner, torch.cuda.is_initialized(),
        )


def _worker_loop(worker, options, stop_event):
    from ..resilience.chaos import WorkerKilled

    consecutive_failures = 0
    n_done = 0
    start = timer()
    # reference semantics: --last-job-timeout is an absolute deadline
    # (seconds since worker start) past which no new job is reserved —
    # enforced both here and inside run_one's reserve wait, so the
    # worker cannot overshoot it by a full --reserve-timeout
    deadline = (
        start + options.last_job_timeout
        if options.last_job_timeout is not None
        else None
    )
    while True:
        if stop_event is not None and stop_event.is_set():
            logger.info("shutdown requested, exiting cleanly after %d jobs",
                        n_done)
            break
        if deadline is not None and timer() > deadline:
            logger.info("--last-job-timeout reached, exiting")
            break
        try:
            worker.run_one(
                reserve_timeout=options.reserve_timeout, deadline=deadline,
                stop_event=stop_event,
            )
            consecutive_failures = 0
            n_done += 1
        except ReserveTimeout:
            logger.info("reserve timeout, exiting after %d jobs", n_done)
            break
        except WorkerKilled:
            logger.error("worker killed (chaos injection), exiting")
            return 1
        except Exception as e:
            consecutive_failures += 1
            logger.error(
                "job failure %d/%d: %s",
                consecutive_failures,
                options.max_consecutive_failures,
                e,
            )
            if consecutive_failures >= options.max_consecutive_failures:
                logger.error("too many consecutive failures, exiting")
                return 1
        if options.max_jobs is not None and n_done >= options.max_jobs:
            break
    return 0


def make_parser():
    p = argparse.ArgumentParser(
        prog="hyperopt-tpu-torch-worker",
        description="Execute trials from a FileTrials queue directory.",
    )
    p.add_argument("--queue", required=True, help="shared queue directory")
    p.add_argument("--exp-key", default=None, dest="exp_key")
    p.add_argument("--poll-interval", type=float, default=1.0, dest="poll_interval")
    p.add_argument(
        "--max-consecutive-failures",
        type=int,
        default=4,
        dest="max_consecutive_failures",
    )
    p.add_argument(
        "--reserve-timeout", type=float, default=120.0, dest="reserve_timeout"
    )
    p.add_argument("--workdir", default=None)
    p.add_argument(
        "--last-job-timeout", type=float, default=None, dest="last_job_timeout"
    )
    p.add_argument("--max-jobs", type=int, default=None, dest="max_jobs")
    p.add_argument(
        "--lease-ttl",
        type=float,
        default=None,
        dest="lease_ttl",
        help="heartbeat lease time-to-live in seconds; the driver reaper "
        "re-queues this worker's trial if the lease goes silent this long "
        f"(default: the driver's published retry policy, else "
        f"{DEFAULT_LEASE_TTL})",
    )
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    options = make_parser().parse_args(argv)
    return main_worker_helper(options)


if __name__ == "__main__":
    sys.exit(main())
