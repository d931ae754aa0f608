"""The port's fault-tolerance layer (``hyperopt_tpu_torch.resilience``):
the JAX package's ``tests/test_resilience.py`` run against the port —
retry policy, heartbeat leases and the reaper, in-place worker retries,
the worker CLI, the seeded chaos harness, and the crash-recovery gate
(workers killed mid-trial under a chaos seed finish the same trials as a
fault-free run), and its device-recovery cases — except its
service-plane, circuit-breaker and replica-lease cases, which wait for
their modules.  The reference's CPU-fallback case becomes the port's: the
budget's end raises and ``cpu_fallback`` stays 0.  Then the retry, chaos
and device-recovery schedules against the JAX package's at the same seed,
the CUDA error taxonomy (kernel launch and readback failures are device
errors), the pipelined run's recovery, and a worker process's graceful
shutdown, each signal sent only after the worker says it is ready.
"""

import glob
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch

from hyperopt_tpu.resilience import chaos as jchaos
from hyperopt_tpu.resilience import retry as jretry
from hyperopt_tpu_torch import Trials, fmin, hp
from hyperopt_tpu_torch.algos import rand
from hyperopt_tpu_torch.base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_OK,
    Domain,
)
from hyperopt_tpu_torch.observability import FaultStats
from hyperopt_tpu_torch.parallel.file_trials import FileJobs, FileTrials
from hyperopt_tpu_torch.parallel.worker import FileWorker, ReserveTimeout
from hyperopt_tpu_torch.resilience import (
    DeviceRecovery,
    LeaseReaper,
    RetryPolicy,
    SyntheticDeviceError,
    TrialQuarantined,
    TrialTimeout,
    backoff_delay,
    execute_with_retry,
    is_device_error,
    mark_device_error,
    run_with_timeout,
)
from hyperopt_tpu_torch.resilience.chaos import (
    ChaosConfig,
    ChaosMonkey,
    WorkerKilled,
    active,
)
from hyperopt_tpu_torch.resilience.leases import LeaseHeartbeat

CPU_RAND = partial(rand.suggest, device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPACE = {"x": hp.uniform("x", -5, 5)}


def _doc(tid):
    return {
        "tid": tid, "state": JOB_STATE_NEW, "spec": None,
        "result": {"status": "new"},
        "misc": {"tid": tid, "cmd": ("domain_attachment", "FMinIter_Domain"),
                 "idxs": {"x": [tid]}, "vals": {"x": [1.0]}},
        "exp_key": None, "owner": None, "version": 0,
        "book_time": None, "refresh_time": None,
    }


# Module-level objectives: FileTrials pickles the Domain by reference,
# so worker threads must be able to re-import these.
def quad_objective(cfg):
    return (cfg["x"] - 3.0) ** 2


def chaos_objective(cfg):
    from hyperopt_tpu_torch.resilience import chaos

    monkey = chaos.get_active()
    if monkey is not None:
        fault = monkey.objective_fault(chaos.stable_key(cfg))
        if fault is not None:
            return fault
    return (cfg["x"] - 3.0) ** 2


_FLAKY_STATE = {"fails_left": 0}


def flaky_objective(cfg):
    if _FLAKY_STATE["fails_left"] > 0:
        _FLAKY_STATE["fails_left"] -= 1
        raise RuntimeError("transient objective failure")
    return (cfg["x"] - 3.0) ** 2


class TestRetryPolicy:
    def test_backoff_is_exponential_and_capped(self):
        p = RetryPolicy(backoff_base=0.1, backoff_multiplier=2.0,
                        backoff_max=0.5, jitter=0.0)
        assert backoff_delay(p, 1) == pytest.approx(0.1)
        assert backoff_delay(p, 2) == pytest.approx(0.2)
        assert backoff_delay(p, 3) == pytest.approx(0.4)
        assert backoff_delay(p, 4) == pytest.approx(0.5)  # capped
        assert backoff_delay(p, 10) == pytest.approx(0.5)

    def test_jitter_deterministic_and_bounded(self):
        p = RetryPolicy(backoff_base=1.0, backoff_multiplier=1.0,
                        jitter=0.2, seed=7)
        d1 = backoff_delay(p, 1, key=42)
        assert d1 == backoff_delay(p, 1, key=42)  # pure function
        assert 0.8 <= d1 <= 1.2
        assert d1 != backoff_delay(p, 1, key=43)  # decorrelated per key
        assert d1 != backoff_delay(p, 2, key=42)  # and per attempt
        p2 = RetryPolicy(backoff_base=1.0, backoff_multiplier=1.0,
                         jitter=0.2, seed=8)
        assert backoff_delay(p2, 1, key=42) != d1  # and per seed

    def test_validation(self):
        with pytest.raises(ValueError):
            RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            RetryPolicy(jitter=1.5)
        with pytest.raises(ValueError):
            RetryPolicy(lease_ttl=0)

    def test_json_roundtrip(self):
        p = RetryPolicy(max_attempts=5, backoff_base=0.3,
                        trial_timeout=12.5, seed=3)
        assert RetryPolicy.from_json(p.to_json()) == p

    def test_execute_with_retry_success_and_counting(self):
        stats = FaultStats()
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("boom")
            return "ok"

        slept = []
        result, attempts = execute_with_retry(
            fn, RetryPolicy(max_attempts=4, backoff_base=0.01, seed=1),
            key=0, stats=stats, sleep=slept.append,
        )
        assert result == "ok" and attempts == 3
        assert stats.get("trial_failure") == 2
        assert stats.get("trial_retried") == 2
        assert len(slept) == 2 and slept[1] > slept[0] * 1.5  # backoff grew

    def test_execute_with_retry_quarantines(self):
        stats = FaultStats()

        def fn():
            raise ValueError("poison")

        with pytest.raises(TrialQuarantined) as ei:
            execute_with_retry(
                fn, RetryPolicy(max_attempts=3, backoff_base=0.0),
                stats=stats, sleep=lambda s: None,
            )
        assert ei.value.attempts == 3
        assert isinstance(ei.value.last_error, ValueError)
        assert stats.get("trial_quarantined") == 1
        assert stats.get("trial_failure") == 3

    def test_first_attempt_resumes_budget(self):
        # a worker resuming a reclaimed trial starts mid-budget
        with pytest.raises(TrialQuarantined) as ei:
            execute_with_retry(
                lambda: 1 / 0, RetryPolicy(max_attempts=3),
                first_attempt=3, sleep=lambda s: None,
            )
        assert ei.value.attempts == 3  # no retries left

    def test_run_with_timeout(self):
        stats = FaultStats()
        assert run_with_timeout(lambda: 5, 1.0) == 5
        assert run_with_timeout(lambda: 5, None) == 5
        with pytest.raises(TrialTimeout):
            run_with_timeout(lambda: time.sleep(5), 0.05, stats=stats)
        assert stats.get("objective_timeout") == 1
        with pytest.raises(KeyError):  # errors delivered, not swallowed
            run_with_timeout(lambda: {}["missing"], 1.0)


# ---------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------


# ---------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------

class TestLeases:
    def test_reserve_grants_lease_and_counts_attempts(self, tmp_path):
        jobs = FileJobs(str(tmp_path), lease_ttl=5.0)
        jobs.insert(_doc(0))
        job = jobs.reserve("w1")
        assert job["misc"]["attempts"] == 1
        lease = jobs.read_lease(0)
        assert lease["owner"] == "w1" and lease["attempt"] == 1
        assert lease["expires_at"] > time.time()

    def test_renew_is_owner_checked(self, tmp_path):
        jobs = FileJobs(str(tmp_path), lease_ttl=5.0)
        jobs.insert(_doc(0))
        jobs.reserve("w1")
        before = jobs.read_lease(0)["expires_at"]
        time.sleep(0.02)
        assert jobs.renew_lease(0, "w1")
        assert jobs.read_lease(0)["expires_at"] > before
        assert not jobs.renew_lease(0, "impostor")
        jobs.clear_lease(0)
        assert not jobs.renew_lease(0, "w1")  # gone

    def test_torn_lease_reads_as_none(self, tmp_path):
        jobs = FileJobs(str(tmp_path))
        with open(jobs.lease_path(3), "wb") as f:
            f.write(b"\x00garbage")
        assert jobs.read_lease(3) is None

    def test_reaper_reclaims_expired_lease(self, tmp_path):
        jobs_ttl = 0.2
        trials = FileTrials(str(tmp_path), lease_ttl=jobs_ttl)
        trials.jobs.insert(_doc(0))
        trials.jobs.reserve("dead")  # never heartbeats
        stats = FaultStats()
        reaper = LeaseReaper(
            trials, policy=RetryPolicy(max_attempts=3, lease_ttl=jobs_ttl),
            stats=stats,
        )
        assert reaper.reap_once() == 0  # lease still fresh
        time.sleep(0.3)
        assert reaper.reap_once() == 1
        doc = trials.jobs.read_doc(0)
        assert doc["state"] == JOB_STATE_NEW
        assert doc["owner"] is None
        assert doc["misc"]["attempts"] == 1  # attempt was consumed
        assert not os.path.exists(trials.jobs.lock_path(0))
        assert trials.jobs.read_lease(0) is None
        assert stats.get("lease_reclaimed") == 1
        # the trial is re-reservable, and the attempt counter advances
        job = trials.jobs.reserve("w2")
        assert job is not None and job["misc"]["attempts"] == 2

    def test_reaper_quarantines_after_max_attempts(self, tmp_path):
        trials = FileTrials(str(tmp_path), lease_ttl=0.15)
        trials.jobs.insert(_doc(0))
        stats = FaultStats()
        reaper = LeaseReaper(
            trials, policy=RetryPolicy(max_attempts=2, lease_ttl=0.15),
            stats=stats,
        )
        for expected_state in (JOB_STATE_NEW, JOB_STATE_ERROR):
            assert trials.jobs.reserve("dead") is not None
            time.sleep(0.25)
            assert reaper.reap_once() == 1
            assert trials.jobs.read_doc(0)["state"] == expected_state
        doc = trials.jobs.read_doc(0)
        assert doc["misc"]["error"][0] == "LeaseExpired"
        assert stats.get("lease_quarantined") == 1
        assert stats.get("lease_reclaimed") == 1

    def test_reaper_leaves_completed_doc_alone(self, tmp_path):
        # the worker finished inside the reaper's scan window: its DONE
        # result must survive
        trials = FileTrials(str(tmp_path), lease_ttl=0.1)
        trials.jobs.insert(_doc(0))
        job = trials.jobs.reserve("slow")
        time.sleep(0.2)
        job["state"] = JOB_STATE_DONE
        job["result"] = {"status": STATUS_OK, "loss": 1.0}
        trials.jobs.write(job)
        reaper = LeaseReaper(trials, policy=RetryPolicy(lease_ttl=0.1))
        reaper.reap_once()
        assert trials.jobs.read_doc(0)["state"] == JOB_STATE_DONE

    def test_reaper_clears_stale_lock_on_new_trial(self, tmp_path):
        # a worker died between lock create and doc rewrite (or chaos
        # tore the lock): the NEW trial must become reservable again
        trials = FileTrials(str(tmp_path), lease_ttl=0.1)
        trials.jobs.insert(_doc(0))
        with open(trials.jobs.lock_path(0), "wb") as f:
            f.write(b"\x00torn\x00")
        assert trials.jobs.reserve("w1") is None  # blocked
        stats = FaultStats()
        reaper = LeaseReaper(
            trials, policy=RetryPolicy(lease_ttl=0.1), stats=stats
        )
        time.sleep(0.2)
        reaper.reap_once()
        assert stats.get("stale_lock_cleared") == 1
        assert trials.jobs.reserve("w1") is not None  # unblocked

    def test_heartbeat_keeps_lease_alive_then_lost_on_reclaim(self, tmp_path):
        ttl = 0.25
        trials = FileTrials(str(tmp_path), lease_ttl=ttl)
        trials.jobs.insert(_doc(0))
        trials.jobs.reserve("w1")
        stats = FaultStats()
        hb = LeaseHeartbeat(trials.jobs, 0, "w1", ttl=ttl,
                            interval=0.05, stats=stats).start()
        try:
            reaper = LeaseReaper(trials, policy=RetryPolicy(lease_ttl=ttl))
            time.sleep(2.5 * ttl)  # well past the ttl — but heartbeating
            assert reaper.reap_once() == 0
            assert trials.jobs.read_doc(0)["state"] == JOB_STATE_RUNNING
            assert stats.get("heartbeat") >= 3
            # now the reaper wins (simulate: lease cleared under us); the
            # next renewal finds it gone, whenever the thread runs next
            trials.jobs.clear_lease(0)
            deadline = time.monotonic() + 5.0
            while not hb.lost and time.monotonic() < deadline:
                time.sleep(0.01)
            assert hb.lost
        finally:
            hb.stop()

    def test_renewal_never_undoes_a_reclaim(self, tmp_path):
        """A reaper's clear that lands while a renewal sits between its
        read of the lease and its write waits for that write, so the lease
        stays cleared and the next renewal reports it lost (a
        read→check→write renewal without the lease mutex wrote it back)."""
        jobs = FileJobs(str(tmp_path), lease_ttl=5.0)
        jobs.insert(_doc(0))
        jobs.reserve("w1")
        read = jobs.read_lease
        in_window = threading.Event()

        def read_then_stall(tid):
            lease = read(tid)
            in_window.set()
            time.sleep(0.2)  # widens the read→write window, asserts nothing
            return lease

        jobs.read_lease = read_then_stall
        renewed = []
        renewer = threading.Thread(
            target=lambda: renewed.append(jobs.renew_lease(0, "w1")))
        renewer.start()
        try:
            assert in_window.wait(timeout=10.0)
            jobs.clear_lease(0)  # the reaper's reclaim
        finally:
            renewer.join(timeout=10.0)
        assert not renewer.is_alive()
        jobs.read_lease = read
        assert renewed == [True]
        assert jobs.read_lease(0) is None
        assert jobs.renew_lease(0, "w1") is False

    def test_worker_drops_stale_result(self, tmp_path):
        # lease reclaimed while the worker evaluates -> its result is
        # dropped, not written over the re-queued trial
        jobs = FileJobs(str(tmp_path), lease_ttl=5.0)
        jobs.insert(_doc(0))
        worker = FileWorker(str(tmp_path), poll_interval=0.01,
                            retry_policy=None)
        job = jobs.reserve("someone-else-came-first")  # simulate reclaim+steal
        assert job is not None
        stats = worker.stats
        hb = LeaseHeartbeat(jobs, 0, worker.owner, ttl=5.0, interval=10.0)
        wrote = worker._finish(
            dict(job, state=JOB_STATE_DONE,
                 result={"status": STATUS_OK, "loss": 0.0}),
            hb, worker.owner,
        )
        assert wrote is False
        assert stats.get("stale_result_dropped") == 1
        assert jobs.read_doc(0)["state"] == JOB_STATE_RUNNING  # untouched


# ---------------------------------------------------------------------
# worker retry integration
# ---------------------------------------------------------------------

class TestWorkerRetry:
    def test_worker_retries_in_place_from_attachment_policy(self, tmp_path):
        from hyperopt_tpu_torch.base import Domain
        import pickle

        trials = FileTrials(str(tmp_path), lease_ttl=5.0)
        trials.attachments["FMinIter_Domain"] = pickle.dumps(
            Domain(flaky_objective, SPACE)
        )
        trials.attachments["FMinIter_RetryPolicy"] = RetryPolicy(
            max_attempts=4, backoff_base=0.01, backoff_max=0.02
        ).to_json()
        trials.jobs.insert(_doc(0))
        _FLAKY_STATE["fails_left"] = 2
        worker = FileWorker(str(tmp_path), poll_interval=0.01)
        job = worker.run_one(reserve_timeout=1.0)
        assert job["state"] == JOB_STATE_DONE
        assert job["misc"]["attempts"] == 3  # 2 failures + 1 success
        assert worker.stats.get("trial_retried") == 2
        doc = trials.jobs.read_doc(0)
        assert doc["state"] == JOB_STATE_DONE
        assert doc["misc"]["attempts"] == 3

    def test_worker_adopts_policy_lease_ttl_and_follows_updates(self, tmp_path):
        trials = FileTrials(str(tmp_path))
        trials.attachments["FMinIter_RetryPolicy"] = RetryPolicy(
            lease_ttl=7.5
        ).to_json()
        worker = FileWorker(str(tmp_path), poll_interval=0.01)
        assert worker._retry_policy().lease_ttl == 7.5
        assert worker.trials.jobs.lease_ttl == 7.5  # adopted
        # a NEW driver run republishes a different policy: the same
        # long-lived worker follows it (blob-compare cache, not load-once)
        trials.attachments["FMinIter_RetryPolicy"] = RetryPolicy(
            lease_ttl=3.0, max_attempts=9
        ).to_json()
        assert worker._retry_policy().max_attempts == 9
        assert worker.trials.jobs.lease_ttl == 3.0
        # a run without a policy clears the attachment -> no retries
        del trials.attachments["FMinIter_RetryPolicy"]
        assert worker._retry_policy() is None
        # an explicit --lease-ttl always wins over the attachment
        explicit = FileWorker(str(tmp_path), poll_interval=0.01,
                              lease_ttl=42.0)
        trials.attachments["FMinIter_RetryPolicy"] = RetryPolicy(
            lease_ttl=7.5
        ).to_json()
        assert explicit._retry_policy().lease_ttl == 7.5
        assert explicit.trials.jobs.lease_ttl == 42.0

    def test_worker_quarantines_after_budget(self, tmp_path):
        from hyperopt_tpu_torch.base import Domain
        import pickle

        trials = FileTrials(str(tmp_path), lease_ttl=5.0)
        trials.attachments["FMinIter_Domain"] = pickle.dumps(
            Domain(flaky_objective, SPACE)
        )
        trials.attachments["FMinIter_RetryPolicy"] = RetryPolicy(
            max_attempts=2, backoff_base=0.01
        ).to_json()
        trials.jobs.insert(_doc(0))
        _FLAKY_STATE["fails_left"] = 99
        worker = FileWorker(str(tmp_path), poll_interval=0.01)
        with pytest.raises(TrialQuarantined):
            worker.run_one(reserve_timeout=1.0)
        _FLAKY_STATE["fails_left"] = 0
        doc = trials.jobs.read_doc(0)
        assert doc["state"] == JOB_STATE_ERROR
        # terminal write released the reservation
        assert not os.path.exists(trials.jobs.lock_path(0))
        assert trials.jobs.read_lease(0) is None


class TestWorkerCLI:
    def test_last_job_timeout_caps_the_reserve_wait(self, tmp_path):
        # an empty queue + huge --reserve-timeout must still exit at the
        # --last-job-timeout deadline (previously the reserve wait could
        # overshoot it by a full reserve_timeout)
        from hyperopt_tpu_torch.parallel.worker import main_worker_helper, make_parser

        opts = make_parser().parse_args([
            "--queue", str(tmp_path),
            "--poll-interval", "0.02",
            "--reserve-timeout", "300",
            "--last-job-timeout", "0.3",
        ])
        t0 = time.time()
        assert main_worker_helper(opts) == 0
        assert time.time() - t0 < 5.0

    def test_max_consecutive_failures_exits_nonzero(self, tmp_path):
        from hyperopt_tpu_torch.base import Domain
        import pickle

        trials = FileTrials(str(tmp_path))
        trials.attachments["FMinIter_Domain"] = pickle.dumps(
            Domain(flaky_objective, SPACE)
        )
        for tid in range(3):
            trials.jobs.insert(_doc(tid))
        _FLAKY_STATE["fails_left"] = 99
        from hyperopt_tpu_torch.parallel.worker import main_worker_helper, make_parser

        opts = make_parser().parse_args([
            "--queue", str(tmp_path),
            "--poll-interval", "0.02",
            "--reserve-timeout", "0.2",
            "--max-consecutive-failures", "2",
        ])
        try:
            assert main_worker_helper(opts) == 1
        finally:
            _FLAKY_STATE["fails_left"] = 0

    def test_lease_ttl_flag(self):
        from hyperopt_tpu_torch.parallel.worker import make_parser

        opts = make_parser().parse_args(["--queue", "q", "--lease-ttl", "7.5"])
        assert opts.lease_ttl == 7.5


# ---------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------

class TestChaos:
    def test_schedule_is_seed_deterministic(self):
        cfg = ChaosConfig(seed=5, p_worker_kill=0.5)

        def schedule(monkey):
            out = []
            for tid in range(50):
                try:
                    monkey.maybe_kill_worker(tid, "pre")
                    out.append(False)
                except WorkerKilled:
                    out.append(True)
            return out

        s1 = schedule(ChaosMonkey(cfg))
        s2 = schedule(ChaosMonkey(cfg))
        assert s1 == s2 and any(s1) and not all(s1)
        s3 = schedule(ChaosMonkey(ChaosConfig(seed=6, p_worker_kill=0.5)))
        assert s3 != s1

    def test_occurrence_advances_so_retries_reroll(self):
        monkey = ChaosMonkey(ChaosConfig(seed=0, p_objective_error=1.0))
        from hyperopt_tpu_torch.resilience.chaos import ChaosObjectiveError

        with pytest.raises(ChaosObjectiveError):
            monkey.objective_fault("k")
        # occurrence advanced — p=1 still fires, but the roll is distinct
        assert monkey._occurrence[("objective_error", "k")] == 1
        assert monkey.stats.get("chaos_objective_error") == 1

    def test_injections_are_counted(self):
        monkey = ChaosMonkey(ChaosConfig(seed=0, p_objective_nan=1.0))
        out = monkey.objective_fault("k")
        assert out != out  # NaN
        assert monkey.stats.injected() == {"objective_nan": 1}

    def test_activation_is_exclusive_and_scoped(self):
        from hyperopt_tpu_torch.resilience import chaos

        m = ChaosMonkey(ChaosConfig(seed=0))
        assert chaos.get_active() is None
        with active(m):
            assert chaos.get_active() is m
            with pytest.raises(RuntimeError):
                with active(ChaosMonkey(ChaosConfig(seed=1))):
                    pass
        assert chaos.get_active() is None

    def test_device_observer_installed_only_when_configured(self):
        from hyperopt_tpu_torch.algos import tpe_device

        n0 = len(tpe_device._suggest_observers)
        with active(ChaosMonkey(ChaosConfig(seed=0))):
            assert len(tpe_device._suggest_observers) == n0
        with active(ChaosMonkey(ChaosConfig(seed=0, p_device_error=0.5))):
            assert len(tpe_device._suggest_observers) == n0 + 1
        assert len(tpe_device._suggest_observers) == n0


# ---------------------------------------------------------------------
# crash-recovery E2E (the satellite gate)
# ---------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _restore_cwd():
    """Threaded workers chdir the whole process into trial workdirs and
    restore in any order; a test must not hand the next one a cwd inside
    its (possibly deleted) temporary directory."""
    cwd = os.getcwd()
    try:
        yield
    finally:
        os.chdir(cwd)


def _supervised_workers(qdir, n_workers, lease_ttl, stats):
    """Respawning worker-thread slots (a killed worker is replaced)."""
    stop = threading.Event()

    def supervise():
        while not stop.is_set():
            worker = FileWorker(qdir, poll_interval=0.02,
                                lease_ttl=lease_ttl, stats=stats)
            try:
                while not stop.is_set():
                    try:
                        worker.run_one(reserve_timeout=0.3)
                    except ReserveTimeout:
                        continue
            except WorkerKilled:
                continue  # respawn a fresh "process"
            except Exception:
                time.sleep(0.05)

    threads = [threading.Thread(target=supervise, daemon=True)
               for _ in range(n_workers)]
    for t in threads:
        t.start()
    return threads, stop


def _run_filetrials_fmin(qdir, n_trials, seed, lease_ttl, policy, stats,
                         n_workers=2):
    trials = FileTrials(qdir, lease_ttl=lease_ttl)
    threads, stop = _supervised_workers(qdir, n_workers, lease_ttl, stats)
    try:
        fmin(chaos_objective, SPACE, algo=CPU_RAND,
             max_evals=n_trials, trials=trials,
             rstate=np.random.default_rng(seed),
             retry_policy=policy, fault_stats=stats,
             show_progressbar=False, verbose=False)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
    trials.refresh()
    return trials


def _best_ok(trials):
    best = None
    for t in trials.trials:
        if t["state"] != JOB_STATE_DONE:
            continue
        loss = t["result"].get("loss")
        if t["result"].get("status") != STATUS_OK or loss is None:
            continue
        if best is None or loss < best[1]:
            best = (t["tid"], float(loss))
    return best


def test_crash_recovery_e2e_matches_fault_free(tmp_path):
    """Kill workers mid-trial under a chaos seed: leases are reclaimed,
    trials retry on respawned workers, the run completes with zero
    stranded reservations, and the best trial equals the fault-free
    run's best on the same seed."""
    # max_attempts=6: each attempt rolls the kill site twice (pre+post,
    # ~0.36 combined at p=0.2), so a 4-attempt budget quarantines a tid
    # every few seeds; six absorbs any realistic kill streak
    n_trials, seed, lease_ttl = 20, 0, 0.4
    policy = RetryPolicy(max_attempts=6, backoff_base=0.02,
                         backoff_max=0.1, lease_ttl=lease_ttl, seed=seed)

    ff = _run_filetrials_fmin(str(tmp_path / "ff"), n_trials, seed,
                              lease_ttl, policy, FaultStats())
    ff_best = _best_ok(ff)

    stats = FaultStats()
    monkey = ChaosMonkey(ChaosConfig(seed=seed, p_worker_kill=0.2),
                         stats=stats)
    with active(monkey):
        ch = _run_filetrials_fmin(str(tmp_path / "chaos"), n_trials, seed,
                                  lease_ttl, policy, stats)

    kills = stats.injected().get("worker_kill", 0)
    assert kills >= 1, "chaos schedule injected no kills; raise p or seed"
    # every kill left a RUNNING trial whose lease had to be reclaimed
    # (or quarantined) for fmin to have returned at all
    assert (stats.get("lease_reclaimed")
            + stats.get("lease_quarantined")) >= kills
    # zero stranded reservations
    docs = ch.jobs.all_docs()
    assert sum(1 for d in docs if d["state"] == JOB_STATE_RUNNING) == 0
    assert ch.jobs.locked_tids() == []
    assert len(glob.glob(os.path.join(ch.jobs.root, "leases", "*"))) == 0
    # all trials completed (none quarantined at this kill rate/budget)
    assert sum(1 for d in docs if d["state"] == JOB_STATE_DONE) == n_trials
    # identical best trial (rand suggestions are result-independent, and
    # retried trials re-evaluate the same deterministic point)
    assert _best_ok(ch) == ff_best


def test_fmin_quarantine_keeps_run_alive():
    """A permanently failing point is quarantined, not fatal, and the
    error trial is excluded from the history the TPE fit reads."""
    seen = {}

    def sometimes_poison(cfg):
        # the third DISTINCT point fails on every attempt (a genuinely
        # poison trial — retries must not rescue it)
        x = cfg["x"]
        seen.setdefault(x, len(seen))
        if seen[x] == 2:
            raise RuntimeError("poison point")
        return (x - 3.0) ** 2

    trials = Trials()
    fmin(sometimes_poison, SPACE, algo=CPU_RAND, max_evals=6,
         trials=trials, rstate=np.random.default_rng(0),
         retry_policy=RetryPolicy(max_attempts=2, backoff_base=0.0),
         show_progressbar=False, verbose=False)
    # Trials.trials filters JOB_STATE_ERROR out (reference semantics —
    # that filter IS the "excluded from the fit" mechanism); the
    # quarantined doc lives on in the full dynamic list
    states = [t["state"] for t in trials._dynamic_trials]
    assert states.count(JOB_STATE_ERROR) == 1
    assert states.count(JOB_STATE_DONE) == 5
    assert [t["state"] for t in trials.trials] == [JOB_STATE_DONE] * 5
    err = next(t for t in trials._dynamic_trials
               if t["state"] == JOB_STATE_ERROR)
    assert err["misc"]["attempts"] == 2
    assert "poison" in err["misc"]["error"][1]
    # quarantined trial contributes no loss to the history/fit
    assert len(trials.history.losses) == 5


def test_delayed_result_past_ttl_is_dropped_and_trial_retries(tmp_path):
    """The result_delay chaos site models a frozen worker (heartbeat
    stalls with it): past the TTL the reaper reclaims, the late write is
    dropped, and the trial completes on a retry."""
    import pickle

    from hyperopt_tpu_torch.base import Domain

    ttl = 0.25
    trials = FileTrials(str(tmp_path), lease_ttl=ttl)
    trials.attachments["FMinIter_Domain"] = pickle.dumps(
        Domain(quad_objective, SPACE)
    )
    trials.jobs.insert(_doc(0))
    stats = FaultStats()
    monkey = ChaosMonkey(
        ChaosConfig(seed=0, p_result_delay=1.0, delay_seconds=3 * ttl),
        stats=stats,
    )
    reaper = LeaseReaper(
        trials, policy=RetryPolicy(max_attempts=3, lease_ttl=ttl),
        stats=stats, interval=ttl / 4,
    )
    worker = FileWorker(str(tmp_path), poll_interval=0.01, lease_ttl=ttl,
                        stats=stats)
    with reaper:
        with active(monkey):
            job = worker.run_one(reserve_timeout=1.0)  # stalls, gets reclaimed
        assert stats.get("chaos_result_delay") == 1
        assert stats.get("stale_result_dropped") == 1
        assert job["tid"] == 0
        # the reaper re-queued it; a healthy worker (chaos off) finishes it
        deadline = time.time() + 5.0
        while time.time() < deadline:
            if trials.jobs.read_doc(0)["state"] == JOB_STATE_NEW:
                break
            time.sleep(0.05)
        job2 = worker.run_one(reserve_timeout=2.0)
    doc = trials.jobs.read_doc(0)
    assert doc["state"] == JOB_STATE_DONE
    assert doc["misc"]["attempts"] == 2
    assert job2["result"] == job["result"]  # deterministic objective


def test_torch_trials_retry_policy_is_honored():
    """retry_policy must reach TorchTrials' dispatcher threads: flaky
    objectives retry, poison ones quarantine, and the run survives."""
    from hyperopt_tpu_torch.parallel import TorchTrials

    attempts_by_x = {}

    def flaky(cfg):
        x = cfg["x"]
        n = attempts_by_x.get(x, 0) + 1
        attempts_by_x[x] = n
        if n == 1:  # every point fails its first attempt
            raise RuntimeError("transient")
        return (x - 3.0) ** 2

    stats = FaultStats()
    trials = TorchTrials(parallelism=2, device="cpu")
    best = fmin(flaky, SPACE, algo=CPU_RAND, max_evals=8, trials=trials,
                rstate=np.random.default_rng(0),
                retry_policy=RetryPolicy(max_attempts=3, backoff_base=0.01),
                fault_stats=stats,
                show_progressbar=False, verbose=False)
    assert best is not None
    done = [t for t in trials._dynamic_trials if t["state"] == JOB_STATE_DONE]
    assert len(done) == 8
    assert all(t["misc"]["attempts"] == 2 for t in done)
    assert stats.get("trial_retried") == 8


def test_fault_stats_merge_and_summary():
    a, b = FaultStats(), FaultStats()
    a.record("lease_reclaimed", 2)
    a.record_backoff(0.5)
    b.record("lease_reclaimed")
    b.record("chaos_worker_kill", 3)
    a.merge(b)
    assert a.get("lease_reclaimed") == 3
    assert a.injected() == {"worker_kill": 3}
    s = a.summary()
    assert s["backoff_s"] == 0.5 and s["chaos_worker_kill"] == 3


# ---------------------------------------------------------------------
# the schedules against the JAX package's
# ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_schedule_equals_the_jax_packages(seed):
    """One policy at one seed: the same backoff and jitter per (key,
    attempt), and the same attempts and sleeps through a flaky call."""
    kw = dict(max_attempts=5, backoff_base=0.05, backoff_multiplier=3.0,
              backoff_max=2.0, jitter=0.3, seed=seed)
    mine, ref = RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    assert mine.to_json() == ref.to_json()
    for key in (0, 3, "t17"):
        for attempt in range(1, 8):
            assert backoff_delay(mine, attempt, key=key) == jretry.backoff_delay(
                ref, attempt, key=key)

    def run(execute, policy):
        calls, slept = {"n": 0}, []

        def fn():
            calls["n"] += 1
            if calls["n"] < 4:
                raise RuntimeError("transient")
            return calls["n"]

        return execute(fn, policy, key=11, sleep=slept.append), slept

    assert run(execute_with_retry, mine) == run(jretry.execute_with_retry, ref)


@pytest.mark.parametrize("seed", [0, 5])
def test_chaos_schedule_equals_the_jax_packages(seed):
    """One ``ChaosConfig`` at one seed injects at the same sites, keys and
    occurrences in both packages, and counts the same."""
    kw = dict(seed=seed, p_worker_kill=0.3, p_objective_error=0.2,
              p_objective_nan=0.2, p_result_delay=0.25, p_result_duplicate=0.25,
              p_device_error=0.3)
    mine = ChaosMonkey(ChaosConfig(**kw))
    ref = jchaos.ChaosMonkey(jchaos.ChaosConfig(**kw))
    assert mine.config.to_json() == ref.config.to_json()

    def schedule(monkey, mod):
        out = []
        for tid in range(40):
            for where in ("pre", "post"):
                try:
                    monkey.maybe_kill_worker(tid, where)
                    out.append(0)
                except mod.WorkerKilled:
                    out.append(1)
            out.append(monkey.should_delay_result(tid))
            out.append(monkey.should_duplicate_result(tid))
            try:
                fault = monkey.objective_fault(mod.stable_key({"x": tid / 3}))
                out.append("nan" if fault is not None else None)
            except mod.ChaosObjectiveError:
                out.append("error")
            try:
                monkey.maybe_device_error()
                out.append(0)
            except mod.SyntheticDeviceError:
                out.append(1)
        return out

    from hyperopt_tpu_torch.resilience import chaos as tchaos

    assert schedule(mine, tchaos) == schedule(ref, jchaos)
    assert mine.stats.counts() == ref.stats.counts()
    assert mine.stats.injected()  # the schedule injected something


# ---------------------------------------------------------------------
# the CUDA error taxonomy
# ---------------------------------------------------------------------


def test_is_device_error_recognizes_the_cuda_families():
    assert is_device_error(SyntheticDeviceError("x"))
    assert is_device_error(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    if hasattr(torch, "AcceleratorError"):
        assert is_device_error(torch.AcceleratorError("CUDA error: an illegal memory access"))
    assert is_device_error(RuntimeError("CUDA error: device-side assert triggered"))
    assert not is_device_error(RuntimeError("shape mismatch: CUDA error later"))
    assert not is_device_error(ValueError("CUDA error: not a runtime error"))
    assert not is_device_error(KeyError("x"))
    assert is_device_error(mark_device_error(ValueError("readback failed")))


@pytest.mark.parametrize("seed,recovers", [(3, True), (0, False)])
def test_device_chaos_takes_the_recompute_path(seed, recovers):
    """Injected device errors at suggest dispatch: a failed speculation is
    dropped, the device recovery re-initializes, and its suggest is
    recomputed synchronously with the same ids and seed, so the run goes
    on (seed 3: three injections, each absorbed by one re-initialization,
    every trial DONE).  Three consecutive failures spend the recovery's
    budget of two re-initializations, and the run raises (seed 0); the
    reference would move its suggests to the CPU there, the port never
    does."""
    from hyperopt_tpu_torch.algos import tpe, tpe_device

    algo = partial(tpe.suggest, device="cpu", n_startup_jobs=3, n_EI_candidates=16)
    stats = FaultStats()
    monkey = ChaosMonkey(ChaosConfig(seed=seed, p_device_error=0.3), stats=stats)
    trials = Trials()

    def go():
        fmin(quad_objective, SPACE, algo=algo, max_evals=14, trials=trials,
             rstate=np.random.default_rng(1), show_progressbar=False, verbose=False,
             fault_stats=stats)

    with active(monkey):
        assert len(tpe_device._suggest_observers) == 1
        if recovers:
            go()
        else:
            with pytest.raises(SyntheticDeviceError):
                go()
    assert tpe_device._suggest_observers == []
    assert stats.injected().get("device_error", 0) >= 2
    assert all(t["state"] == JOB_STATE_DONE for t in trials.trials)
    assert (len(trials) == 14) == recovers
    assert stats.get("device_error") == stats.injected()["device_error"]
    # each error re-initialized but the one that met a spent budget
    assert stats.get("device_reinit") == stats.get("device_error") - (not recovers)
    assert stats.get("cpu_fallback") == 0


# ---------------------------------------------------------------------
# device recovery (the reference's TestDeviceRecovery, on the port)
# ---------------------------------------------------------------------


class TestDeviceRecovery:
    def test_is_device_error(self):
        assert is_device_error(SyntheticDeviceError("x"))
        assert not is_device_error(ValueError("x"))
        e = ValueError("tagged")
        e._hyperopt_device_error = True
        assert is_device_error(e)

    def test_transient_error_reinits_and_recovers(self):
        stats = FaultStats()
        rec = DeviceRecovery(max_reinits=2, stats=stats)
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] == 1:
                raise SyntheticDeviceError("preempted")
            return "suggestion"

        assert rec.run(fn) == "suggestion"
        assert stats.get("device_error") == 1
        assert stats.get("device_reinit") == 1
        assert not rec.cpu_fallback_active
        assert len(rec.reinit_seconds) == 1

    def test_success_refills_consecutive_budget(self):
        rec = DeviceRecovery(max_reinits=1, stats=FaultStats())
        flaky = {"fail_next": True}

        def fn():
            if flaky["fail_next"]:
                flaky["fail_next"] = False
                raise SyntheticDeviceError("blip")
            return 1

        for _ in range(4):  # 4 scattered single faults, each recovers
            flaky["fail_next"] = True
            assert rec.run(fn) == 1
        assert not rec.cpu_fallback_active
        assert rec.n_reinits == 0  # refilled after each success

    def test_persistent_failure_raises_at_the_budgets_end_without_cpu_fallback(self):
        """The reference's ``test_persistent_failure_escalates_to_cpu_then_
        raises`` on the port: no CPU step, so the budget's end raises."""
        stats = FaultStats()
        rec = DeviceRecovery(max_reinits=1, stats=stats)

        def fn():
            raise SyntheticDeviceError("dead device")

        with pytest.raises(SyntheticDeviceError):
            rec.run(fn)
        assert stats.get("device_reinit") == 1
        assert stats.get("cpu_fallback") == 0
        assert not rec.cpu_fallback_active
        assert stats.get("device_error") == 2  # reinit + exhausted

    def test_non_device_error_passes_through(self):
        rec = DeviceRecovery(stats=FaultStats())
        with pytest.raises(KeyError):
            rec.run(lambda: {}["missing"])
        assert rec.stats.get("device_error") == 0

    def test_absorb_contract(self):
        rec = DeviceRecovery(max_reinits=1, stats=FaultStats())
        assert rec.absorb(ValueError("not a device error")) is None
        assert rec.absorb(SyntheticDeviceError("a")) is True  # reinit
        assert rec.absorb(SyntheticDeviceError("b")) is False  # exhausted, no cpu step

    def test_reset_drops_the_device_histories_and_a_sticky_error_counts(self, monkeypatch):
        """A re-initialization drops every cached DeviceHistory (the next
        suggest rebuilds from the host history); a reset that itself raises
        (a poisoned CUDA context) is logged, and the retry's failure counts
        against the budget."""
        from hyperopt_tpu_torch.algos import tpe, tpe_device

        domain = Domain(quad_objective, SPACE)
        trials = Trials()
        algo = partial(tpe.suggest, device="cpu", n_startup_jobs=2, n_EI_candidates=8)
        fmin(quad_objective, SPACE, algo=algo, max_evals=4, trials=trials,
             rstate=np.random.default_rng(0), show_progressbar=False, verbose=False)
        dh = tpe_device.device_history_for(trials, domain.space, "cpu")
        assert len(tpe_device._cache) >= 1
        rec = DeviceRecovery(stats=FaultStats())
        assert rec.absorb(SyntheticDeviceError("oom")) is True
        assert len(tpe_device._cache) == 0
        algo([99], domain, trials, 5)
        dh2 = tpe_device.device_history_for(trials, domain.space, "cpu")
        assert dh2 is not dh and dh2.full_rebuilds == 1

        def poisoned():
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(tpe_device, "reset_device_state", poisoned)
        stats = FaultStats()
        rec = DeviceRecovery(max_reinits=2, stats=stats)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            rec.run(poisoned)
        assert (stats.get("device_error"), stats.get("device_reinit")) == (3, 2)


@pytest.mark.parametrize("seed", range(8))
def test_recovery_schedule_equals_the_jax_packages(seed):
    """One chaos schedule (the device site rolled once per dispatch) through
    each package's DeviceRecovery: while the reference needs no CPU
    fallback the fault counts are equal dispatch for dispatch; where the
    reference would engage it, the port raises at that very dispatch
    instead."""
    from hyperopt_tpu.observability import FaultStats as JFaultStats
    from hyperopt_tpu.resilience.device import DeviceRecovery as JDeviceRecovery

    cfg = dict(seed=seed, p_device_error=0.3)
    jstats, tstats = JFaultStats(), FaultStats()
    jmon = jchaos.ChaosMonkey(jchaos.ChaosConfig(**cfg), stats=jstats)
    tmon = ChaosMonkey(ChaosConfig(**cfg), stats=tstats)
    jrec = JDeviceRecovery(max_reinits=2, stats=jstats)
    trec = DeviceRecovery(max_reinits=2, stats=tstats)
    for i in range(40):
        try:
            jrec.run(jmon.maybe_device_error)
        except Exception:
            pass  # past its CPU step the reference raises too
        if jrec.cpu_fallback_active:
            with pytest.raises(SyntheticDeviceError):
                trec.run(tmon.maybe_device_error)
            assert tstats.get("cpu_fallback") == 0
            assert tstats.get("device_reinit") == jstats.get("device_reinit")
            break
        trec.run(tmon.maybe_device_error)
        assert tstats.counts() == jstats.counts(), i


def test_device_chaos_trajectory_is_seed_transparent():
    """Synthetic device errors at suggest dispatch (the reference's test,
    on the port): the recovered TPE run's parameter stream and best trial
    equal the fault-free run's (failed launches re-use their drawn (ids,
    seed))."""
    from hyperopt_tpu_torch.algos import tpe

    algo = partial(tpe.suggest, device="cpu")

    def run(with_chaos):
        trials = Trials()
        stats = FaultStats()

        def _go():
            fmin(chaos_objective, SPACE, algo=algo, max_evals=26, trials=trials,
                 rstate=np.random.default_rng(1),
                 retry_policy=RetryPolicy(max_attempts=3, backoff_base=0.01),
                 fault_stats=stats, show_progressbar=False, verbose=False)

        if with_chaos:
            with active(ChaosMonkey(ChaosConfig(seed=2, p_device_error=0.3), stats=stats)):
                _go()
        else:
            _go()
        return trials, stats

    ff_trials, _ = run(False)
    ch_trials, stats = run(True)
    assert stats.injected().get("device_error", 0) >= 1
    assert stats.get("device_error") >= stats.injected()["device_error"]
    assert stats.get("cpu_fallback") == 0
    assert len(ch_trials.trials) == len(ff_trials.trials)
    for a, b in zip(ch_trials.trials, ff_trials.trials):
        assert a["misc"]["vals"] == b["misc"]["vals"]
    assert _best_ok(ch_trials) == _best_ok(ff_trials)


def _failing_dispatches(fail_at):
    """A suggest observer that raises a SyntheticDeviceError on the
    dispatches numbered in ``fail_at`` (0-based)."""
    seen = {"n": 0}

    def observe(requests):
        i = seen["n"]
        seen["n"] += 1
        if i in fail_at:
            raise SyntheticDeviceError(f"injected at dispatch {i}")

    return observe


@pytest.mark.parametrize("fail_at,recovers", [((3, 4), True), ((3, 4, 5), False)])
def test_pipelined_recovery_within_and_past_the_budget(fail_at, recovers):
    """The pipelined fmin (k=1): two consecutive device errors (a failed
    speculative launch, then its synchronous recompute) are absorbed by
    two re-initializations and the trials equal a fault-free run's, value
    for value; a third raises."""
    from hyperopt_tpu_torch.algos import tpe, tpe_device
    from hyperopt_tpu_torch.fmin import FMinIter

    algo = partial(tpe.suggest, device="cpu", n_startup_jobs=3, n_EI_candidates=16)

    def run(observer):
        trials = Trials()
        it = FMinIter(algo, Domain(quad_objective, SPACE), trials,
                      rstate=np.random.default_rng(4), max_evals=10, max_speculation=1,
                      show_progressbar=False)
        if observer is not None:
            tpe_device._suggest_observers.append(observer)
        try:
            it.exhaust()
        finally:
            if observer is not None:
                tpe_device._suggest_observers.remove(observer)
        return it, [t["misc"]["vals"]["x"] for t in trials.trials]

    _, ff = run(None)
    if recovers:
        it, vals = run(_failing_dispatches(fail_at))
        assert vals == ff
        assert it.fault_stats.counts() == {"device_error": 2, "device_reinit": 2}
        assert it.device_recovery.n_reinits == 0  # refilled by the next success
    else:
        with pytest.raises(SyntheticDeviceError):
            run(_failing_dispatches(fail_at))


@pytest.mark.parametrize("kernel", ["pair_score", "fused_suggest"])
def test_kernel_launch_failure_is_a_device_error(kernel, monkeypatch):
    """A launch function returning a non-zero CUDA status raises an error
    the device recovery recognizes (the wrappers' launch path, driven on
    CPU tensors with the CUDA stream calls stubbed)."""
    import contextlib
    import types

    from hyperopt_tpu_torch.ops import fused_kernel, pair_kernel

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))

    def failing(*args):
        return 700  # cudaErrorIllegalAddress

    L, C, K, kb = 1, 64, 8, 3
    params = torch.zeros((L, 3, K))
    with pytest.raises(RuntimeError, match="CUDA error 700") as ei:
        if kernel == "pair_score":
            pair_kernel._launch(torch.zeros((L, C)), params, kb, fn=failing)
        else:
            fused_kernel._launch(torch.zeros((L, C)), None, None, params, kb, 1, 16,
                                 False, False, fn=failing)
    assert is_device_error(ei.value)
    stats = FaultStats()
    assert DeviceRecovery(max_reinits=0, stats=stats).absorb(ei.value) is False
    assert stats.get("device_error") == 1


# ---------------------------------------------------------------------
# fmin's wiring of the policy into the durable queue
# ---------------------------------------------------------------------


def test_fmin_publishes_and_clears_the_retry_policy(tmp_path):
    """An asynchronous run publishes its policy for out-of-process workers
    and adopts its lease TTL; a resumed run without one clears it."""
    from hyperopt_tpu_torch.fmin import FMinIter

    trials = FileTrials(str(tmp_path))
    policy = RetryPolicy(max_attempts=4, lease_ttl=2.5, seed=3)
    it = FMinIter(CPU_RAND, Domain(quad_objective, SPACE), trials,
                  rstate=np.random.default_rng(0), retry_policy=policy)
    assert RetryPolicy.from_json(trials.attachments["FMinIter_RetryPolicy"]) == policy
    assert trials.jobs.lease_ttl == 2.5
    assert it.search_stats.fault_stats is it.fault_stats
    FMinIter(CPU_RAND, Domain(quad_objective, SPACE), trials,
             rstate=np.random.default_rng(0))
    assert "FMinIter_RetryPolicy" not in trials.attachments
    assert "FMinIter_Domain" in trials.attachments


def test_fmin_serial_retry_records_attempts():
    """The serial loop retries in place under the policy (k=0 and the
    pipelined k=1 alike) and records the attempts on the doc."""
    for k in (0, 1):
        calls = {}

        def flaky(cfg):
            calls[cfg["x"]] = calls.get(cfg["x"], 0) + 1
            if calls[cfg["x"]] == 1:
                raise RuntimeError("transient")
            return cfg["x"] ** 2

        stats = FaultStats()
        trials = Trials()
        fmin(flaky, SPACE, algo=CPU_RAND, max_evals=4, trials=trials,
             rstate=np.random.default_rng(0), max_speculation=k,
             retry_policy=RetryPolicy(max_attempts=2, backoff_base=0.0),
             fault_stats=stats, show_progressbar=False, verbose=False)
        assert [t["misc"]["attempts"] for t in trials.trials] == [2] * 4
        assert stats.get("trial_retried") == 4


# ---------------------------------------------------------------------
# a worker process's graceful shutdown
# ---------------------------------------------------------------------


class TestWorkerGracefulShutdown:
    """SIGTERM to ``python -m hyperopt_tpu_torch.parallel.worker``.  The
    worker imports torch before it installs its handlers, so every signal
    waits for the worker's readiness line, never for a fixed time."""

    def _spawn(self, qdir, tmp_path):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO, os.path.join(REPO, "tests")]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        env["CUDA_VISIBLE_DEVICES"] = ""
        log = open(tmp_path / "worker.log", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "hyperopt_tpu_torch.parallel.worker",
             "--queue", qdir, "--poll-interval", "0.05", "--reserve-timeout", "60",
             "--workdir", str(tmp_path / "w")],
            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        return proc, log

    @staticmethod
    def _wait_for(log, proc, needle, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            log.seek(0)
            text = log.read()
            if needle in text:
                return text
            assert proc.poll() is None, text
            time.sleep(0.05)
        log.seek(0)
        pytest.fail(f"no {needle!r} in the worker's log:\n{log.read()}")

    def _stop(self, proc, log):
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        log.close()

    def test_sigterm_mid_trial_finishes_and_exits_zero(self, tmp_path):
        from worker_objective_helper import slow_quad_objective

        qdir = str(tmp_path / "q")
        trials = FileTrials(qdir)
        domain = Domain(slow_quad_objective, SPACE)
        trials.attachments["FMinIter_Domain"] = pickle.dumps(domain)
        docs = CPU_RAND(trials.new_trial_ids(1), domain, trials, 0)
        trials.insert_trial_docs(docs)
        tid = docs[0]["tid"]
        proc, log = self._spawn(qdir, tmp_path)
        try:
            self._wait_for(log, proc, "reserved trial")
            proc.send_signal(signal.SIGTERM)  # mid-objective (it sleeps 2 s)
            rc = proc.wait(timeout=60)
            text = self._wait_for(log, proc, "cuda initialized")
        finally:
            self._stop(proc, log)
        assert rc == 0
        assert "cuda initialized: False" in text
        doc = trials.jobs.read_doc(tid)
        assert doc["state"] == JOB_STATE_DONE  # finished, not lost
        assert not os.path.exists(trials.jobs.lock_path(tid))
        assert not os.path.exists(trials.jobs.lease_path(tid))

    def test_sigterm_during_reserve_wait_exits_promptly(self, tmp_path):
        qdir = str(tmp_path / "q")
        FileTrials(qdir)  # the (empty) queue layout
        proc, log = self._spawn(qdir, tmp_path)
        try:
            self._wait_for(log, proc, "ready on")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
        finally:
            self._stop(proc, log)
        assert rc == 0
