"""The port's durable queue (``hyperopt_tpu_torch.parallel.file_trials``
and ``worker``): the JAX package's ``tests/test_file_trials.py`` run
against the port — reservation exclusivity, worker error handling,
durability and resume, attachments, CLI parsing, subprocess workers
(``python -m hyperopt_tpu_torch.parallel.worker``), SIGKILL mid-
reservation and mid-result-write, and the fuzzed concurrency property —
then the queue against the JAX package's (both backends, both
directions), ``tpe.suggest`` from a ``FileTrials`` against a ``Trials``
holding the same docs, the speculative engine under out-of-process
completions, and the isolation of the port's store from the JAX
package's chaos monkey and storage hook.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from functools import partial

from hyperopt_tpu_torch import fmin, hp
from hyperopt_tpu_torch.algos import rand
from hyperopt_tpu_torch.base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_OK,
)
from hyperopt_tpu_torch.parallel.file_trials import FileJobs, FileTrials
from hyperopt_tpu_torch.parallel.worker import (
    FileWorker,
    ReserveTimeout,
    main_worker_helper,
    make_parser,
)


CPU_RAND = partial(rand.suggest, device="cpu")


@pytest.fixture(autouse=True)
def _restore_cwd():
    """Each worker chdirs the whole process into its trial's workdir and
    back; threaded workers restore in any order, so a test can end with
    the process inside one of its workdirs, which its temporary directory
    then deletes.  The next test would inherit a cwd that ``os.getcwd``
    cannot read (every later trial fails, and a worker loop that does not
    survive that leaves fmin waiting for ever)."""
    cwd = os.getcwd()
    try:
        yield
    finally:
        os.chdir(cwd)


def quad_objective(cfg):
    return (cfg["x"] - 3) ** 2


SPACE = {"x": hp.uniform("x", -5, 5)}


def run_workers(queue_dir, n_workers=2, max_jobs=1000):
    """Threaded in-process workers (the reference's with_worker_threads).

    Returns ``(threads, stop)``.  Workers poll THROUGH ``ReserveTimeout``
    until ``stop`` is set: a transiently empty queue (the fmin driver
    thread descheduled on a loaded single-core box) must not make a
    worker exit for good while fmin still has trials to enqueue —
    with every worker gone, fmin's poll loop blocks forever (observed
    as a suite deadlock in test_worker_error_path).  Call sites set
    ``stop`` once fmin returns, then join.
    """
    stop = threading.Event()

    def loop():
        w = FileWorker(queue_dir, poll_interval=0.02)
        done = 0
        while done < max_jobs and not stop.is_set():
            try:
                w.run_one(reserve_timeout=0.5)
                done += 1
            except ReserveTimeout:
                continue
            except Exception:
                # e.g. the tmp_path queue dir was deleted after a test
                # failure leaked this thread: don't busy-spin on it
                time.sleep(0.05)

    threads = [threading.Thread(target=loop, daemon=True) for _ in range(n_workers)]
    for t in threads:
        t.start()
    return threads, stop


class TestFileJobs:
    def test_id_allocation_monotonic_across_instances(self, tmp_path):
        j1 = FileJobs(str(tmp_path))
        j2 = FileJobs(str(tmp_path))
        assert j1.new_trial_ids(3) == [0, 1, 2]
        assert j2.new_trial_ids(2) == [3, 4]

    def test_reserve_exclusive(self, tmp_path):
        jobs = FileJobs(str(tmp_path))
        doc = {
            "tid": 0, "state": JOB_STATE_NEW, "spec": None,
            "result": {"status": "new"},
            "misc": {"tid": 0, "cmd": None, "idxs": {"x": [0]}, "vals": {"x": [1.0]}},
            "exp_key": None, "owner": None, "book_time": None, "refresh_time": None,
        }
        jobs.insert(doc)
        a = jobs.reserve("w1")
        b = jobs.reserve("w2")
        assert a is not None and a["owner"] == "w1"
        assert b is None

    def test_reserve_race_many_threads(self, tmp_path):
        jobs = FileJobs(str(tmp_path))
        for tid in range(20):
            jobs.insert({
                "tid": tid, "state": JOB_STATE_NEW, "spec": None,
                "result": {"status": "new"},
                "misc": {"tid": tid, "cmd": None, "idxs": {}, "vals": {}},
                "exp_key": None, "owner": None, "book_time": None, "refresh_time": None,
            })
        claimed = []
        lock = threading.Lock()

        def grab(owner):
            me = FileJobs(str(tmp_path))
            while True:
                doc = me.reserve(owner)
                if doc is None:
                    return
                with lock:
                    claimed.append(doc["tid"])

        threads = [threading.Thread(target=grab, args=(f"w{i}",)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(claimed) == list(range(20))  # every job exactly once

    def test_requeue_stale(self, tmp_path):
        jobs = FileJobs(str(tmp_path))
        jobs.insert({
            "tid": 0, "state": JOB_STATE_NEW, "spec": None,
            "result": {"status": "new"},
            "misc": {"tid": 0, "cmd": None, "idxs": {}, "vals": {}},
            "exp_key": None, "owner": None, "book_time": None, "refresh_time": None,
        })
        jobs.reserve("dead-worker")
        assert jobs.reserve("w2") is None
        n = jobs.requeue_stale(max_age_secs=-1.0)  # everything is stale
        assert n == 1
        again = jobs.reserve("w2")
        assert again is not None and again["owner"] == "w2"

    def test_attachments_roundtrip(self, tmp_path):
        jobs = FileJobs(str(tmp_path))
        jobs.set_attachment("blob", b"\x00\x01data")
        assert jobs.get_attachment("blob") == b"\x00\x01data"
        assert jobs.has_attachment("blob")
        jobs.del_attachment("blob")
        assert not jobs.has_attachment("blob")


class TestFileTrialsFmin:
    def test_fmin_with_threaded_workers(self, tmp_path):
        trials = FileTrials(str(tmp_path / "q"))
        threads, stop = run_workers(str(tmp_path / "q"), n_workers=3)
        try:
            best = fmin(
                quad_objective, SPACE, algo=CPU_RAND, max_evals=20,
                trials=trials, rstate=np.random.default_rng(0),
                show_progressbar=False, verbose=False,
            )
        finally:
            stop.set()
        for t in threads:
            t.join(timeout=5)
        assert len(trials) == 20
        assert all(t["state"] == JOB_STATE_DONE for t in trials.trials)
        assert abs(best["x"] - 3) < 2.0
        owners = {t["owner"] for t in trials.trials}
        assert owners  # stamped by workers

    def test_durability_resume(self, tmp_path):
        qdir = str(tmp_path / "q")
        trials = FileTrials(qdir)
        threads, stop = run_workers(qdir, n_workers=2)
        try:
            fmin(
                quad_objective, SPACE, algo=CPU_RAND, max_evals=10,
                trials=trials, rstate=np.random.default_rng(0),
                show_progressbar=False, verbose=False,
            )
        finally:
            stop.set()
        for t in threads:
            t.join(timeout=5)
        # a brand-new store on the same dir sees everything (Mongo-style
        # durability); resuming fmin continues to 15
        trials2 = FileTrials(qdir)
        assert len(trials2) == 10
        threads, stop = run_workers(qdir, n_workers=2)
        try:
            fmin(
                quad_objective, SPACE, algo=CPU_RAND, max_evals=15,
                trials=trials2, rstate=np.random.default_rng(1),
                show_progressbar=False, verbose=False,
            )
        finally:
            stop.set()
        for t in threads:
            t.join(timeout=5)
        assert len(FileTrials(qdir)) == 15

    def test_worker_error_path(self, tmp_path):
        qdir = str(tmp_path / "q")
        trials = FileTrials(qdir)

        threads, stop = run_workers(qdir, n_workers=2)
        try:
            fmin(
                flaky_objective, SPACE, algo=CPU_RAND, max_evals=12,
                trials=trials, catch_eval_exceptions=True,
                rstate=np.random.default_rng(3), show_progressbar=False,
                verbose=False, return_argmin=False,
            )
        finally:
            stop.set()
        for t in threads:
            t.join(timeout=5)
        trials.refresh()
        states = [t["state"] for t in trials._dynamic_trials]
        assert JOB_STATE_ERROR in states and JOB_STATE_DONE in states
        errs = [
            t for t in trials._dynamic_trials if t["state"] == JOB_STATE_ERROR
        ]
        assert all("negative" in t["misc"]["error"][1] for t in errs)


class TestWorkerCLI:
    def test_parser_defaults(self):
        opts = make_parser().parse_args(["--queue", "/tmp/q"])
        assert opts.queue == "/tmp/q"
        assert opts.poll_interval == 1.0
        assert opts.max_consecutive_failures == 4
        assert opts.reserve_timeout == 120.0
        assert opts.workdir is None

    def test_parser_all_flags(self):
        opts = make_parser().parse_args(
            [
                "--queue", "/q", "--exp-key", "e1", "--poll-interval", "0.5",
                "--max-consecutive-failures", "2", "--reserve-timeout", "10",
                "--workdir", "/w", "--last-job-timeout", "60", "--max-jobs", "5",
            ]
        )
        assert opts.exp_key == "e1"
        assert opts.max_jobs == 5

    def test_main_worker_helper_drains_queue(self, tmp_path):
        qdir = str(tmp_path / "q")
        trials = FileTrials(qdir)
        # enqueue trials by running fmin in a thread (it blocks until done)
        t = threading.Thread(
            target=lambda: fmin(
                quad_objective, SPACE, algo=CPU_RAND, max_evals=5,
                trials=trials, rstate=np.random.default_rng(0),
                show_progressbar=False, verbose=False, return_argmin=False,
            ),
            daemon=True,
        )
        t.start()
        opts = make_parser().parse_args(
            ["--queue", qdir, "--poll-interval", "0.02", "--reserve-timeout", "2"]
        )
        rc = main_worker_helper(opts)
        t.join(timeout=10)
        assert rc == 0
        assert len(FileTrials(qdir)) == 5

    def test_worker_ctrl_checkpoint(self, tmp_path):
        qdir = str(tmp_path / "q")
        trials = FileTrials(qdir)

        threads, stop = run_workers(qdir, n_workers=1)
        try:
            fmin(
                checkpointing_objective, SPACE, algo=CPU_RAND, max_evals=2,
                trials=trials, rstate=np.random.default_rng(0),
                show_progressbar=False, verbose=False, return_argmin=False,
                pass_expr_memo_ctrl=None,
            )
        finally:
            stop.set()
        for t in threads:
            t.join(timeout=5)
        assert len(FileTrials(qdir)) == 2


def checkpointing_objective(cfg):
    return abs(cfg["x"])


def flaky_objective(cfg):
    if cfg["x"] < 0:
        raise RuntimeError("negative")
    return cfg["x"]


class TestUnlockAtomicity:
    """Rename-then-verify unlock (the read->unlink TOCTOU fix)."""

    def test_unlock_own_lock(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import FileJobs

        jobs = FileJobs(str(tmp_path / "q"))
        lock = str(tmp_path / "q" / "locks" / "0.lock")
        assert jobs._try_lock(lock, "me")
        assert jobs._unlock_if_owner(lock, "me") is True
        assert not os.path.exists(lock)

    def test_unlock_preserves_foreign_lock(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import FileJobs

        jobs = FileJobs(str(tmp_path / "q"))
        lock = str(tmp_path / "q" / "locks" / "1.lock")
        assert jobs._try_lock(lock, "them")
        assert jobs._unlock_if_owner(lock, "me") is False
        # their reservation survives, content intact, no stray temp files
        assert os.path.exists(lock)
        with open(lock) as f:
            assert f.read() == "them"
        leftovers = [p for p in os.listdir(tmp_path / "q" / "locks")
                     if ".unlock." in p]
        assert leftovers == []

    def test_unlock_missing_lock(self, tmp_path):
        from hyperopt_tpu_torch.parallel.file_trials import FileJobs

        jobs = FileJobs(str(tmp_path / "q"))
        lock = str(tmp_path / "q" / "locks" / "2.lock")
        assert jobs._unlock_if_owner(lock, "me") is False


class TestSubprocessWorkers:
    """True cross-process E2E: the worker CLI in separate interpreters,
    mutual exclusion via the on-disk lock files (threads share a GIL and
    an inode cache; processes do not)."""

    def test_fmin_with_subprocess_workers(self, tmp_path):
        import subprocess
        import sys

        from worker_objective_helper import quad_objective as proc_objective

        qdir = str(tmp_path / "q")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo, os.path.join(repo, "tests")]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
        )
        env["CUDA_VISIBLE_DEVICES"] = ""
        logs, procs = [], []

        def worker_logs():
            out = []
            for i, f in enumerate(logs):
                f.flush()
                f.seek(0)
                out.append(f"--- worker {i} (rc={procs[i].poll()}) ---\n" + f.read())
            return "\n".join(out)

        try:
            for i in range(2):
                logs.append(open(tmp_path / f"worker{i}.log", "w+"))
                procs.append(
                    subprocess.Popen(
                        [
                            sys.executable, "-m", "hyperopt_tpu_torch.parallel.worker",
                            "--queue", qdir,
                            "--poll-interval", "0.05",
                            "--reserve-timeout", "20",
                            "--workdir", str(tmp_path / f"w{i}"),
                        ],
                        env=env,
                        cwd=repo,
                        stdout=logs[i],
                        stderr=subprocess.STDOUT,
                    )
                )
            trials = FileTrials(qdir)
            # fmin's own whole-run timeout is the watchdog: dead workers
            # leave jobs NEW and the loop exits instead of polling forever
            best = fmin(
                proc_objective, SPACE, algo=CPU_RAND, max_evals=12,
                trials=trials, rstate=np.random.default_rng(0),
                show_progressbar=False, verbose=False, timeout=90,
            )
            trials.refresh()
            assert len(trials) == 12, worker_logs()
            assert all(
                t["state"] == JOB_STATE_DONE for t in trials.trials
            ), worker_logs()
            assert abs(best["x"] - 3) < 2.5
            # every trial executed exactly once, by a real worker process
            # (owner stamped host:pid at reservation); with 2 workers the
            # split is usually but not deterministically 2-way, so only
            # the stamping itself is asserted
            owners = {t["owner"] for t in trials.trials}
            assert owners and all(o for o in owners), owners
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.wait(timeout=10)
            for f in logs:
                f.close()


class TestCrashInjection:
    """SIGKILL a REAL worker process mid-reservation and mid-result-write
    requeue_stale must recover the trial exactly once,
    no doc lost, none double-run — the recovery the reference's Mongo
    backend lacks (dead workers leave jobs reserved forever,
    hyperopt/mongoexp.py reserve semantics ~L160-500).
    """

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def _spawn(self, code, qdir, ready):
        import subprocess

        env = dict(os.environ)
        env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.Popen(
            [sys.executable, "-c", code],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        deadline = time.time() + 60
        while not os.path.exists(ready):
            if proc.poll() is not None:
                raise AssertionError(
                    "crash child exited early:\n"
                    + proc.stdout.read().decode(errors="replace")
                )
            assert time.time() < deadline, "crash child never became ready"
            time.sleep(0.05)
        return proc

    def _seed_queue(self, qdir, backend=None):
        jobs = FileJobs(qdir, backend=backend)
        jobs.insert({
            "tid": 0, "state": JOB_STATE_NEW, "spec": None,
            "result": {"status": "new"},
            "misc": {"tid": 0, "cmd": None, "idxs": {"x": [0]}, "vals": {"x": [1.0]}},
            "exp_key": None, "owner": None, "book_time": None,
            "refresh_time": None,
        })
        return jobs

    def _assert_recovers_exactly_once(self, jobs, qdir):
        import signal

        # the dead worker's claim is visible: RUNNING + lock file held
        [doc] = jobs.all_docs()
        assert doc["state"] == JOB_STATE_RUNNING
        assert os.path.exists(jobs.lock_path(0))
        # a live worker cannot steal it before recovery
        assert jobs.reserve("thief") is None
        # recovery: exactly one requeue; doc intact and NEW again
        assert jobs.requeue_stale(max_age_secs=-1.0) == 1
        assert jobs.requeue_stale(max_age_secs=-1.0) == 0  # idempotent
        [doc] = jobs.all_docs()
        assert doc["state"] == JOB_STATE_NEW and doc["owner"] is None
        # a second worker runs it to completion, exactly once
        doc = jobs.reserve("rescuer")
        assert doc is not None and doc["owner"] == "rescuer"
        doc["state"] = JOB_STATE_DONE
        doc["result"] = {"status": "ok", "loss": 0.5}
        jobs.write(doc)
        docs = jobs.all_docs()
        assert len(docs) == 1  # no doc lost, none duplicated
        assert docs[0]["state"] == JOB_STATE_DONE
        assert docs[0]["result"]["loss"] == 0.5
        assert docs[0]["owner"] == "rescuer"

    def test_sigkill_mid_reservation(self, tmp_path):
        import signal

        qdir = str(tmp_path / "q")
        ready = str(tmp_path / "ready")
        jobs = self._seed_queue(qdir)
        code = f"""
import sys, time
sys.path.insert(0, {self.REPO!r})
from hyperopt_tpu_torch.parallel.file_trials import FileJobs
jobs = FileJobs({qdir!r})
doc = jobs.reserve("crash-worker")
assert doc is not None, "nothing to reserve"
open({ready!r}, "w").write(str(doc["tid"]))
time.sleep(300)  # SIGKILLed here, reservation held
"""
        proc = self._spawn(code, qdir, ready)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        self._assert_recovers_exactly_once(jobs, qdir)

    def test_sigkill_mid_result_write(self, tmp_path):
        import signal

        qdir = str(tmp_path / "q")
        ready = str(tmp_path / "ready")
        # the per-doc backend: this test pins the atomic-replace torn-write
        # window (os.replace stubbed below), which the segmented backend
        # replaces with the torn-segment-tail discipline (test_fsck FS410)
        jobs = self._seed_queue(qdir, backend="doc")
        # the child stalls INSIDE the result write: tmp file written and
        # fsynced, the atomic os.replace not yet executed — the kill lands
        # exactly in the torn-write window
        code = f"""
import sys, time, os
sys.path.insert(0, {self.REPO!r})
from hyperopt_tpu_torch.parallel import file_trials as ft
jobs = ft.FileJobs({qdir!r})
doc = jobs.reserve("crash-worker-2")
assert doc is not None, "nothing to reserve"
doc["state"] = {JOB_STATE_DONE}
doc["result"] = {{"status": "ok", "loss": 99.0}}
def hang(src, dst):
    open({ready!r}, "w").write("mid-write")
    time.sleep(300)  # SIGKILLed here, replace pending
ft.os.replace = hang
jobs.write(doc)
"""
        proc = self._spawn(code, qdir, ready)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        # atomicity held: the doc is the PRE-write (RUNNING) version, not
        # a torn file, and the dead worker's phantom result never lands
        self._assert_recovers_exactly_once(jobs, qdir)
        # the orphaned tmp file (if any) must not confuse the queue scan
        assert jobs.count_states()[JOB_STATE_DONE] == 1


# ---------------------------------------------------------------------
# Randomized concurrency property (fuzz-campaign property 4)
# ---------------------------------------------------------------------

# Per-run evaluation-count registry, keyed by the run's queue dir: a
# worker thread leaked from a previous wedged run (e.g. after the fuzz
# campaign's watchdog fired mid-run) records into ITS OWN run's dict and
# can no longer corrupt a later seed's exactly-once accounting the way a
# single module-global dict could.
_chaos_registry = {}
_chaos_registry_lock = threading.Lock()


class ChaosObjective:
    """Random-latency, randomly-failing objective that records how many
    times each sampled point was evaluated (uid = the x draw, unique per
    trial with probability 1 under a continuous dist).  A picklable class
    instance (FileTrials workers unpickle the domain) carrying its run
    key; the counts dict itself stays process-local in the registry."""

    def __init__(self, run_key):
        self.run_key = run_key

    @property
    def counts(self):
        with _chaos_registry_lock:
            return _chaos_registry.setdefault(self.run_key, {})

    def __call__(self, cfg):
        uid = round(float(cfg["x"]), 9)
        counts = self.counts
        with _chaos_registry_lock:
            counts[uid] = counts.get(uid, 0) + 1
        time.sleep(float(cfg["sleep_ms"]) / 1000.0)
        if cfg["fail"]:
            raise RuntimeError("chaos failure")
        return (float(cfg["x"]) - 1.0) ** 2


@pytest.mark.parametrize("seed", range(2))
def test_fuzzed_filetrials_concurrency(seed):
    """Randomized end-to-end stress of the durable queue: random worker
    count, per-trial latency, and failure rate.  Invariants: no doc is
    lost, every doc reaches a terminal state exactly once (double
    evaluation would be a reservation-exclusivity bug; the SIGKILL tier
    covers crashed-worker recovery separately), failures carry their
    error annotation, and successes carry a finite loss.  Also looped
    over fresh seeds for the JAX package by scripts/fuzz_campaign.py."""
    import tempfile

    rng = np.random.default_rng(10_000 + seed)
    n_workers = int(rng.integers(1, 5))
    n_trials = int(rng.integers(8, 21))
    fail_p = float(rng.uniform(0.0, 0.35))
    max_sleep_ms = float(rng.choice([5.0, 30.0, 80.0]))
    space = {
        "x": hp.uniform("x", -5, 5),
        "sleep_ms": hp.uniform("sleep_ms", 0.0, max_sleep_ms),
        "fail": hp.pchoice("fail", [(1.0 - fail_p, 0), (fail_p, 1)]),
    }

    with tempfile.TemporaryDirectory() as td:
        qdir = os.path.join(td, "q")
        objective = ChaosObjective(qdir)  # qdir is unique per run
        trials = FileTrials(qdir)
        threads, stop = run_workers(qdir, n_workers=n_workers)
        try:
            fmin(
                objective, space, algo=CPU_RAND,
                max_evals=n_trials, trials=trials,
                catch_eval_exceptions=True,
                rstate=np.random.default_rng(seed),
                show_progressbar=False, verbose=False, return_argmin=False,
            )
        finally:
            # join INSIDE the finally: if fmin raises (e.g. the campaign
            # watchdog's TimeoutError), live workers must be drained
            # before TemporaryDirectory cleanup, or rmtree races their
            # in-flight writes and masks the original failure
            stop.set()
            for t in threads:
                t.join(timeout=10)
        trials.refresh()
        docs = trials._dynamic_trials
        assert len(docs) == n_trials, (len(docs), n_trials)
        assert len({d["tid"] for d in docs}) == n_trials
        for d in docs:
            assert d["state"] in (JOB_STATE_DONE, JOB_STATE_ERROR), d["tid"]
            if d["state"] == JOB_STATE_DONE:
                assert np.isfinite(d["result"]["loss"])
            else:
                assert "chaos failure" in d["misc"]["error"][1]
            assert d["owner"] is not None
        with _chaos_registry_lock:
            counts = dict(_chaos_registry.get(qdir, {}))
        assert len(counts) == n_trials
        multi = {u: c for u, c in counts.items() if c != 1}
        assert not multi, f"trials evaluated more than once: {multi}"


# ---------------------------------------------------------------------
# The queue against the JAX package's
# ---------------------------------------------------------------------

import copy  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402

import hyperopt_tpu as J  # noqa: E402
import hyperopt_tpu_torch as T  # noqa: E402
from hyperopt_tpu.parallel import file_trials as jft  # noqa: E402
from hyperopt_tpu.parallel import worker as jworker  # noqa: E402
from hyperopt_tpu.resilience import chaos as jchaos  # noqa: E402
from hyperopt_tpu_torch.algos import tpe  # noqa: E402
from hyperopt_tpu_torch.base import Domain, trials_from_docs  # noqa: E402
from hyperopt_tpu_torch.fmin import FMinIter  # noqa: E402
from hyperopt_tpu_torch.parallel import file_trials as tft  # noqa: E402
from hyperopt_tpu_torch.parallel import worker as tworker  # noqa: E402
from hyperopt_tpu_torch.pipeline import SpeculativeSuggestEngine  # noqa: E402
from hyperopt_tpu_torch.resilience import chaos as tchaos  # noqa: E402
from worker_objective_helper import quad_objective as helper_objective  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (T, tft, tworker), "jax": (J, jft, jworker)}
BACKENDS = ["segment", "doc"]


def _space(P):
    return {"x": P.hp.uniform("x", -5, 5), "k": P.hp.choice("k", [0, 1, 2])}


def _miscs(tids, rng):
    return [
        {"tid": t, "cmd": ("domain_attachment", "FMinIter_Domain"), "workdir": None,
         "idxs": {"x": [t], "k": [t]},
         "vals": {"x": [float(rng.uniform(-5, 5))], "k": [int(rng.integers(3))]}}
        for t in tids
    ]


def _complete(jobs, tid, owner, loss):
    """What a worker's terminal write does: the DONE doc, then the lease
    and the lock released."""
    doc = jobs.read_doc(tid)
    doc["state"] = JOB_STATE_DONE
    doc["result"] = {"status": STATUS_OK, "loss": float(loss)}
    jobs.write(doc)
    jobs.clear_lease(tid)
    jobs._unlock_if_owner(jobs.lock_path(tid), owner)


def _write_queue(writer, qdir, backend, live=None):
    """A queue as one package's driver and workers leave it: 12 trials in
    one group commit, 8 reserved together and completed out of tid order
    (one as an error), the last 3 run by that package's ``FileWorker``.
    ``live``, a port ``FileTrials`` opened on the empty queue, refreshes
    after every completion (the O(delta) path)."""
    P, ft, wk = PACKAGES[writer]
    trials = ft.FileTrials(qdir, backend=backend)
    assert trials.jobs.backend == backend
    trials.attachments["FMinIter_Domain"] = pickle.dumps(
        P.base.Domain(helper_objective, _space(P)))
    rng = np.random.default_rng(7)
    ids = trials.new_trial_ids(12)
    trials.insert_trial_docs(trials.new_trial_docs(
        ids, [None] * 12, [{"status": "new"} for _ in ids], _miscs(ids, rng)))
    jobs = trials.jobs
    reserved = [jobs.reserve(f"w{i}")["tid"] for i in range(8)]
    for i in [5, 2, 7, 0, 3, 6, 1]:
        _complete(jobs, reserved[i], f"w{i}", loss=float(rng.normal()))
        if live is not None:
            live.refresh()
    doc = jobs.read_doc(reserved[4])
    doc["state"] = JOB_STATE_ERROR
    doc["misc"]["error"] = ("<class 'RuntimeError'>", "boom")
    jobs.write(doc)
    jobs.clear_lease(reserved[4])
    jobs._unlock_if_owner(jobs.lock_path(reserved[4]), "w4")
    worker = wk.FileWorker(qdir, poll_interval=0.01)
    for _ in range(3):
        worker.run_one(reserve_timeout=10)
    if live is not None:
        live.refresh()


def _view(trials):
    h = trials.history
    return {
        "docs": list(trials._dynamic_trials),
        "losses": trials.losses(),
        "statuses": trials.statuses(),
        "loss_tids": h.loss_tids.tolist(),
        "hist_losses": h.losses.tolist(),
        "idxs": {k: np.asarray(v).tolist() for k, v in h.idxs.items()},
        "vals": {k: np.asarray(v).tolist() for k, v in h.vals.items()},
    }


def _by_tid(trials):
    h = trials.history
    return (
        {d["tid"]: d for d in trials._dynamic_trials},
        sorted(zip(h.loss_tids.tolist(), h.losses.tolist())),
    )


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_queue_reads_equal_in_both_packages(tmp_path, writer, backend):
    """A queue written by either package, with out-of-order completions,
    opens in both packages' ``FileTrials`` to equal docs, losses,
    statuses and history arrays; the port's live handle, refreshed after
    each completion, ends equal to a fresh open."""
    qdir = str(tmp_path / "q")
    live = FileTrials(qdir, backend=backend) if writer == "jax" else None
    _write_queue(writer, qdir, backend, live=live)
    port, ref = FileTrials(qdir), jft.FileTrials(qdir)
    assert port.jobs.backend == ref.jobs.backend == backend
    got, want = _view(port), _view(ref)
    assert got == want
    assert len(got["docs"]) == 12 and got["statuses"].count(STATUS_OK) == 10
    assert port.jobs.count_states() == ref.jobs.count_states()
    assert port.jobs.locked_tids() == ref.jobs.locked_tids() == []
    assert sorted(port.attachments) == sorted(ref.attachments)
    # the id counter continues across packages
    assert port.jobs.new_trial_ids(1) == [12]
    assert ref.jobs.new_trial_ids(1) == [13]
    if live is not None:
        # same docs and history by tid; the order differs, as in the JAX
        # package: a live handle keeps each tid where it first appeared,
        # a fresh open of the segment log lists docs by their last write
        fresh = FileTrials(qdir)
        assert _by_tid(live) == _by_tid(fresh)
        assert _by_tid(fresh) == _by_tid(jft.FileTrials(qdir))


# ---------------------------------------------------------------------
# tpe.suggest from a FileTrials against a Trials with the same docs
# ---------------------------------------------------------------------

TPE_SPACE = {
    "x": hp.uniform("x", -5, 5),
    "lr": hp.loguniform("lr", -7, 0),
    "w": hp.quniform("w", 8, 64, 8),
    "k": hp.choice("k", ["a", "b", "c"]),
}
CPU_TPE = partial(tpe.suggest, device="cpu", n_startup_jobs=5, n_EI_candidates=64)


def _tpe_miscs(tids, rng):
    return [
        {"tid": t, "cmd": ("domain_attachment", "FMinIter_Domain"), "workdir": None,
         "idxs": {k: [t] for k in TPE_SPACE},
         "vals": {"x": [float(rng.uniform(-5, 5))],
                  "lr": [float(np.exp(rng.uniform(-7, 0)))],
                  "w": [float(8 * rng.integers(1, 9))],
                  "k": [int(rng.integers(3))]}}
        for t in tids
    ]


def _fill(ft, n, rng):
    ids = ft.new_trial_ids(n)
    ft.insert_trial_docs(ft.new_trial_docs(
        ids, [None] * n, [{"status": "new"} for _ in ids], _tpe_miscs(ids, rng)))
    return ids


def _suggest_both(ft, domain, seed):
    """``tpe.suggest`` from ``ft`` and from a fresh ``Trials`` built from
    copies of the same docs, with the same ids and seed."""
    ids = [10_000 + seed]
    mine = CPU_TPE(ids, domain, ft, seed)
    fresh = trials_from_docs(copy.deepcopy(ft._dynamic_trials))
    ref = CPU_TPE(ids, domain, fresh, seed)
    return [d["misc"]["vals"] for d in mine], [d["misc"]["vals"] for d in ref]


@pytest.mark.parametrize("backend", BACKENDS)
def test_tpe_suggest_from_file_trials_equals_trials(tmp_path, backend):
    """The device history mirror of a ``FileTrials`` follows completions
    another process writes out of tid order, and a ``delete_all`` and
    refill: after each wave its suggest equals the suggest from a fresh
    ``Trials`` holding the same docs."""
    qdir = str(tmp_path / "q")
    ft = FileTrials(qdir, backend=backend)
    other = FileJobs(qdir, backend=backend)  # the out-of-process worker's handle
    domain = Domain(quad_objective, TPE_SPACE)
    rng = np.random.default_rng(3)
    ids = _fill(ft, 40, rng)
    for tid in ids:
        assert other.reserve(f"w{tid}")["tid"] == tid
    order = rng.permutation(ids)
    seed = 0
    for wave in np.array_split(order, 4):
        for tid in wave:
            _complete(other, int(tid), f"w{tid}", loss=float(rng.normal()))
        ft.refresh()
        mine, ref = _suggest_both(ft, domain, seed)
        assert mine == ref, (wave, seed)
        seed += 1
    ft.delete_all()
    assert len(ft) == 0
    ids = _fill(ft, 25, rng)
    for tid in ids:
        assert other.reserve(f"v{tid}")["tid"] == tid
    for tid in rng.permutation(ids):
        _complete(other, int(tid), f"v{tid}", loss=float(rng.normal(3.0)))
    ft.refresh()
    assert len(ft) == 25
    mine, ref = _suggest_both(ft, domain, seed)
    assert mine == ref


# ---------------------------------------------------------------------
# the speculative engine under out-of-process completions
# ---------------------------------------------------------------------


@pytest.mark.parametrize("lands", ["below", "above"])
def test_speculation_follows_an_out_of_process_completion(tmp_path, lands):
    """A speculation launched while trial 30 runs in another process bets
    that its loss lands above.  When the completion lands below (the
    γ-split changes), the engine relaunches the speculation and never
    hands out the stale one; when it lands above, the speculation is
    consumed as it was.  Either way the suggestion equals the serial
    suggest with the same ids and seed on the completed history."""
    qdir = str(tmp_path / "q")
    ft = FileTrials(qdir)
    other = FileJobs(qdir)
    rng = np.random.default_rng(5)
    ids = _fill(ft, 31, rng)
    for tid in ids:
        other.reserve(f"w{tid}")
    for tid in ids[:-1]:
        _complete(other, tid, f"w{tid}", loss=float(rng.normal()))
    ft.refresh()  # 30 DONE, trial 30 RUNNING
    domain = Domain(quad_objective, TPE_SPACE)
    engine = SpeculativeSuggestEngine(CPU_TPE, domain, ft, np.random.default_rng(0),
                                      max_speculation=1)
    engine.speculate()
    assert engine.stats.n_hypothesis == 1
    _complete(other, ids[-1], f"w{ids[-1]}", loss=-100.0 if lands == "below" else 100.0)
    ft.refresh()  # what fmin's poll loop does before its next enqueue
    docs, new_ids = engine.next_batch(1)
    seed = int(np.random.default_rng(0).integers(2 ** 31 - 1))
    ref = CPU_TPE(new_ids, domain, trials_from_docs(copy.deepcopy(ft._dynamic_trials)), seed)
    assert [d["misc"]["vals"] for d in docs] == [d["misc"]["vals"] for d in ref]
    assert engine.stats.n_invalidated == (1 if lands == "below" else 0)
    assert engine.stats.n_used == 1 and engine.stats.n_sync == 0


_improving = {"n": 0}
_improving_lock = threading.Lock()


def improving_objective(cfg):
    """Every completion beats every earlier one, so each lands in the
    below set and changes the γ-split of whatever was speculated."""
    with _improving_lock:
        _improving["n"] += 1
        n = _improving["n"]
    return -float(n)


def test_fmin_with_workers_invalidates_stale_speculations(tmp_path):
    """fmin on a ``FileTrials`` with threaded workers and TPE: completions
    that change the γ-split invalidate the engine's speculations, which
    are relaunched, and every trial ends DONE.  (The driver sleeps 0.2 s
    per round, the workers poll every 0.02 s: each completion lands while
    the driver sleeps on the speculation it launched.)"""
    qdir = str(tmp_path / "q")
    trials = FileTrials(qdir)
    it = FMinIter(CPU_TPE, Domain(improving_objective, TPE_SPACE), trials,
                  rstate=np.random.default_rng(0), max_evals=20,
                  show_progressbar=False, poll_interval_secs=0.2)
    threads, stop = run_workers(qdir, n_workers=2)
    try:
        it.exhaust()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    trials.refresh()
    assert len(trials) == 20
    assert all(t["state"] == JOB_STATE_DONE for t in trials.trials)
    s = it.speculation_stats
    assert s.n_dispatched >= 1 and s.n_invalidated >= 1
    # each suggestion was either a consumed speculation or computed in line
    assert s.n_used + s.n_sync >= 20 - 5  # past the 5 startup trials


def _recording(algo, calls):
    def rec(new_ids, domain, trials, seed):
        calls.append((list(new_ids), int(seed)))
        return algo(new_ids, domain, trials, seed)

    # declared speculable: only max_speculation=0 keeps the engine off
    rec.speculation_policy = "independent"
    return rec


def test_max_speculation_zero_is_the_reference_loop(tmp_path):
    """With ``max_speculation=0`` the port's fmin on a ``FileTrials`` with
    threaded workers makes the JAX package's suggest calls at k=0: the
    same ids with the same seeds, in the same order, and no speculation."""
    def run(P, ft, wk, algo, qdir):
        calls = []
        trials = ft.FileTrials(qdir)
        stop = threading.Event()

        def loop():
            w = wk.FileWorker(qdir, poll_interval=0.02)
            while not stop.is_set():
                try:
                    w.run_one(reserve_timeout=0.5)
                except wk.ReserveTimeout:
                    continue
                except Exception:
                    # a failed trial is recorded in its doc; the worker
                    # lives on, as run_workers' do, so fmin cannot wait
                    # on a queue nobody serves
                    time.sleep(0.05)

        threads = [threading.Thread(target=loop, daemon=True) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            it = P.FMinIter(_recording(algo, calls), P.base.Domain(quad_objective, _space(P)),
                            trials, rstate=np.random.default_rng(4), max_evals=10,
                            show_progressbar=False, max_speculation=0,
                            poll_interval_secs=0.02)
            it.exhaust()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
        return calls, it, trials

    mine, it, trials = run(T, tft, tworker, CPU_RAND, str(tmp_path / "port"))
    ref, _, _ = run(J, jft, jworker, J.rand.suggest, str(tmp_path / "jax"))
    assert mine == ref
    assert [ids for ids, _ in mine] == [[t] for t in range(10)]
    assert it._engine is None and it.speculation_stats.n_dispatched == 0
    assert all(t["state"] == JOB_STATE_DONE for t in trials.trials)


# ---------------------------------------------------------------------
# isolation from the JAX package's process-wide hooks
# ---------------------------------------------------------------------


class _Hook:
    """A storage-stats hook that records every call made on it."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a, **kw: self.calls.append(name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_store_ignores_the_jax_packages_chaos_and_store_hook(tmp_path, backend):
    """With the JAX package's chaos monkey active (a torn lock at every
    insert) and its ``StoreStats`` hook installed, the port's store
    neither tears nor reports: both lookups name the port's own modules.
    The port's own monkey and hook, with the same settings, do act."""
    cfg = dict(seed=0, p_torn_lock=1.0)
    jhook, thook = _Hook(), _Hook()
    jft.set_store_stats(jhook)
    try:
        with jchaos.active(jchaos.ChaosMonkey(jchaos.ChaosConfig(**cfg))):
            trials = FileTrials(str(tmp_path / "a"), backend=backend)
            _write_port_docs(trials)
            trials.refresh()
    finally:
        jft.set_store_stats(None)
    assert jhook.calls == []
    assert trials.jobs.locked_tids() == []
    assert trials.jobs.count_states()[JOB_STATE_NEW] == 3
    tft.set_store_stats(thook)
    try:
        with tchaos.active(tchaos.ChaosMonkey(tchaos.ChaosConfig(**cfg))):
            trials = FileTrials(str(tmp_path / "b"), backend=backend)
            _write_port_docs(trials)
    finally:
        tft.set_store_stats(None)
    assert thook.calls
    # one torn lock per insert call: one group commit on the segment
    # log, one per doc on the legacy layout
    assert trials.jobs.locked_tids() == ([0] if backend == "segment" else [0, 1, 2])


def _write_port_docs(trials):
    ids = trials.new_trial_ids(3)
    trials.insert_trial_docs(trials.new_trial_docs(
        ids, [None] * 3, [{"status": "new"} for _ in ids],
        _miscs(ids, np.random.default_rng(0))))


def test_entry_points_import_no_jax():
    """``from hyperopt_tpu_torch import FileTrials, MongoTrials,
    SparkTrials``, the space lint, the telemetry and profiler modules, the
    device recovery and the queue fsck, the optimization service and its
    planes (compile ledger, SLO engine, control), and ``python -m
    hyperopt_tpu_torch.parallel.worker --help`` and ``python -m
    hyperopt_tpu_torch.service --help`` import neither ``jax`` nor
    ``hyperopt_tpu`` (fresh interpreter); the migration stubs point to the
    port's backends."""
    code = (
        "import runpy, sys\n"
        "from hyperopt_tpu_torch import FileTrials, MongoTrials, SparkTrials\n"
        "for stub, hint in ((MongoTrials, 'hyperopt-tpu-torch-worker'),\n"
        "                   (SparkTrials, 'TorchTrials')):\n"
        "    try:\n"
        "        stub()\n"
        "    except NotImplementedError as e:\n"
        "        assert hint in str(e), e\n"
        "from hyperopt_tpu_torch import analysis, observability, profiling\n"
        "from hyperopt_tpu_torch.resilience import DeviceRecovery, fsck_queue\n"
        "from hyperopt_tpu_torch.resilience import CircuitBreaker, fsck_service_root\n"
        "from hyperopt_tpu_torch.service import OptimizationService, ServiceClient\n"
        "from hyperopt_tpu_torch import compile_ledger, control, slo\n"
        "sys.argv = ['hyperopt-tpu-torch-worker', '--help']\n"
        "try:\n"
        "    runpy.run_module('hyperopt_tpu_torch.parallel.worker', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "sys.argv = ['hyperopt-tpu-torch-service', '--help']\n"
        "try:\n"
        "    runpy.run_module('hyperopt_tpu_torch.service', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'hyperopt_tpu' or m.startswith('hyperopt_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "--queue" in out.stdout and out.stdout.strip().endswith("clean")
    assert "--device" in out.stdout and "--root" in out.stdout
