"""The fmin driver loop.

Reference parity (SURVEY.md §2 #7): ``hyperopt/fmin.py`` —
``fmin_pass_expr_memo_ctrl`` (~L30-60), ``generate_trial``/
``generate_trials_to_calculate`` (~L60-130), ``FMinIter`` (~L130-500),
``fmin`` full signature (~L500-700), ``space_eval`` (~L700-730).

The driver is host-side orchestration by design: suggest runs on the
device, the objective is arbitrary user Python, and this loop shuttles
sparse trial docs between them.  By default (``max_speculation=1``) the
loop is pipelined: while the objective of trial t runs in a worker
thread, the speculative engine (:mod:`hyperopt_tpu_torch.pipeline`)
launches the suggest of trial t+1 on the card; ``max_speculation=0``
keeps the strictly serial loop.  With an asynchronous durable queue
(``FileTrials``) the loop runs a heartbeat-lease reaper for the whole
run and publishes its retry policy to the workers.  Keywords of
``hyperopt_tpu.fmin`` whose subsystems this package does not carry yet
raise ``NotImplementedError`` naming the ROADMAP item instead of being
ignored.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import sys
import threading
import time
from timeit import default_timer as timer

import numpy as np

from . import diagnostics, progress, tracing
from .base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Ctrl,
    Domain,
    Trials,
    loop_refresh,
    spec_from_misc,
    trials_from_docs,
    validate_loss_threshold,
    validate_timeout,
)
from .exceptions import InvalidSpaceError
from .observability import FaultStats, PhaseTimings, SpeculationStats
from .resilience.device import DeviceRecovery
from .resilience.retry import TrialQuarantined, execute_with_retry
from .utils import coarse_utcnow

logger = logging.getLogger(__name__)


def _default_max_speculation():
    """The speculation depth of the pipelined loop when the caller gives
    none: ``HYPEROPT_MAX_SPECULATION``, else 1 (the reference's default,
    ``hyperopt_tpu/fmin.py:54``).  Read at call time."""
    return int(os.environ.get("HYPEROPT_MAX_SPECULATION", "1"))


def fmin_pass_expr_memo_ctrl(f):
    """Decorator: mark ``f`` as wanting (expr, memo, ctrl) instead of a
    sampled point (reference: ``hyperopt/fmin.py — fmin_pass_expr_memo_ctrl``)."""
    f.fmin_pass_expr_memo_ctrl = True
    return f


def generate_trial(tid, space):
    """Build one warm-start trial document from a {label: value} point."""
    variables = space.keys()
    idxs = {v: [tid] for v in variables}
    vals = {v: [space[v]] for v in variables}
    return {
        "state": JOB_STATE_NEW,
        "tid": tid,
        "spec": None,
        "result": {"status": "new"},
        "misc": {
            "tid": tid,
            "cmd": ("domain_attachment", "FMinIter_Domain"),
            "idxs": idxs,
            "vals": vals,
        },
        "exp_key": None,
        "owner": None,
        "version": 0,
        "book_time": None,
        "refresh_time": None,
    }


def generate_trials_to_calculate(points):
    """Trials pre-loaded with explicit points (``points_to_evaluate``)."""
    return trials_from_docs(
        [generate_trial(tid, x) for tid, x in enumerate(points)]
    )


@contextlib.contextmanager
def _traced_iteration(tracer, n_trials):
    """One loop iteration as one trace: bound to this thread under the root
    span ``fmin.trial``, handed to ``tracer`` as the iteration ends."""
    trace = tracer.begin()
    try:
        with tracing.use_trace(trace), tracing.span("fmin.trial", n_trials=n_trials):
            yield
    finally:
        tracer.finish(trace)


class FMinIter:
    """The suggest → evaluate → refresh loop, sync or async."""

    catch_eval_exceptions = False
    pickle_protocol = -1
    is_cancelled = False

    def __init__(
        self,
        algo,
        domain,
        trials,
        rstate,
        asynchronous=None,
        max_queue_len=1,
        poll_interval_secs=None,
        max_evals=sys.maxsize,
        timeout=None,
        loss_threshold=None,
        verbose=False,
        show_progressbar=True,
        early_stop_fn=None,
        trials_save_file="",
        orbax_ckpt=None,
        max_speculation=None,
        retry_policy=None,
        fault_stats=None,
        search_stats=None,
        tracer=None,
    ):
        self.algo = algo
        # a tracing.Tracer: each loop iteration becomes one trace
        # (_traced_iteration); None binds nothing
        self.tracer = tracer
        self.domain = domain
        self.trials = trials
        self.retry_policy = retry_policy
        if max_speculation is None:
            max_speculation = _default_max_speculation()
        self.max_speculation = max_speculation
        self.timings = PhaseTimings()
        self.speculation_stats = SpeculationStats()
        self.fault_stats = fault_stats if fault_stats is not None else FaultStats()
        # wraps every suggest dispatch: a CUDA error (out of memory, a
        # failed launch or readback) triggers a bounded re-initialization
        # of the device state and a retry, then propagates; never a CPU
        # fallback (see hyperopt_tpu_torch.resilience.device)
        self.device_recovery = DeviceRecovery(stats=self.fault_stats)
        self._engine = None
        if asynchronous is None:
            self.asynchronous = trials.asynchronous
        else:
            self.asynchronous = asynchronous
        if poll_interval_secs is None:
            poll_interval_secs = getattr(trials, "poll_interval_secs", 1.0)
        self.poll_interval_secs = poll_interval_secs
        self.max_queue_len = max_queue_len
        self.max_evals = max_evals
        self.timeout = timeout
        self.loss_threshold = loss_threshold
        self.start_time = timer()
        self.rstate = rstate
        self.verbose = verbose
        self.show_progressbar = show_progressbar
        self.early_stop_fn = early_stop_fn
        self.early_stop_args = []
        self.trials_save_file = trials_save_file
        self._orbax_ckpt = orbax_ckpt
        if orbax_ckpt is None and trials_save_file != "":
            from .checkpoint import TrialsCheckpointer, is_orbax_path

            if is_orbax_path(trials_save_file):
                # a directly-constructed FMinIter owns its own checkpointer
                self._orbax_ckpt = TrialsCheckpointer(trials_save_file)
        if search_stats is None:
            # a partial-as-config algo (partial(tpe.suggest,
            # n_startup_jobs=...)) declares its startup horizon in its
            # keywords; other algos get the TPE default
            n_startup = getattr(algo, "keywords", None) or {}
            search_stats = diagnostics.SearchStats(
                n_startup_jobs=int(n_startup.get("n_startup_jobs", 20)),
                fault_stats=self.fault_stats,
            )
        self.search_stats = search_stats

        if self.asynchronous:
            self._publish_retry_policy()
            if "FMinIter_Domain" not in trials.attachments:
                # out-of-process workers unpickle the domain from this
                # attachment; in-process backends (TorchTrials) don't
                # need it, so unpicklable objectives are fine there
                try:
                    trials.attachments["FMinIter_Domain"] = pickle.dumps(domain)
                except (pickle.PicklingError, AttributeError, TypeError) as e:
                    logger.info(
                        "domain not picklable (%s); out-of-process workers "
                        "will not be able to fetch it",
                        e,
                    )

    def _publish_retry_policy(self):
        """Publish the run's retry policy to out-of-process workers (the
        ``FMinIter_RetryPolicy`` attachment) and adopt its lease TTL on
        this queue handle, or clear a previous run's attachment when the
        run has none.  Reference: ``hyperopt_tpu/fmin.py:185-211``."""
        trials = self.trials
        if self.retry_policy is not None:
            # workers inherit backoff, timeouts, lease TTL and the
            # attempt budget through this attachment
            try:
                trials.attachments["FMinIter_RetryPolicy"] = self.retry_policy.to_json()
            except Exception:
                logger.info(
                    "could not persist retry policy attachment; "
                    "workers fall back to their own defaults",
                    exc_info=True,
                )
            if getattr(trials, "jobs", None) is not None:
                # the policy's lease_ttl IS the run's lease TTL: the
                # reaper's expiry clock and stale-lock aging must agree
                # with the leases workers grant under the same policy
                trials.jobs.lease_ttl = self.retry_policy.lease_ttl
        else:
            # a resumed run without a policy must not leave workers
            # obeying a previous run's attachment
            try:
                del trials.attachments["FMinIter_RetryPolicy"]
            except KeyError:
                pass
            except Exception:
                logger.info("could not clear stale retry policy attachment", exc_info=True)

    def _evaluate_trial(self, spec, ctrl, trial):
        """One objective evaluation under the run's retry policy (when
        set): backoff and deterministic jitter between attempts, the
        per-trial watchdog, and :class:`~hyperopt_tpu_torch.resilience.
        retry.TrialQuarantined` after ``max_attempts``, which the callers
        turn into ``JOB_STATE_ERROR`` while the run goes on.  Reference:
        ``hyperopt_tpu/fmin.py:229-248``."""
        with tracing.span("fmin.objective", tid=trial["tid"]):
            if self.retry_policy is None:
                return self.domain.evaluate(spec, ctrl)
            result, attempts = execute_with_retry(
                lambda: self.domain.evaluate(spec, ctrl),
                self.retry_policy,
                key=trial["tid"],
                stats=self.fault_stats,
            )
        trial["misc"]["attempts"] = attempts
        return result

    @staticmethod
    def _quarantine(trial, e):
        """Record a trial whose retry budget ran out: error state (which
        the TPE fit excludes) with its attempts and last error."""
        logger.error("trial %s quarantined: %s", trial["tid"], e)
        trial["state"] = JOB_STATE_ERROR
        trial["misc"]["attempts"] = e.attempts
        trial["misc"]["error"] = (str(type(e.last_error)), str(e.last_error))
        trial["refresh_time"] = coarse_utcnow()

    def serial_evaluate(self, N=-1):
        for trial in self.trials._dynamic_trials:
            if trial["state"] == JOB_STATE_NEW:
                trial["state"] = JOB_STATE_RUNNING
                now = coarse_utcnow()
                trial["book_time"] = now
                trial["refresh_time"] = now
                spec = spec_from_misc(trial["misc"])
                ctrl = Ctrl(self.trials, current_trial=trial)
                try:
                    result = self._evaluate_trial(spec, ctrl, trial)
                except TrialQuarantined as e:
                    # the retry budget is spent: quarantine, keep the run
                    self._quarantine(trial, e)
                except Exception as e:
                    logger.error("job exception: %s", str(e))
                    trial["state"] = JOB_STATE_ERROR
                    trial["misc"]["error"] = (str(type(e)), str(e))
                    trial["refresh_time"] = coarse_utcnow()
                    if not self.catch_eval_exceptions:
                        raise
                else:
                    trial["state"] = JOB_STATE_DONE
                    trial["result"] = result
                    trial["refresh_time"] = coarse_utcnow()
                N -= 1
                if N == 0:
                    break
        self._refresh()

    def _serial_evaluate_pipelined(self, engine, budget):
        """serial_evaluate with suggest/evaluate overlap: the objective of
        each NEW trial runs in a short-lived daemon worker thread while
        this (main) thread speculatively launches the suggest(s) of the
        next trial(s) through ``engine`` (at most ``budget`` more
        suggestions will be consumed this run, so speculation is capped
        there too).  Doc mutations mirror serial_evaluate exactly; on an
        objective exception the pending speculations are discarded and the
        exception propagates unless ``catch_eval_exceptions``.  The worker
        is a daemon and the main thread's join is signal-interruptible, so
        Ctrl-C still aborts fmin mid-objective.  Reference:
        ``hyperopt_tpu/fmin.py:291-380``."""
        # the iteration's trace (None untraced) follows the objective into
        # its worker, under the iteration's root span
        trace = tracing.current_trace()
        root = trace.root if trace is not None else None
        for trial in self.trials._dynamic_trials:
            if trial["state"] != JOB_STATE_NEW:
                continue
            trial["state"] = JOB_STATE_RUNNING
            now = coarse_utcnow()
            trial["book_time"] = now
            trial["refresh_time"] = now
            spec = spec_from_misc(trial["misc"])
            ctrl = Ctrl(self.trials, current_trial=trial)
            box = {}

            def _evaluate(spec=spec, ctrl=ctrl, box=box, trial=trial):
                try:
                    with tracing.use_trace(trace, parent=root):
                        box["result"] = self._evaluate_trial(spec, ctrl, trial)
                except BaseException as e:
                    box["error"] = e

            worker = threading.Thread(target=_evaluate, name="hyperopt-eval", daemon=True)
            worker.start()
            try:
                try:
                    # overlap window: launch speculative suggests while the
                    # objective runs; the card computes in the background
                    engine.speculate(limit=budget)
                except Exception as spec_err:
                    # speculation is an optimization: a failed launch must
                    # not discard the objective's result or leave the
                    # trial RUNNING; drop the speculations and go on
                    # serially.  A device error also re-initializes the
                    # device state through the recovery (else the
                    # synchronous recompute meets the same failure)
                    logger.exception("speculative dispatch failed; continuing serially")
                    self.device_recovery.absorb(spec_err)
                    engine.discard()
            finally:
                # even a non-Exception failure must not abandon the trial
                with tracing.span("pipeline.join"):
                    worker.join()
            if "error" in box:
                e = box["error"]
                if not isinstance(e, Exception):
                    # BaseException (SystemExit, ...): serial_evaluate would
                    # not catch it either
                    engine.discard()
                    raise e
                if isinstance(e, TrialQuarantined):
                    # the pending speculations hypothesized this trial
                    # landing above; the validity check re-issues them
                    # against the error outcome
                    self._quarantine(trial, e)
                    continue
                logger.error("job exception: %s", str(e))
                trial["state"] = JOB_STATE_ERROR
                trial["misc"]["error"] = (str(type(e)), str(e))
                trial["refresh_time"] = coarse_utcnow()
                if not self.catch_eval_exceptions:
                    engine.discard()
                    self._refresh()
                    raise e
            else:
                trial["state"] = JOB_STATE_DONE
                trial["result"] = box["result"]
                trial["refresh_time"] = coarse_utcnow()
        self._refresh()

    def _refresh(self):
        """A refresh point of the loop: :func:`~hyperopt_tpu_torch.base.
        loop_refresh`, which folds only what the loop changed since the
        last refresh; the full walk where the objective is handed the store
        (``pass_expr_memo_ctrl``) and may edit any document."""
        if getattr(self.domain, "pass_expr_memo_ctrl", False):
            self.trials.refresh()
        else:
            loop_refresh(self.trials)

    def block_until_done(self):
        already_printed = False
        if self.asynchronous:
            unfinished_states = [JOB_STATE_NEW, JOB_STATE_RUNNING]

            def get_queue_len():
                return self.trials.count_by_state_unsynced(unfinished_states)

            qlen = get_queue_len()
            while qlen > 0:
                if not already_printed and self.verbose:
                    logger.info("Waiting for %d jobs to finish ...", qlen)
                    already_printed = True
                time.sleep(self.poll_interval_secs)
                qlen = get_queue_len()
            self.trials.refresh()
        else:
            self.serial_evaluate()

    def run(self, N, block_until_done=True):
        """Enqueue and run up to ``N`` new trials.

        Between its first refresh and its closing ones the run refreshes
        incrementally (:func:`~hyperopt_tpu_torch.base.loop_refresh`) and
        reads its state counts and best loss from the refreshes' tallies:
        a completed trial that a callback (``early_stop_fn``) edits in
        place reaches the history, the counts and the best loss at the
        closing refresh, not mid-run."""
        trials = self.trials
        algo = self.algo
        n_queued = 0
        if isinstance(trials, Trials):
            # the run's first refresh walks every document, so edits made
            # to the store between runs are seen
            trials._refresh_mark = None

        # the counts and the best loss come from the last refresh's
        # tallies in O(1) where they hold (every read below follows one of
        # the loop's refreshes), else from a walk over every document
        def get_queue_len():
            return self.trials.count_by_state_tallied(JOB_STATE_NEW)

        def get_n_done():
            return self.trials.count_by_state_tallied(JOB_STATE_DONE)

        def get_n_unfinished():
            unfinished_states = [JOB_STATE_NEW, JOB_STATE_RUNNING]
            return self.trials.count_by_state_tallied(unfinished_states)

        def n_walked():
            # the documents a read walks: none where the tallies serve it
            trials = self.trials
            return 0 if trials._tallies() is not None else len(trials._dynamic_trials)

        # the speculative engine (max_speculation > 0) overlaps the suggest
        # on the card with the objective; k=0 keeps the strictly serial
        # path below.  In the synchronous loop it engages only at queue
        # length 1 (the default): a wider queue enqueues several ids
        # through ONE algo call with ONE seed, which a 1-id speculation
        # plus an (n-1)-id sync call would re-seed.  The asynchronous
        # plane has no serial trajectory to keep and always prefetches.
        # Ctrl-receiving objectives (pass_expr_memo_ctrl) may mutate the
        # trials store from the worker while this thread speculates
        # against it: those keep the serial loop.
        engine = None
        use_engine = (
            self.max_speculation
            and self.max_speculation > 0
            and (self.asynchronous or self.max_queue_len == 1)
            and not getattr(self.domain, "pass_expr_memo_ctrl", False)
        )
        if use_engine:
            from .pipeline import SpeculativeSuggestEngine

            if self._engine is None:
                self._engine = SpeculativeSuggestEngine(
                    algo, self.domain, trials, self.rstate,
                    max_speculation=self.max_speculation,
                    stats=self.speculation_stats,
                    device_recovery=self.device_recovery,
                )
            engine = self._engine
            if engine.policy == "strict":
                # no declared policy: the engine never speculates, so skip
                # the worker thread too and keep the serial loop
                engine = None

        stopped = False
        initial_n_done = get_n_done()
        progress_callback = (
            progress.default_callback
            if self.show_progressbar
            else progress.no_progress_callback
        )
        with contextlib.ExitStack() as _stack:
            if engine is not None:
                # on every exit path, drop speculations nothing will read
                _stack.callback(engine.discard)
            if self.asynchronous and getattr(self.trials, "jobs", None) is not None:
                # durable queue (FileTrials): reclaim dead workers'
                # trials and clear torn or stale locks while the run
                # lasts.  Reference: hyperopt_tpu/fmin.py:475-487
                from .resilience.leases import LeaseReaper

                _stack.enter_context(
                    LeaseReaper(self.trials, policy=self.retry_policy, stats=self.fault_stats)
                )
            progress_ctx = _stack.enter_context(
                progress_callback(initial=0, total=N)
            )
            all_trials_complete = False
            best_loss = float("inf")
            n_displayed = 0
            while (
                # more trials to enqueue, or
                n_queued < N
                # block until all queued trials finish
                or (block_until_done and not all_trials_complete)
            ):
                # without a tracer the shared no-op span: nothing is bound
                with (tracing.NULL_SPAN if self.tracer is None
                      else _traced_iteration(self.tracer, len(self.trials))):
                    qlen = get_queue_len()
                    while (
                        qlen < self.max_queue_len and n_queued < N and not self.is_cancelled
                    ):
                        n_to_enqueue = min(self.max_queue_len - qlen, N - n_queued)
                        if engine is not None:
                            # a validated speculation when one is pending
                            # (readback only), else computed in line
                            with self.timings.phase("suggest", span="fmin.suggest") as sp:
                                sp.set_attr("path", "speculated")
                                new_trials, new_ids = engine.next_batch(n_to_enqueue)
                        else:
                            new_ids = trials.new_trial_ids(n_to_enqueue)
                            self._refresh()
                            seed = self.rstate.integers(2 ** 31 - 1)
                            with self.timings.phase("suggest", span="fmin.suggest") as sp:
                                sp.set_attr("path", "sync")
                                # a CUDA error re-initializes and retries
                                # (bounded) rather than abort the run
                                new_trials = self.device_recovery.run(
                                    lambda: algo(new_ids, self.domain, trials, seed)
                                )
                        # the suggest's search-health snapshot (None for
                        # random/startup suggests), published on this thread
                        with tracing.span("fmin.health"):
                            self.search_stats.record_suggest(diagnostics.last_suggest_diag())
                        if new_trials is None:
                            stopped = True
                            break
                        assert len(new_ids) >= len(new_trials)
                        if len(new_trials):
                            with tracing.span("fmin.insert", n_docs=len(new_trials)):
                                self.trials.insert_trial_docs(new_trials)
                                self._refresh()
                            n_queued += len(new_trials)
                            qlen = get_queue_len()
                        else:
                            stopped = True
                            break

                    if self.is_cancelled:
                        break

                    if self.asynchronous:
                        if engine is not None:
                            try:
                                # prefetch the next suggestion(s) while the
                                # backend's workers evaluate
                                engine.speculate(limit=N - n_queued)
                            except Exception as spec_err:
                                logger.exception(
                                    "speculative dispatch failed; continuing "
                                    "without prefetch"
                                )
                                self.device_recovery.absorb(spec_err)
                                engine.discard()
                        # wait for workers to fill in the trials
                        time.sleep(self.poll_interval_secs)
                    else:
                        # run the trials synchronously in this process
                        with self.timings.phase("evaluate", span="fmin.evaluate"):
                            if engine is not None:
                                self._serial_evaluate_pipelined(engine, budget=N - n_queued)
                            else:
                                self.serial_evaluate()

                    self._refresh()
                    # this round's completions (OK losses, NaN included, and
                    # the error count) into the run's search health
                    with tracing.span("fmin.health") as sp:
                        sp.set_attr("n_walked", n_walked())
                        self.search_stats.observe_trials(self.trials)
                    if self.trials_save_file != "":
                        if self._orbax_ckpt is not None:
                            with tracing.span("fmin.checkpoint", kind="orbax"):
                                self._orbax_ckpt.save(self.trials)
                        else:
                            # fsync'd write-then-rename: a crash mid-save never
                            # tears the checkpoint the next run resumes from
                            from .checkpoint import atomic_pickle_dump

                            with tracing.span("fmin.checkpoint", kind="pickle"):
                                atomic_pickle_dump(
                                    self.trials,
                                    self.trials_save_file,
                                    protocol=self.pickle_protocol,
                                )
                    if self.early_stop_fn is not None:
                        with tracing.span("fmin.early_stop"):
                            stop, kwargs = self.early_stop_fn(
                                self.trials, *self.early_stop_args
                            )
                        self.early_stop_args = kwargs
                        if stop:
                            logger.info(
                                "Early stop triggered from %s", self.early_stop_fn.__name__
                            )
                            stopped = True

                    # the iteration's state counts, progress and best loss
                    with tracing.span("fmin.scan", n_docs=len(self.trials)) as sp:
                        sp.set_attr("n_walked", n_walked())
                        n_unfinished = get_n_unfinished()
                        if n_unfinished == 0:
                            all_trials_complete = True

                        n_done = get_n_done()
                        n_okay = n_done - initial_n_done
                        progress_ctx.update(n_okay - n_displayed)
                        n_displayed = n_okay

                        # update progress bar with the best loss so far
                        new_best = self.trials.min_ok_loss()
                        if new_best is not None:
                            if new_best < best_loss:
                                best_loss = new_best
                                progress_ctx.postfix = f"best loss: {best_loss}"
                            if (
                                self.loss_threshold is not None
                                and best_loss <= self.loss_threshold
                            ):
                                stopped = True

                    if self.timeout is not None and (
                        timer() - self.start_time >= self.timeout
                    ):
                        stopped = True

                    if stopped:
                        break

            if block_until_done:
                self.block_until_done()
            self.trials.refresh()
            if self.verbose:
                self.timings.log_summary(logging.DEBUG)
                if engine is not None:
                    self.speculation_stats.log_summary(logging.DEBUG)
                self.fault_stats.log_summary(logging.DEBUG)
            logger.debug("Queue empty, exiting run.")

    def exhaust(self):
        n_done = len(self.trials)
        self.run(self.max_evals - n_done, block_until_done=self.asynchronous)
        self.trials.refresh()
        return self


def fmin(
    fn,
    space,
    algo=None,
    max_evals=None,
    timeout=None,
    loss_threshold=None,
    trials=None,
    rstate=None,
    allow_trials_fmin=True,
    pass_expr_memo_ctrl=None,
    catch_eval_exceptions=False,
    verbose=True,
    return_argmin=True,
    points_to_evaluate=None,
    max_queue_len=1,
    show_progressbar=True,
    early_stop_fn=None,
    trials_save_file="",
    max_speculation=None,
    validate_space=False,
    retry_policy=None,
    fault_stats=None,
    search_stats=None,
    tracer=None,
):
    """Minimize ``fn`` over ``space`` — the reference's full signature.

    ``algo`` defaults to TPE on the CUDA card; pass
    ``partial(tpe.suggest, device="cpu")`` to run on the CPU.
    ``rstate`` (a ``np.random.Generator``) makes the whole run
    deterministic: per-suggest seeds are drawn from it and seed the
    device generators.

    ``search_stats``: a shared
    :class:`~hyperopt_tpu_torch.diagnostics.SearchStats` to accumulate the
    run's search health into (running best, regret curve, fault counts and
    each TPE suggest's EI/Parzen snapshot); by default ``FMinIter`` owns a
    private one, ``FMinIter.search_stats``.

    ``max_speculation``: speculation depth ``k`` of the pipelined loop
    (:mod:`hyperopt_tpu_torch.pipeline`); None reads
    ``HYPEROPT_MAX_SPECULATION``, default 1.  While the objective of trial
    t runs in a worker thread, the suggests of trials t+1..t+k are
    launched on the card's suggest stream.  k=1 reproduces the serial
    trajectory exactly; k=0 is the strictly serial loop.  Algorithms
    without a ``speculation_policy`` keep the serial loop at any k.

    ``retry_policy``: a :class:`hyperopt_tpu_torch.resilience.RetryPolicy`
    for fault-tolerant trial execution: up to ``max_attempts`` executions
    per trial with exponential backoff and deterministic jitter, an
    optional per-trial ``trial_timeout`` watchdog, and quarantine on
    exhaustion (the trial lands in ``JOB_STATE_ERROR``, is excluded from
    the TPE fit, and the run continues).  With ``FileTrials`` the policy
    also configures the lease reaper (which runs with defaults when the
    policy is None) and reaches out-of-process workers through the
    ``FMinIter_RetryPolicy`` queue attachment.

    ``fault_stats``: a shared
    :class:`~hyperopt_tpu_torch.observability.FaultStats` to record
    recovery events into; by default the driver owns a private one,
    ``FMinIter.fault_stats``, which its ``SearchStats`` also reads.

    ``validate_space=True`` runs the static space lint
    (:func:`hyperopt_tpu_torch.analysis.lint_space`) before the first
    trial: error-severity findings (duplicate labels, inverted bounds,
    float32-overflowing log ranges, ...) raise
    :class:`~hyperopt_tpu_torch.exceptions.InvalidSpaceError` before any
    work on the card, instead of a NaN on the card many trials in, and
    warnings are logged.  Off by default, as in the reference.

    A ``trials_save_file`` ending in ``.orbax`` is a directory of
    versioned JSON steps in orbax's layout
    (:class:`~hyperopt_tpu_torch.checkpoint.TrialsCheckpointer`); any
    other ``trials_save_file`` is a pickle checkpoint.  Either way the
    next run resumes from it.

    ``tracer``: a :class:`~hyperopt_tpu_torch.tracing.Tracer`; each loop
    iteration becomes one trace whose spans split the loop's host time
    (suggest, insert, evaluate, refreshes, scans, the pipeline's and the
    suggest's stages), sampled and logged as the tracer says
    (``docs/torch_fmin_spans.md``).  None, the default,
    binds nothing.
    """
    if validate_space:
        from .analysis import Severity, lint_space

        diags = lint_space(space)
        errors = [d for d in diags if d.severity == Severity.ERROR]
        for d in diags:
            if d.severity != Severity.ERROR:
                logger.warning("space lint: %s", d.format())
        if errors:
            raise InvalidSpaceError(
                "search space failed validation:\n"
                + "\n".join(d.format() for d in errors),
                diagnostics=diags,
            )

    if algo is None:
        from .algos import tpe

        algo = tpe.suggest
        logger.warning("fmin: algo not specified, defaulting to TPE")

    validate_timeout(timeout)
    validate_loss_threshold(loss_threshold)

    if rstate is None:
        env_rseed = os.environ.get("HYPEROPT_FMIN_SEED", "")
        if env_rseed:
            rstate = np.random.default_rng(int(env_rseed))
        else:
            rstate = np.random.default_rng()
    if isinstance(rstate, np.random.RandomState):  # legacy numpy API
        rstate = np.random.default_rng(rstate.randint(2 ** 31))

    if max_evals is None:
        max_evals = sys.maxsize

    orbax_ckpt = None
    if trials_save_file != "":
        from .checkpoint import TrialsCheckpointer, is_orbax_path

        if is_orbax_path(trials_save_file):
            # versioned, atomic, retained steps: resume from the newest
            # readable step.  One checkpointer serves the restore and the
            # run's saves (FMinIter); restoring ``into`` a user-passed
            # trials object keeps its subclass and attachments.
            orbax_ckpt = TrialsCheckpointer(trials_save_file)
            restored = orbax_ckpt.restore(into=trials)
            if restored is not None:
                trials = restored
        elif os.path.exists(trials_save_file):
            with open(trials_save_file, "rb") as f:
                trials = pickle.load(f)

    if allow_trials_fmin and trials is not None and hasattr(trials, "fmin"):
        assert not isinstance(trials, list)
        # the re-entered fmin opens its own checkpointer on this directory
        return trials.fmin(
            fn,
            space,
            algo=algo,
            max_evals=max_evals,
            timeout=timeout,
            loss_threshold=loss_threshold,
            max_queue_len=max_queue_len,
            rstate=rstate,
            pass_expr_memo_ctrl=pass_expr_memo_ctrl,
            verbose=verbose,
            catch_eval_exceptions=catch_eval_exceptions,
            return_argmin=return_argmin,
            show_progressbar=show_progressbar,
            early_stop_fn=early_stop_fn,
            trials_save_file=trials_save_file,
            points_to_evaluate=points_to_evaluate,
            max_speculation=max_speculation,
            retry_policy=retry_policy,
            fault_stats=fault_stats,
            search_stats=search_stats,
            tracer=tracer,
        )

    if trials is None:
        if points_to_evaluate is None:
            trials = Trials()
        else:
            assert isinstance(points_to_evaluate, list)
            trials = generate_trials_to_calculate(points_to_evaluate)
    elif points_to_evaluate is not None:
        if len(trials) > 0:
            raise ValueError(
                "points_to_evaluate requires an empty trials object"
            )
        for doc in (generate_trial(tid, x) for tid, x in enumerate(points_to_evaluate)):
            trials.insert_trial_doc(doc)
        trials.refresh()

    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl)

    rval = FMinIter(
        algo,
        domain,
        trials,
        max_evals=max_evals,
        timeout=timeout,
        loss_threshold=loss_threshold,
        rstate=rstate,
        verbose=verbose,
        max_queue_len=max_queue_len,
        show_progressbar=show_progressbar,
        early_stop_fn=early_stop_fn,
        trials_save_file=trials_save_file,
        orbax_ckpt=orbax_ckpt,
        max_speculation=max_speculation,
        retry_policy=retry_policy,
        fault_stats=fault_stats,
        search_stats=search_stats,
        tracer=tracer,
    )
    rval.catch_eval_exceptions = catch_eval_exceptions
    rval.exhaust()

    if return_argmin:
        if len(trials.trials) == 0:
            raise Exception(
                "There are no evaluation tasks, cannot return argmin of task losses."
            )
        return trials.argmin
    return None


def space_eval(space, hp_assignment):
    """Evaluate a search space at the point ``hp_assignment``.

    Inverse of sampling: plugs per-label values into the graph's
    hyperopt_param nodes and evaluates only the active branches (lazy
    switch), yielding the nested structure the objective would have seen.
    """
    from .pyll.base import GarbageCollected, as_apply, dfs, rec_eval

    space = as_apply(space)
    memo = {}
    for node in dfs(space):
        if node.name == "hyperopt_param":
            label = node.pos_args[0].obj
            if label in hp_assignment:
                memo[node] = hp_assignment[label]
            else:
                memo[node] = GarbageCollected
    return rec_eval(space, memo=memo)
