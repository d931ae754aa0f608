"""TorchTrials: batched asynchronous trial execution.

Reference parity (SURVEY.md §2 #18): ``hyperopt/spark.py`` —
``SparkTrials(Trials)`` (`parallelism`, `timeout`, `loss_threshold`,
concurrency cap ~L30-200) and ``_SparkFMinState`` (driver-side dispatcher,
per-trial tasks, job cancellation on timeout → ``JOB_STATE_CANCEL``,
``_begin/_finish_trial_run`` ~L200-600).

Port of ``hyperopt_tpu/parallel/jax_trials.py`` (``JaxTrials``), with two
execution planes —
- **host plane** (arbitrary Python objectives): a thread-pool dispatcher
  claims JOB_STATE_NEW docs, runs ``domain.evaluate`` concurrently, and
  enforces per-trial timeouts by cancel-marking (the Spark job-group
  cancel analog);
- **device plane** (objectives written in torch): pass ``device_fn=``, a
  function of one configuration given as a dict of 0-d tensors; a whole
  claimed batch is evaluated as ONE ``torch.func.vmap(device_fn)`` call on
  the card, on the dispatcher thread's own CUDA stream (never the suggest
  stream of :mod:`hyperopt_tpu_torch.device`).  With ``mesh=`` the batch
  is padded to the mesh's ``dp`` extent and split over its ``dp`` rows,
  one vmapped call per row on its slot's stream
  (:func:`hyperopt_tpu_torch.parallel.sharding.make_sharded_batch_eval`).

``fmin`` drives both through the same asynchronous enqueue/poll loop it
uses for every async backend; the queue is kept ``parallelism`` deep, so a
suggest algorithm receives up to ``parallelism`` ids per call.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from timeit import default_timer as timer

import numpy as np
import torch

from ..base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_OK,
    Ctrl,
    Domain,
    Trials,
    spec_from_misc,
    validate_loss_threshold,
    validate_timeout,
)
from ..observability import FaultStats
from .sharding import resolve_mesh_device
from ..utils import coarse_utcnow

logger = logging.getLogger(__name__)

MAX_CONCURRENT_JOBS_ALLOWED = 128


class TorchTrials(Trials):
    """Trials store executing trials in parallel on the local host and card.

    Drop-in ``Trials`` subclass (the plugin boundary): pass to
    ``fmin(trials=TorchTrials(parallelism=8))``.  ``device_batches`` and
    ``host_trials`` count the device-plane batches and the trials run on
    host threads.
    """

    asynchronous = True
    poll_interval_secs = 0.02  # in-process dispatcher: poll fast

    def __init__(
        self,
        parallelism=None,
        timeout=None,
        loss_threshold=None,
        trial_timeout=None,
        device_fn=None,
        mesh=None,
        exp_key=None,
        refresh=True,
        max_speculation=None,
        device=None,
    ):
        """``timeout`` is the whole-run budget (SparkTrials semantics: it
        bounds ``fmin``, not a single trial); ``trial_timeout`` is the
        per-trial cancellation limit (timeout → ``JOB_STATE_CANCEL``).
        They are independent knobs.

        ``device``: where the device plane evaluates (None: the CUDA card;
        ``"cpu"`` as the tests do).  ``parallelism=None`` is the number of
        cards (at least 1) on CUDA and 1 on the CPU.  ``mesh`` (a
        ``parallel.sharding.DeviceMesh`` or a spec, as ``tpe.suggest``
        takes): ``device_fn``'s batches split over its ``dp`` rows, and
        ``device`` is its lead slot; a degenerate mesh is no mesh.

        ``max_speculation``: staleness depth of the pipelined suggest
        engine (see :func:`hyperopt_tpu_torch.fmin.fmin`).  In this backend
        the engine prefetches the next suggestion(s) while the
        dispatcher's workers (or the device batch) evaluate."""
        super().__init__(exp_key=exp_key, refresh=refresh)
        self.mesh, device = resolve_mesh_device(mesh, device)
        validate_timeout(timeout)
        validate_timeout(trial_timeout)
        validate_loss_threshold(loss_threshold)
        self.device = device
        if parallelism is None:
            parallelism = (max(1, torch.cuda.device_count())
                           if self.device.type == "cuda" else 1)
        if parallelism > MAX_CONCURRENT_JOBS_ALLOWED:
            logger.warning(
                "parallelism %d capped at %d", parallelism, MAX_CONCURRENT_JOBS_ALLOWED
            )
            parallelism = MAX_CONCURRENT_JOBS_ALLOWED
        self.parallelism = parallelism
        self.timeout = timeout
        self.trial_timeout = trial_timeout
        self.loss_threshold = loss_threshold
        self.device_fn = device_fn
        self.max_speculation = max_speculation
        self.device_batches = 0
        self.host_trials = 0
        self._fmin_state = None

    def fmin(
        self,
        fn,
        space,
        algo=None,
        max_evals=None,
        timeout=None,
        loss_threshold=None,
        max_queue_len=None,
        rstate=None,
        verbose=False,
        pass_expr_memo_ctrl=None,
        catch_eval_exceptions=False,
        return_argmin=True,
        show_progressbar=True,
        early_stop_fn=None,
        trials_save_file="",
        points_to_evaluate=None,
        max_speculation=None,
        retry_policy=None,
        fault_stats=None,
        search_stats=None,
    ):
        from ..fmin import fmin as _fmin

        assert (
            not pass_expr_memo_ctrl
        ), "TorchTrials executes objectives outside the driver; plain configs only"
        timeout = timeout if timeout is not None else self.timeout
        loss_threshold = (
            loss_threshold if loss_threshold is not None else self.loss_threshold
        )
        if retry_policy is not None and fault_stats is None:
            # one FaultStats shared by the dispatcher threads and the
            # driver, so retry and quarantine counts land in one place
            fault_stats = FaultStats()
        state = _TorchFMinState(
            fn,
            space,
            self,
            parallelism=self.parallelism,
            trial_timeout=self.trial_timeout,
            device_fn=self.device_fn,
            device=self.device,
            mesh=self.mesh,
            retry_policy=retry_policy,
            fault_stats=fault_stats,
        )
        self._fmin_state = state
        state.start()
        try:
            return _fmin(
                fn,
                space,
                algo=algo,
                max_evals=max_evals,
                timeout=timeout,
                loss_threshold=loss_threshold,
                trials=self,
                rstate=rstate,
                verbose=verbose,
                # the queue must stay at least `parallelism` deep or the
                # dispatcher starves (top-level fmin defaults this to 1)
                max_queue_len=max(max_queue_len or 1, self.parallelism),
                allow_trials_fmin=False,
                pass_expr_memo_ctrl=pass_expr_memo_ctrl,
                catch_eval_exceptions=catch_eval_exceptions,
                return_argmin=return_argmin,
                show_progressbar=show_progressbar,
                early_stop_fn=early_stop_fn,
                trials_save_file=trials_save_file,
                points_to_evaluate=points_to_evaluate,
                max_speculation=(
                    max_speculation
                    if max_speculation is not None
                    else self.max_speculation
                ),
                retry_policy=retry_policy,
                fault_stats=fault_stats,
                search_stats=search_stats,
            )
        finally:
            state.stop()
            self._fmin_state = None


class _TorchFMinState:
    """Driver-side dispatcher: claims NEW trials, runs them concurrently."""

    POLL_SECS = 0.05

    def __init__(
        self,
        fn,
        space,
        trials,
        parallelism,
        trial_timeout=None,
        device_fn=None,
        device=None,
        retry_policy=None,
        fault_stats=None,
        mesh=None,
    ):
        self.trials = trials
        self.domain = Domain(fn, space)
        self.parallelism = parallelism
        self.trial_timeout = trial_timeout
        # the host plane's retry policy (backoff, per-attempt watchdog,
        # quarantine); the device plane's batch keeps its own path
        self.retry_policy = retry_policy
        self.fault_stats = fault_stats
        self.device = device
        self.mesh = mesh
        self._device_eval = None
        if device_fn is not None:
            if mesh is not None:
                from .sharding import make_sharded_batch_eval

                self._device_eval = make_sharded_batch_eval(mesh, device_fn)
            else:
                self._device_eval = torch.func.vmap(device_fn)
        self._stop = threading.Event()
        self._thread = None
        self._pool = None
        # Guards every multi-field trial-doc mutation from worker threads
        # AND the dispatcher's scan of the shared trial-doc list.
        # Invariant the driver's refresh() relies on: a trial whose state
        # reads DONE always already has its result written — so result is
        # assigned before state inside the locked region, and the driver
        # (reading under the GIL) can never observe DONE-without-result.
        self._mutate_lock = threading.Lock()

    # guarded-by: trials._dynamic_trials: _mutate_lock

    # -- lifecycle -----------------------------------------------------
    def start(self):
        self._pool = ThreadPoolExecutor(max_workers=self.parallelism)
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)

    # -- dispatch ------------------------------------------------------
    def _claim_new(self):
        claimed = []
        with self._mutate_lock:
            for trial in self.trials._dynamic_trials:
                if trial["state"] == JOB_STATE_NEW:
                    now = coarse_utcnow()
                    trial["book_time"] = now
                    trial["refresh_time"] = now
                    trial["owner"] = "torch_trials"
                    trial["state"] = JOB_STATE_RUNNING
                    claimed.append(trial)
        return claimed

    def _dispatch_loop(self):
        # the device plane's own stream: its batches never queue behind
        # (or in front of) the suggests on the port's suggest stream
        stream = (torch.cuda.Stream(device=self.device)
                  if self._device_eval is not None and self.device.type == "cuda"
                  else None)
        while not self._stop.is_set():
            claimed = self._claim_new()
            if claimed:
                if self._device_eval is not None:
                    if stream is None:
                        self._run_batch_on_device(claimed)
                    else:
                        with torch.cuda.stream(stream):
                            self._run_batch_on_device(claimed)
                else:
                    self._submit_to_host(claimed)
            time.sleep(self.POLL_SECS)

    def _submit_to_host(self, trials_batch):
        self.trials.host_trials += len(trials_batch)
        for trial in trials_batch:
            self._pool.submit(self._run_one, trial)

    # -- host plane ----------------------------------------------------
    def _evaluate(self, spec, ctrl, trial):
        """One objective call, under the retry policy when one is set;
        exhaustion raises ``TrialQuarantined``, which :meth:`_run_one`
        lands as JOB_STATE_ERROR while the run goes on."""
        if self.retry_policy is None:
            return self.domain.evaluate(spec, ctrl)
        # lazy: resilience.retry imports this package (via file_trials)
        from ..resilience.retry import execute_with_retry

        result, attempts = execute_with_retry(
            lambda: self.domain.evaluate(spec, ctrl),
            self.retry_policy,
            key=trial["tid"],
            stats=self.fault_stats,
        )
        with self._mutate_lock:
            trial["misc"]["attempts"] = attempts
        return result

    def _run_one(self, trial):
        spec = spec_from_misc(trial["misc"])
        ctrl = Ctrl(self.trials, current_trial=trial)
        start = timer()
        try:
            if self.trial_timeout is not None:
                result_box = {}

                def target():
                    try:
                        result_box["result"] = self._evaluate(spec, ctrl, trial)
                    except BaseException as e:  # propagated below
                        result_box["error"] = e

                t = threading.Thread(target=target, daemon=True)
                t.start()
                t.join(self.trial_timeout)
                if t.is_alive():
                    with self._mutate_lock:
                        trial["refresh_time"] = coarse_utcnow()
                        trial["state"] = JOB_STATE_CANCEL
                    logger.warning(
                        "trial %s cancelled after %.1fs timeout",
                        trial["tid"],
                        self.trial_timeout,
                    )
                    return
                if "error" in result_box:
                    raise result_box["error"]
                result = result_box["result"]
            else:
                result = self._evaluate(spec, ctrl, trial)
        except Exception as e:
            logger.error("trial %s exception: %s", trial["tid"], e)
            with self._mutate_lock:
                trial["misc"]["error"] = (str(type(e)), str(e))
                trial["refresh_time"] = coarse_utcnow()
                trial["state"] = JOB_STATE_ERROR
            return
        with self._mutate_lock:
            trial["result"] = result
            trial["refresh_time"] = coarse_utcnow()
            trial["state"] = JOB_STATE_DONE
        logger.debug("trial %s done in %.3fs", trial["tid"], timer() - start)

    # -- device plane --------------------------------------------------
    def _run_batch_on_device(self, trials_batch):
        """One vmapped call of ``device_fn`` over the batch: a ``[B]``
        tensor per label on ``device`` (int64 for integer-valued labels,
        float32 otherwise), the losses read back once.  Under a mesh the
        batch is padded to a multiple of its ``dp`` extent with copies of
        the last configuration, whose losses are dropped."""
        specs = [spec_from_misc(t["misc"]) for t in trials_batch]
        labels = sorted({k for s in specs for k in s})
        if any(set(s) != set(labels) for s in specs):
            # conditional spaces have ragged configs; the device plane
            # needs dense configs -> host threads
            self._submit_to_host(trials_batch)
            return
        self.trials.device_batches += 1
        space_specs = self.domain.space.specs
        b = len(specs)
        dp = self.mesh.dp if self.mesh is not None else 1
        padded = specs + [specs[-1]] * (-b % dp)
        try:
            batch = {
                k: torch.tensor(
                    np.asarray([s[k] for s in padded]),
                    dtype=(torch.int64 if space_specs[k].is_integer else torch.float32),
                    device=self.device,
                )
                for k in labels
            }
            losses = self._device_eval(batch).cpu().numpy()[:b]
        except Exception as e:
            logger.error("device batch failed: %s", e)
            with self._mutate_lock:
                for trial in trials_batch:
                    trial["misc"]["error"] = (str(type(e)), str(e))
                    trial["refresh_time"] = coarse_utcnow()
                    trial["state"] = JOB_STATE_ERROR
            return
        now = coarse_utcnow()
        with self._mutate_lock:
            for trial, loss in zip(trials_batch, losses):
                trial["result"] = {"loss": float(loss), "status": STATUS_OK}
                trial["refresh_time"] = now
                trial["state"] = JOB_STATE_DONE
