"""Pipelined speculative suggest engine.

Reference parity: ``hyperopt_tpu/pipeline.py``.  A speculative launch or
readback that fails is logged and discarded, the driver's
:class:`~hyperopt_tpu_torch.resilience.device.DeviceRecovery` absorbs the
error (a bounded re-initialization of the device state), and the suggest
is computed again synchronously on the card, under that recovery.

The serial fmin loop adds suggest time and objective time: ``FMinIter``
blocks on the objective for trial *t* before the device program for trial
*t+1* launches.  But TPE's own design point is *asynchronous* evaluation —
the algorithm tolerates suggesting from a history that is missing in-flight
results (Bergstra et al., NeurIPS 2011; Bergstra, Yamins & Cox, ICML 2013) —
so nothing forces those two times to add.

This module exploits that: while the user objective for trial *t* runs (in
a worker thread), the engine **speculatively launches** the whole device
suggest (γ-split → Parzen fit → draw → score → argmax, on the card's
suggest stream) for trials *t+1 … t+k* against the current history, via
the algorithm's ``async_variant`` (non-blocking dispatch,
:func:`tpe.suggest_async`).  The launch is host work on the fmin loop
thread (about two thousand kernel launches from Python per suggest), so
it hides behind an objective only while the objective releases the GIL:
sleeping, I/O, numpy, or torch on the card.  When
trial *t* completes, a cheap host-side check on the loss quantile decides
whether the completed result would have changed the γ-split the speculation
was fit on; only then is the speculation relaunched (same ids, same seed,
fresh history).  ``max_speculation`` bounds the staleness depth *k*;
``k=0`` disables the engine entirely and the fmin loop takes its original
serial path bit-for-bit.

Speculation-validity policies (per suggest algorithm, discovered through a
``speculation_policy`` attribute on the unwrapped function):

- ``"independent"`` (``rand.suggest``): reads nothing from history —
  speculations are always valid.
- ``"tpe_quantile"`` (``tpe.suggest``): **hypothesis-exact branch
  prediction.**  A pending trial's parameter vector *x* is fully known
  while its objective runs; only its loss is not — and the loss enters
  the TPE fit solely through γ-split membership.  So the speculative
  suggest is fit against the hypothetical history in which every
  in-flight trial has completed into the *above* set (its known *x*
  joins g(x) with a worst-case loss; ``n_below`` is computed for the
  grown count; see ``DeviceHistory.hypothetical_append``).  When the
  real result does land above and the below-count is unchanged — the
  overwhelmingly common case, since the below set holds only the best
  ``min(ceil(γ·√N), LF)`` losses — the consumed suggestion equals the
  post-completion serial suggestion **bit-for-bit**.  Otherwise (the
  result ranks inside the below set, the below-count grew, or the trial
  errored out of existence) the speculation is relaunched against the
  now-complete history — also exact.  With ``max_speculation=1`` and a
  deterministic objective, the whole k=1 trajectory therefore
  reproduces the serial trajectory exactly; speculations deeper than
  the in-flight window (k≥2) additionally miss the not-yet-resolved
  intermediate suggestions and are consumed with the classic bounded
  staleness TPE tolerates by design.
- anything else: **strict** — the engine does not speculate at all.
  Every completed trial appends a loss, which would invalidate the
  speculation, so speculative work would be recomputed — and, for an
  algorithm with observable side effects, visibly double-invoke it —
  every single trial.  ``next_batch`` instead computes synchronously
  with the serial loop's exact seed protocol, which makes the engine
  safe to enable for arbitrary suggest algorithms: unknown algorithms
  get the serial trajectory, bit-for-bit.

Determinism: the engine draws exactly one seed from the fmin loop's
``rstate`` per suggest call, in trial order — the same protocol as the
serial loop — and invalidation re-uses the speculation's original seed, so
a fixed ``rstate`` fixes the whole trajectory for any ``k``.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from functools import partial

import numpy as np

from . import tracing
from .base import JOB_STATE_NEW, JOB_STATE_RUNNING, loop_refresh
from .observability import SpeculationStats

logger = logging.getLogger(__name__)

# tpe.suggest defaults, used when the algo partial doesn't override them
# (kept in sync by tests/test_pipeline.py::test_policy_defaults_match_tpe)
_TPE_DEFAULTS = {"gamma": 0.25, "linear_forgetting": 25, "n_startup_jobs": 20}


def _unwrap(algo):
    """Peel functools.partial layers → (function, merged keywords)."""
    kw = {}
    fn = algo
    while isinstance(fn, partial):
        merged = dict(fn.keywords or {})
        merged.update(kw)
        kw = merged
        fn = fn.func
    return fn, kw


def _async_variant(algo):
    """The algo's non-blocking dispatch variant with the partial's
    keywords re-applied, or None when the algo doesn't provide one."""
    fn, kw = _unwrap(algo)
    afn = getattr(fn, "async_variant", None)
    if afn is None:
        return None
    return partial(afn, **kw) if kw else afn


def _policy_for(algo):
    """(policy_name, params) for the speculation-validity check."""
    fn, kw = _unwrap(algo)
    policy = getattr(fn, "speculation_policy", "strict")
    if policy == "tpe_quantile":
        if kw.get("trial_filter") is not None:
            # the algorithm computes its γ-split over the FILTERED
            # history, while the quantile check below reasons about the
            # full loss array — a filter would silently mis-predict
            # validity, so don't speculate at all
            return "strict", {}
        params = dict(_TPE_DEFAULTS)
        for key in params:
            if key not in kw:
                continue
            if key == "linear_forgetting":
                # None is MEANINGFUL to tpe.suggest (no n_below cap),
                # unlike the other keys where None would just crash the
                # algorithm — mirror its semantics exactly
                params[key] = kw[key]
            elif kw[key] is not None:
                params[key] = kw[key]
        return policy, params
    return policy, {}


def _n_below(n, gamma, lf):
    # mirrors tpe._suggest_device: ceil(gamma * sqrt(n)) capped at
    # linear_forgetting unless that is None (0 caps at 0)
    nb = int(np.ceil(gamma * np.sqrt(n)))
    if lf is not None:
        nb = min(nb, int(lf))
    return nb


class _Speculation:
    __slots__ = ("ids", "seed", "resolve", "snap")

    def __init__(self, ids, seed, resolve, snap):
        self.ids = ids
        self.seed = seed
        self.resolve = resolve
        self.snap = snap


class SpeculativeSuggestEngine:
    """Issues suggest calls ahead of objective completion, bounded by a
    staleness depth ``max_speculation``.

    The fmin loop (``FMinIter``) uses two entry points:

    - :meth:`speculate` — called while an objective is running (or while
      an async backend is polling): reserves the next trial ids, draws the
      next seed, and launches the suggest program without blocking.
    - :meth:`next_batch` — called at enqueue time in place of the direct
      ``algo(...)`` call: validates pending speculations against the
      now-current history, relaunches any the γ-split shift invalidated,
      and returns ``(new_trials, new_ids)`` — resolving a speculative
      readback when one is available, computing synchronously otherwise.

    All device work in flight when an invalidation or :meth:`discard`
    happens is simply dropped (the resolver is never called); stream order
    on the card makes that safe against subsequent history appends.
    """

    def __init__(self, algo, domain, trials, rstate, max_speculation=1,
                 stats=None, device_recovery=None):
        if max_speculation < 0:
            raise ValueError(f"max_speculation must be >= 0, got {max_speculation}")
        self.algo = algo
        self.domain = domain
        self.trials = trials
        self.rstate = rstate
        self.max_speculation = int(max_speculation)
        self.stats = stats if stats is not None else SpeculationStats()
        # optional resilience.device.DeviceRecovery: the engine's
        # SYNCHRONOUS suggest calls (a miss, or the recompute after a
        # failed speculative readback) run through it, so a CUDA error
        # re-initializes and retries instead of aborting the run;
        # speculative launches stay unwrapped (their failures already
        # degrade to the serial protocol, whose recompute lands here)
        self.device_recovery = device_recovery
        self.policy, self.policy_params = _policy_for(algo)
        self._algo_async = _async_variant(algo)
        # The serial fmin loop calls the engine from one thread, but the
        # asynchronous plane interleaves speculate() (main loop) with
        # backend dispatcher threads — so the engine carries an explicit
        # two-level lock discipline:
        #
        # - ``_dispatch_lock`` (reentrant, coarse) serializes the
        #   compound schedule operations — speculate's check+draw+
        #   launch+append, next_batch's validate+pop+resolve, discard —
        #   so concurrent callers cannot overshoot max_speculation or
        #   interleave rstate draws (which would break the k=1
        #   bit-for-bit serial-trajectory guarantee).
        # - ``_pending_lock`` (fine) guards the queue state itself, so
        #   cheap inspections never wait behind a blocking readback.
        #
        # lock-order: _dispatch_lock < _pending_lock
        self._dispatch_lock = threading.RLock()
        self._pending_lock = threading.Lock()
        self._pending = deque()  # guarded-by: _pending_lock
        # (ids, seed) pairs whose speculative LAUNCH failed (device
        # error at dispatch): the serial protocol already consumed the
        # id allocation and the rstate draw, so they must be re-used —
        # not redrawn — by the next launch or synchronous suggest, or a
        # recovered run's trajectory diverges from the fault-free run.
        # Survives discard(): these are unlaunched protocol state, not
        # in-flight device work.
        self._spare = deque()  # guarded-by: _dispatch_lock
        # documents the validity checks of the last _validate walked (the
        # pipeline.validate span's n_walked): 0 where each hypothesized
        # trial was read at the position its launch recorded
        self._n_walked = 0  # guarded-by: _dispatch_lock

    # -- snapshot / validation ----------------------------------------
    def _snapshot(self):
        """Capture what the pending suggestion's validity depends on."""
        if self.policy == "independent":
            return ("independent",)
        hist = self.trials.history
        n = len(hist.losses)
        cv = getattr(hist, "content_version", None)
        if self.policy == "tpe_quantile":
            p = self.policy_params
            if len(self.trials.trials) < p["n_startup_jobs"] or n == 0:
                # the algo took its random-search startup path: valid as
                # long as it still would (the gate re-checks at validate)
                return ("startup",)
            nb = _n_below(n, p["gamma"], p["linear_forgetting"])
            if 1 <= nb <= n:
                losses = np.asarray(hist.losses, dtype=np.float64)
                thr = float(np.partition(losses, nb - 1)[nb - 1])
            else:
                thr = float("inf")
            # version counters are only comparable within ONE hist
            # object (tpe_device.sync documents the same invariant), so
            # counter-based snapshots pin the history's identity
            return ("quantile", n, nb, thr, cv, weakref.ref(hist))
        # strict policies never speculate: speculate() returns before any
        # launch, so no validity protocol exists (or is needed) for them
        raise AssertionError("strict speculation has no snapshot")

    def _still_valid(self, snap):
        kind = snap[0]
        if kind == "independent":
            return True
        hist = self.trials.history
        n_now = len(hist.losses)
        if kind == "startup":
            p = self.policy_params
            return len(self.trials.trials) < p["n_startup_jobs"] or n_now == 0
        if kind == "hyp":
            return self._hyp_still_valid(snap, hist, n_now)
        _, n0, nb0, thr, cv, hist_ref = snap
        if hist_ref() is not hist:
            # a swapped-in history restarts its version counters; the
            # snapshot's counters (and threshold) mean nothing against it
            return False
        # any non-append rewrite (delete, in-place loss edit) since the
        # snapshot invalidates unconditionally — the quantile shortcut
        # below only reasons about appended losses
        if cv is not None and getattr(hist, "last_nonappend_version", 0) > cv:
            return False
        if n_now == n0:
            return True
        if n_now < n0:
            return False
        p = self.policy_params
        if _n_below(n_now, p["gamma"], p["linear_forgetting"]) != nb0:
            return False
        new = np.asarray(hist.losses[n0:], dtype=np.float64)
        # strict <: the γ-split ranks by a STABLE argsort, so a tied loss
        # appended later ranks after the incumbent and the below set is
        # unchanged (matches tpe_device._loss_ranks semantics)
        return not bool(np.any(new < thr))

    def _hyp_still_valid(self, snap, hist, n_now):
        """Did every result the hypothesis bet on come true?

        The speculation was fit on ``n0`` real losses plus the
        hypothesized pending trials, with ``n_below`` = ``nb_fit`` for
        the grown count.  It still stands iff nothing rewrote history,
        no appended loss ranks inside the first ``nb_fit`` (stable f32
        ranking, matching the device's ``_loss_ranks``), the below-count
        the next fit would use equals ``nb_fit``, and no hypothesized
        trial died without a loss (its x sits in g(x) but the serial fit
        will never contain it).  Hypothesized trials merely still
        running keep the speculation valid — consuming it then is the
        async plane's fantasy mode; the serial fmin loop always consumes
        after the completion, where these checks certify bit-for-bit
        equality with the serial suggestion.

        O(k) in the k losses appended since the launch: the hypothesized
        trials are read at the positions the launch recorded, and the
        appended losses are compared with the rank threshold it took."""
        _, n0, nb_fit, hyp_tids, cv, hist_ref, positions, thr32 = snap
        if hist_ref() is not hist:
            return False  # swapped-in history: counters not comparable
        if cv is not None and getattr(hist, "last_nonappend_version", 0) > cv:
            return False
        if n_now < n0:
            return False
        done_tids = {int(t) for t in hist.loss_tids[n0:]}
        docs = self.trials._dynamic_trials
        open_hyp = [(tid, pos) for tid, pos in zip(hyp_tids, positions)
                    if tid not in done_tids]
        if all(pos < len(docs) and int(docs[pos]["tid"]) == tid
               for tid, pos in open_hyp):
            states = [docs[pos]["state"] for _, pos in open_hyp]
        else:
            # the store shortened, rebuilt or reordered its list since the
            # launch: find the hypothesized trials by walking it
            hyp_set = set(hyp_tids)
            self._n_walked += len(docs)  # lint: disable=RL301
            states = [t["state"] for t in docs
                      if int(t["tid"]) in hyp_set and int(t["tid"]) not in done_tids]
        if any(st not in (JOB_STATE_NEW, JOB_STATE_RUNNING) for st in states):
            return False
        p = self.policy_params
        if _n_below(n_now + len(states), p["gamma"],
                    p["linear_forgetting"]) != nb_fit:
            return False
        if n_now == n0:
            return True
        new32 = np.asarray(hist.losses[n0:n_now], dtype=np.float32)
        if cv is not None and not np.isnan(thr32) and not np.isnan(new32).any():
            # the earliest of the smallest appended losses ranks lowest of
            # them, right after the real losses <= it: inside the first
            # nb_fit iff it is below the nb_fit-th smallest real loss
            return not new32.min() < thr32
        # NaN ranks last, and a history without version counters may have
        # changed under the threshold: rank all of it
        losses = np.asarray(hist.losses[:n_now], dtype=np.float32)
        order = np.argsort(losses, kind="stable")
        ranks = np.empty(n_now, np.int64)
        ranks[order] = np.arange(n_now)
        return not np.any(ranks[n0:] < nb_fit)

    def _validate(self, exposed=False):
        """Relaunch every pending speculation the current history has
        invalidated (same ids, same seed, fresh history).  ``exposed``:
        the caller is on the fmin loop's critical path (consume time), so
        relaunch cost must not be booked as hidden time.  Returns how many
        speculations it invalidated."""
        self._n_walked = 0  # lint: disable=RL301
        with self._pending_lock:
            if not self._pending:
                return 0
            if all(self._still_valid(sp.snap) for sp in self._pending):
                return 0
            # the speculations were issued against successive rstate
            # draws in trial order; one stale γ-split invalidates them
            # all (each later speculation was fit on the same stale
            # history)
            stale = list(self._pending)
            self._pending.clear()
        self.stats.record_invalidation(len(stale))
        for j, sp in enumerate(stale):
            t0 = time.perf_counter()
            try:
                resolve, snap = self._launch_spec(sp.ids, sp.seed)
            except Exception as launch_err:
                # relaunch dispatch failed (device error): park this and
                # every later stale speculation's (ids, seed) in order —
                # the next launch or synchronous suggest re-uses them, so
                # the trajectory stays seed-transparent through the fault
                logger.exception(
                    "relaunch dispatch failed; falling back to "
                    "synchronous recompute"
                )
                if self.device_recovery is not None:
                    self.device_recovery.absorb(launch_err)
                for sp2 in stale[j:]:
                    # safe: _validate's only callers (speculate,
                    # next_batch) hold _dispatch_lock around the call
                    self._spare.append((sp2.ids, sp2.seed))  # lint: disable=RL301
                break
            with self._pending_lock:
                self._pending.append(
                    _Speculation(sp.ids, sp.seed, resolve, snap)
                )
            self.stats.record_dispatch(
                time.perf_counter() - t0, hypothesis=snap[0] == "hyp",
                exposed=exposed,
            )
        return len(stale)

    # -- dispatch ------------------------------------------------------
    def _call_algo_sync(self, ids, seed):
        """The serial protocol's exact algo call, under device recovery
        when the driver provided one."""
        if self.device_recovery is not None:
            return self.device_recovery.run(
                lambda: self.algo(ids, self.domain, self.trials, seed)
            )
        return self.algo(ids, self.domain, self.trials, seed)

    def _launch(self, ids, seed):
        if self._algo_async is not None:
            return self._algo_async(ids, self.domain, self.trials, seed)
        docs = self.algo(ids, self.domain, self.trials, seed)
        return lambda: docs

    def _launch_spec(self, ids, seed):
        """(resolver, validity snapshot) for one speculative suggest —
        with the lands-above hypothesis folded into the fit whenever the
        algorithm supports async dispatch and results are in flight."""
        if self.policy != "tpe_quantile":
            return self._launch(ids, seed), self._snapshot()
        p = self.policy_params
        hist = self.trials.history
        n0 = len(hist.losses)
        if len(self.trials.trials) < p["n_startup_jobs"] or n0 == 0:
            return self._launch(ids, seed), ("startup",)
        pending = [
            (pos, t) for pos, t in enumerate(self.trials._dynamic_trials)
            if t["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING)
        ]
        nb_fit = _n_below(
            n0 + len(pending), p["gamma"], p["linear_forgetting"]
        )
        # nb_fit <= n0: with every pending result hypothesized above, the
        # below set must fit inside the real losses (always true past
        # startup; degenerate tiny-history corners fall back to stale)
        if pending and self._algo_async is not None and nb_fit <= n0:
            cv = getattr(hist, "content_version", None)
            resolve = self._algo_async(
                ids, self.domain, self.trials, seed,
                pending=[t["misc"]["vals"] for _, t in pending],
            )
            # what the validity check reads in O(k): where each pending
            # trial sits in the list, and the nb_fit-th smallest real loss
            # in float32 (NaN where fewer are not NaN: the check then
            # ranks them all, as it does for a NaN appended loss)
            losses32 = np.asarray(hist.losses[:n0], dtype=np.float32)
            thr32 = (np.partition(losses32, nb_fit - 1)[nb_fit - 1]
                     if nb_fit else np.float32(-np.inf))
            snap = (
                "hyp", n0, nb_fit,
                tuple(int(t["tid"]) for _, t in pending), cv,
                weakref.ref(hist),
                tuple(pos for pos, _ in pending), thr32,
            )
            return resolve, snap
        return self._launch(ids, seed), self._snapshot()

    def speculate(self, batch_size=1, limit=None):
        """Launch up to ``max_speculation`` pending suggestions (each for
        ``batch_size`` fresh trial ids) without blocking.  Call while an
        objective is evaluating; the device computes in the background.

        ``limit`` caps pending speculations at the number of suggestions
        the fmin loop will still consume this run, so the final trials of a
        bounded run don't launch device work (and burn trial ids) for
        suggestions past ``max_evals`` that nothing will ever read."""
        cap = self.max_speculation
        if limit is not None:
            cap = min(cap, max(int(limit), 0))
        if cap <= 0:
            return
        if self.policy == "strict":
            # every completed trial would invalidate a strict speculation
            # (see module docstring): don't burn the work, stay serial
            return
        with self._dispatch_lock, tracing.span("pipeline.speculate") as span:
            # the fmin loop may have completed trials since the last refresh
            # (several NEW trials evaluated back-to-back, e.g.
            # points_to_evaluate warm starts): validation and the pending
            # scan below must see those losses, or a completed-but-
            # unsynced trial is neither in the history nor hypothesized
            # and a relaunched speculation silently loses its observation
            loop_refresh(self.trials)
            with tracing.span("pipeline.validate") as vspan:
                vspan.set_attr("n_invalidated", self._validate())
                vspan.set_attr("n_walked", self._n_walked)
            n_launched = n_hypothesis = 0
            while True:
                with self._pending_lock:
                    if len(self._pending) >= cap:
                        break
                t0 = time.perf_counter()
                if self._spare:
                    # a previous launch failed after the draw: reuse its
                    # ids and seed (the serial protocol's exact next call)
                    ids, seed = self._spare.popleft()
                else:
                    ids = self.trials.new_trial_ids(batch_size)
                    loop_refresh(self.trials)
                    seed = int(self.rstate.integers(2 ** 31 - 1))
                try:
                    resolve, snap = self._launch_spec(ids, seed)
                except Exception:
                    # dispatch failed (device error, out of memory): park
                    # the consumed (ids, seed) for the next attempt so
                    # the trajectory stays seed-transparent, then let the
                    # caller degrade to the serial protocol
                    self._spare.appendleft((ids, seed))
                    raise
                with self._pending_lock:
                    self._pending.append(
                        _Speculation(ids, seed, resolve, snap)
                    )
                self.stats.record_dispatch(
                    time.perf_counter() - t0, hypothesis=snap[0] == "hyp"
                )
                n_launched += 1
                n_hypothesis += snap[0] == "hyp"
            span.set_attr("n_launched", n_launched)
            span.set_attr("hypothesis", n_hypothesis)

    # -- consumption ---------------------------------------------------
    def next_batch(self, n):
        """Trial docs + ids for the next ``n`` enqueue slots.

        Pending (validated) speculations are consumed first; any remainder
        is computed synchronously with a fresh seed — exactly one rstate
        draw per suggest call either way.  Returns ``(new_trials,
        new_ids)``; ``new_trials`` is None when the algorithm signalled a
        stop and nothing was produced."""
        with self._dispatch_lock:
            with tracing.span("pipeline.validate") as vspan:
                vspan.set_attr("n_invalidated", self._validate(exposed=True))
                vspan.set_attr("n_walked", self._n_walked)
            docs, ids = [], []
            while True:
                with self._pending_lock:
                    if not self._pending or (
                        len(ids) + len(self._pending[0].ids) > n
                    ):
                        break
                    sp = self._pending.popleft()
                t0 = time.perf_counter()
                try:
                    with tracing.span("pipeline.resolve"):
                        out = sp.resolve()
                    self.stats.record_resolve(time.perf_counter() - t0)
                except Exception as readback_err:
                    # the card reports a kernel's fault at the readback's
                    # wait; a speculation-only failure must not abort a
                    # run that would have completed serially — drop every
                    # in-flight speculation and recompute this one
                    # synchronously with ITS ids and seed (the serial
                    # protocol's exact call)
                    logger.exception(
                        "speculative readback failed; recomputing "
                        "synchronously"
                    )
                    if self.device_recovery is not None:
                        self.device_recovery.absorb(readback_err)
                    self.discard()
                    t1 = time.perf_counter()
                    with tracing.span("pipeline.sync_suggest"):
                        out = self._call_algo_sync(sp.ids, sp.seed)
                    self.stats.record_sync(time.perf_counter() - t1)
                if out is None:
                    return (docs if docs else None), ids
                docs.extend(out)
                ids.extend(sp.ids)
            rem = n - len(ids)
            while rem > 0:
                if self._spare and len(self._spare[0][0]) <= rem:
                    # a launch-failed speculation already consumed these
                    # ids and this seed — the serial protocol's exact
                    # next call is to re-use them synchronously
                    fresh, seed = self._spare.popleft()
                else:
                    fresh = self.trials.new_trial_ids(rem)
                    loop_refresh(self.trials)
                    seed = int(self.rstate.integers(2 ** 31 - 1))
                t0 = time.perf_counter()
                with tracing.span("pipeline.sync_suggest"):
                    out = self._call_algo_sync(fresh, seed)
                self.stats.record_sync(time.perf_counter() - t0)
                if out is None:
                    return (docs if docs else None), ids + fresh
                docs.extend(out)
                ids.extend(fresh)
                rem = n - len(ids)
            return docs, ids

    def discard(self):
        """Drop every pending speculation (in-flight device work is
        abandoned, never read).  Used when the run stops or an objective
        exception propagates mid-speculation."""
        with self._dispatch_lock:
            with self._pending_lock:
                n = len(self._pending)
                self._pending.clear()
        if n:
            self.stats.record_discard(n)
