"""Search-health telemetry: per-study optimizer introspection and verdicts.

Reference parity: ``hyperopt_tpu/diagnostics.py`` (numpy and stdlib only
there too), copied so the port imports nothing of the JAX package.

A study whose suggests are fast can still be searching badly: collapsed
Parzen sigmas, a flat EI landscape, an exhausted discrete space, a
NaN-storm objective.  Three layers see it:

- **The suggest's diag row** (no extra device work): every family core of
  :mod:`hyperopt_tpu_torch.algos.tpe_device` returns one ``[L, DIAG_COLS]``
  row per family beside its winners — below/above component counts, max
  EI, EI log-mean-exp, top-k EI softmax mass, and family-specific
  degeneracy signals.  On the ``fused`` tier the EI columns come from the
  fused kernel's partials.  :func:`snapshot_from_fused` names the columns
  per label; ``tpe.suggest`` publishes the snapshot on its thread
  (:func:`publish_suggest_diag`, :func:`last_suggest_diag`).
- **:class:`SearchStats`**: the per-study accumulator (running best, regret
  curve, result/error/NaN counters, the latest snapshot).  ``fmin`` feeds
  one per run (``FMinIter.search_stats``).
- **The SH5xx classifier** (:meth:`SearchStats.health`):

========  ===============  ====================================================
rule      state            fires when
========  ===============  ====================================================
SH501     WARMUP           fewer results than ``n_startup_jobs``
SH506     FAULT_DEGRADED   error + NaN + quarantine rate ≥ ``fault_rate_min``
SH505     SPACE_EXHAUSTED  every category of every discrete dimension is
                           observed and the EI argmax duplicates one on every
                           draw
SH504     SIGMA_COLLAPSE   a continuous label's below-mixture sigmas sit at the
                           adaptive-Parzen floor for ≥ ``sigma_floor_frac_min``
                           of its real components
SH503     FLAT_EI          mean EI flatness (max − log-mean-exp) ≤
                           ``flat_ei_max``
SH502     STALLED          no best-loss improvement over the last
                           ``stall_window`` results after warm-up
SH500     OK               none of the above
========  ===============  ====================================================

Every fired rule is reported, so an early-stop hook
(:func:`hyperopt_tpu_torch.early_stop.no_progress_stop`) can act on SH502
when a higher-priority rule owns the state.  ``fault_stats`` takes any
object with the reference ``FaultStats``'s ``get(name)``; the port has
none yet, so ``fmin`` passes None.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque

import numpy as np

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------
# The fused-readback diagnostic row (shared layout with tpe_device)
# ---------------------------------------------------------------------

#: columns of the per-label diagnostic row every family core appends to
#: the fused program output (f32; see algos/tpe_device.py)
DIAG_COLS = 8

# column indices — 0-4 are family-independent
D_NB = 0            # below-set component count (post filters/locks)
D_NA = 1            # above-set component count
D_EI_MAX = 2        # max l(x)-g(x) log-ratio over all candidates
D_EI_LME = 3        # log-mean-exp of the scores (flatness reference)
D_EI_TOP_MASS = 4   # softmax mass of the top-16 candidates
# columns 5-7 are family-specific:
#   cont: sigma_min_rel, sigma_mean_rel, sigma_floor_frac
#         (below-mixture sigmas over real components, / prior_sigma)
#   idx:  n_distinct_obs, dup_argmax_frac, support
D_EI_TOP_K = 16     # the k of the top-k mass reduction (static)

# health states, priority order (first fired rule owns the state)
HEALTH_RULES = (
    ("SH501", "WARMUP"),
    ("SH506", "FAULT_DEGRADED"),
    ("SH505", "SPACE_EXHAUSTED"),
    ("SH504", "SIGMA_COLLAPSE"),
    ("SH503", "FLAT_EI"),
    ("SH502", "STALLED"),
)
OK_RULE = ("SH500", "OK")
HEALTH_STATES = tuple(s for _, s in HEALTH_RULES) + (OK_RULE[1],)


def _finite(v):
    """JSON-safe float: non-finite → None (status payloads must never
    render a bare NaN)."""
    if v is None:
        return None
    v = float(v)
    return v if math.isfinite(v) else None


def snapshot_from_fused(fams, diags, *, n_below, gamma, n_eff, k, n_cand):
    """Named per-label snapshot from the raw fused-readback diag rows.

    ``fams``: the per-request ``tpe_device._Family`` objects, in request
    order; ``diags``: the aligned ``[L, DIAG_COLS]`` arrays the resolver
    split off the flat readback.  The context kwargs are the host-side
    split parameters of the same suggest (γ, ``n_below``, effective
    history size) — together this is everything the SH5xx classifier
    needs about one suggest.
    """
    labels = {}
    for fam, d in zip(fams, diags):
        d = np.asarray(d, np.float64)
        is_cont = fam.key[0] == "cont"
        for i, lb in enumerate(fam.labels):
            row = d[i]
            ent = {
                "kind": "cont" if is_cont else "idx",
                "nb": int(row[D_NB]),
                "na": int(row[D_NA]),
                "ei_max": _finite(row[D_EI_MAX]),
                # flatness: max − log-mean-exp ≥ 0; ~0 means the EI
                # landscape ranks nothing above anything
                "ei_flatness": _finite(row[D_EI_MAX] - row[D_EI_LME]),
                "ei_top_mass": _finite(row[D_EI_TOP_MASS]),
            }
            if is_cont:
                ent["sigma_min_rel"] = _finite(row[5])
                ent["sigma_mean_rel"] = _finite(row[6])
                ent["sigma_floor_frac"] = _finite(row[7])
            else:
                ent["n_distinct"] = int(row[5])
                ent["dup_frac"] = _finite(row[6])
                ent["support"] = int(row[7])
            labels[lb] = ent
    return {
        "n_below": int(n_below),
        "gamma": float(gamma),
        "n_eff": int(n_eff),
        "k": int(k),
        "n_cand": int(n_cand),
        "labels": labels,
    }


# ---------------------------------------------------------------------
# Thread-local publish/consume (the profiling.last_dispatch_record
# pattern): tpe publishes the snapshot on the thread that resolves the
# readback; the fmin loop / service scheduler consumes it right after.
# ---------------------------------------------------------------------

_tls = threading.local()
_enabled = True


def set_enabled(flag: bool):
    """Gate the host-side snapshot build and publish (the device-side
    reductions always run; this switch lets the host side's cost be
    measured against its absence)."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def publish_suggest_diag(snapshot: dict):
    _tls.last = snapshot


def last_suggest_diag(consume: bool = True):
    """The most recent suggest's diag snapshot published ON THIS THREAD
    (None when none).  ``consume`` clears it so a later suggest can
    never be attributed a stale snapshot."""
    snap = getattr(_tls, "last", None)
    if consume:
        _tls.last = None
    return snap


# ---------------------------------------------------------------------
# SearchStats
# ---------------------------------------------------------------------


class SearchStats:
    """Per-study search-quality accumulator + SH5xx health classifier.

    Two feeding modes (use one per instance):

    - **push** (the optimization service): :meth:`record_suggest` with
      each suggest's fused snapshot, :meth:`record_result` with each
      reported loss/status;
    - **pull** (the fmin loop, the early-stop hook):
      :meth:`observe_trials` ingests a Trials object incrementally —
      OK-trial losses (NaN included) from the history tail plus the
      error-state count.

    Thread-safe: the service records from scheduler and handler threads
    while ``/metrics`` and ``/v1/study_status`` snapshot concurrently.
    """

    # lock-order: _lock
    def __init__(self, study_id=None, n_startup_jobs=20, fault_stats=None,
                 stall_window=30, stall_rel_improve=0.0, flat_ei_max=0.1,
                 sigma_floor_frac_min=0.8, sigma_min_nb=8,
                 fault_rate_min=0.5, fault_min_results=8,
                 exhaust_dup_frac=0.999, optimum=None, max_curve=256):
        self.study_id = study_id
        self.n_startup_jobs = int(n_startup_jobs)
        self.fault_stats = fault_stats
        self.stall_window = int(stall_window)
        self.stall_rel_improve = float(stall_rel_improve)
        self.flat_ei_max = float(flat_ei_max)
        self.sigma_floor_frac_min = float(sigma_floor_frac_min)
        self.sigma_min_nb = int(sigma_min_nb)
        self.fault_rate_min = float(fault_rate_min)
        self.fault_min_results = int(fault_min_results)
        self.exhaust_dup_frac = float(exhaust_dup_frac)
        self.optimum = None if optimum is None else float(optimum)
        self._lock = threading.Lock()
        self._n_suggests = 0  # guarded-by: _lock
        self._n_device_suggests = 0  # guarded-by: _lock
        self._n_results = 0  # guarded-by: _lock
        self._n_ok = 0  # guarded-by: _lock
        self._n_error = 0  # guarded-by: _lock
        self._n_nan = 0  # guarded-by: _lock
        self._best = None  # guarded-by: _lock
        self._best_at = None  # guarded-by: _lock  (result index of best)
        self._curve = deque(maxlen=int(max_curve))  # guarded-by: _lock
        # best-so-far over the trailing stall_window results (+1 so the
        # window-ago reference survives the append)
        self._best_trail = deque(maxlen=self.stall_window + 1)  # guarded-by: _lock
        self._last_diag = None  # guarded-by: _lock
        self._last_activity = time.monotonic()  # guarded-by: _lock
        # observe_trials cursors (pull mode)
        self._obs_n_ok = 0  # guarded-by: _lock
        self._obs_n_error = 0  # guarded-by: _lock
        # tids whose NaN report was rejected (dedup: idempotent client
        # retries of one diverged trial must count it exactly once)
        self._nan_tids = set()  # guarded-by: _lock

    # -- push feeding ---------------------------------------------------
    def record_suggest(self, snapshot=None):
        """One served suggest; ``snapshot`` is the fused-readback diag
        (None for host-side random/startup suggests)."""
        with self._lock:
            self._n_suggests += 1
            self._last_activity = time.monotonic()
            if snapshot is not None:
                self._n_device_suggests += 1
                self._last_diag = snapshot

    def record_result(self, loss=None, status="ok"):
        """One trial outcome.  ``status`` other than ``"ok"`` counts as
        an error; a non-finite loss counts as a NaN event (diverged
        objective) and never updates the best."""
        with self._lock:
            self._record_result_locked(loss, status)

    def record_nan_rejected(self, tid):
        """A non-finite-loss report REJECTED at the API (no state
        change landed) — still a search-health event (the trial
        diverged), counted once per trial: a retried idempotent report
        of the same tid must not inflate the fault rate or advance the
        warm-up/stall windows."""
        with self._lock:
            tid = int(tid)
            if tid in self._nan_tids:
                return
            self._nan_tids.add(tid)
            self._record_result_locked(float("nan"), "ok")

    def _record_result_locked(self, loss, status):
        self._n_results += 1  # lint: disable=RL301  caller holds _lock
        self._last_activity = time.monotonic()  # lint: disable=RL301  caller holds _lock
        if str(status) != "ok":
            self._n_error += 1  # lint: disable=RL301  caller holds _lock
        elif loss is not None and not math.isfinite(float(loss)):
            self._n_nan += 1  # lint: disable=RL301  caller holds _lock
        else:
            self._n_ok += 1  # lint: disable=RL301  caller holds _lock
            if loss is not None:
                loss = float(loss)
                if self._best is None or loss < self._best:  # lint: disable=RL301  caller holds _lock
                    self._best = loss  # lint: disable=RL301  caller holds _lock
                    self._best_at = self._n_results  # lint: disable=RL301  caller holds _lock
                    self._curve.append((self._n_results, loss))  # lint: disable=RL301  caller holds _lock
        self._best_trail.append(self._best)  # lint: disable=RL301  caller holds _lock

    # -- pull feeding ---------------------------------------------------
    def observe_trials(self, trials):
        """Incrementally ingest a Trials object: the OK-history loss
        tail (NaN losses included) plus the error-state count (from the
        last refresh's tallies where they hold, ``Trials.
        count_by_state_tallied``).  Safe to call repeatedly; a shrunken
        history resets the cursor and recounts."""
        from .base import JOB_STATE_ERROR

        hist = trials.history
        losses = hist.losses
        n = len(losses)
        n_err = trials.count_by_state_tallied(JOB_STATE_ERROR)
        with self._lock:
            if n < self._obs_n_ok:
                # non-append rebuild (delete_all, reload): start over
                self._reset_counts_locked()
            for loss in losses[self._obs_n_ok:n]:
                self._record_result_locked(float(loss), "ok")
            self._obs_n_ok = n
            if n_err > self._obs_n_error:
                for _ in range(n_err - self._obs_n_error):
                    self._record_result_locked(None, "fail")
            self._obs_n_error = max(n_err, self._obs_n_error)

    def _reset_counts_locked(self):
        self._n_results = self._n_ok = self._n_error = self._n_nan = 0  # lint: disable=RL301  caller holds _lock
        self._best = self._best_at = None  # lint: disable=RL301  caller holds _lock
        self._curve.clear()  # lint: disable=RL301  caller holds _lock
        self._best_trail.clear()  # lint: disable=RL301  caller holds _lock
        self._obs_n_ok = self._obs_n_error = 0  # lint: disable=RL301  caller holds _lock
        self._nan_tids.clear()  # lint: disable=RL301  caller holds _lock

    @property
    def last_activity(self) -> float:
        with self._lock:
            return self._last_activity

    # -- derived --------------------------------------------------------
    def _fault_counts_locked(self):
        quarantined = 0
        if self.fault_stats is not None:
            quarantined = (
                self.fault_stats.get("trial_quarantined")
                + self.fault_stats.get("lease_quarantined")
            )
        return {
            "n_error": self._n_error,  # lint: disable=RL301  caller holds _lock
            "n_nan": self._n_nan,  # lint: disable=RL301  caller holds _lock
            "n_quarantined": int(quarantined),
        }

    def snapshot(self) -> dict:
        """The full JSON-safe state: counters, best/regret, the latest
        fused diag, and fault rates — the /v1/study_status payload and
        the classifier's input."""
        with self._lock:
            faults = self._fault_counts_locked()
            n_res = self._n_results
            bad = faults["n_error"] + faults["n_nan"] + faults["n_quarantined"]
            improvement = None
            if len(self._best_trail) and self._best is not None:
                ref = self._best_trail[0]
                if ref is not None:
                    improvement = ref - self._best
            return {
                "study_id": self.study_id,
                "n_suggests": self._n_suggests,
                "n_device_suggests": self._n_device_suggests,
                "n_results": n_res,
                "n_ok": self._n_ok,
                "n_startup_jobs": self.n_startup_jobs,
                "best_loss": _finite(self._best),
                "best_at_result": self._best_at,
                "regret": (
                    _finite(self._best - self.optimum)
                    if self._best is not None and self.optimum is not None
                    else None
                ),
                "optimum": _finite(self.optimum),
                "regret_curve": [
                    {"n": n, "best": _finite(b)} for n, b in self._curve
                ],
                "improvement_window": _finite(improvement),
                "stall_window": self.stall_window,
                "faults": dict(
                    faults, fault_rate=round(bad / max(n_res, 1), 4)
                ),
                "last_suggest": self._last_diag,
            }

    # -- the SH5xx classifier -------------------------------------------
    def health(self, snap=None) -> dict:
        """``{"state", "rule", "rules": [{"rule", "state", "detail"}]}``
        — primary state = highest-priority fired rule; ``rules`` lists
        every fired one (so SH502 is actionable even when e.g. SH503
        owns the state).  ``snap``: a snapshot already taken by the
        caller — classifying the SAME state the caller displays, and
        skipping a second snapshot build (status / metrics rows take
        one snapshot and derive both from it)."""
        if snap is None:
            snap = self.snapshot()
        fired = []
        n_res = snap["n_results"]

        if n_res < self.n_startup_jobs:
            fired.append((
                "SH501", "WARMUP",
                f"{n_res}/{self.n_startup_jobs} results — still in the "
                f"n_startup_jobs random phase",
            ))

        f = snap["faults"]
        if (
            n_res >= self.fault_min_results
            and f["fault_rate"] >= self.fault_rate_min
        ):
            fired.append((
                "SH506", "FAULT_DEGRADED",
                f"fault rate {f['fault_rate']:.2f} "
                f"(errors={f['n_error']} nan={f['n_nan']} "
                f"quarantined={f['n_quarantined']} of {n_res} results)",
            ))

        diag = snap["last_suggest"]
        warm = n_res >= self.n_startup_jobs
        if diag and warm:
            labels = diag["labels"]
            idx_labels = {
                lb: d for lb, d in labels.items() if d["kind"] == "idx"
            }
            if labels and len(idx_labels) == len(labels):
                exhausted = all(
                    d["n_distinct"] >= d["support"]
                    and (d["dup_frac"] or 0.0) >= self.exhaust_dup_frac
                    for d in idx_labels.values()
                )
                if exhausted:
                    fired.append((
                        "SH505", "SPACE_EXHAUSTED",
                        "every category of every discrete dimension is "
                        "observed and the EI argmax duplicates an "
                        "observed value on every draw",
                    ))
            for lb, d in labels.items():
                if (
                    d["kind"] == "cont"
                    and d["nb"] >= self.sigma_min_nb
                    and (d["sigma_floor_frac"] or 0.0)
                    >= self.sigma_floor_frac_min
                ):
                    fired.append((
                        "SH504", "SIGMA_COLLAPSE",
                        f"label {lb!r}: {d['sigma_floor_frac']:.0%} of "
                        f"the below-mixture sigmas sit at the adaptive-"
                        f"Parzen clip floor (nb={d['nb']})",
                    ))
                    break
            flats = [
                d["ei_flatness"] for d in labels.values()
                if d["ei_flatness"] is not None
            ]
            if flats and float(np.mean(flats)) <= self.flat_ei_max:
                fired.append((
                    "SH503", "FLAT_EI",
                    f"mean EI flatness {float(np.mean(flats)):.4f} <= "
                    f"{self.flat_ei_max} — l(x)/g(x) rank no candidate "
                    f"above any other",
                ))

        if (
            n_res >= self.n_startup_jobs + self.stall_window
            and snap["best_loss"] is not None
            and snap["improvement_window"] is not None
        ):
            ref = snap["best_loss"] + snap["improvement_window"]
            eps = abs(ref) * self.stall_rel_improve + 1e-12
            if snap["improvement_window"] <= eps:
                fired.append((
                    "SH502", "STALLED",
                    f"best loss unimproved over the last "
                    f"{self.stall_window} results "
                    f"(improvement {snap['improvement_window']:.3g})",
                ))

        order = {rule: i for i, (rule, _) in enumerate(HEALTH_RULES)}
        fired.sort(key=lambda r: order[r[0]])
        if not fired:
            rule, state = OK_RULE
            return {"rule": rule, "state": state, "rules": []}
        return {
            "rule": fired[0][0],
            "state": fired[0][1],
            "rules": [
                {"rule": r, "state": s, "detail": d} for r, s, d in fired
            ],
        }

    def metrics_row(self) -> dict:
        """The bounded per-study /metrics gauge row (one dict per
        exported study)."""
        snap = self.snapshot()
        h = self.health(snap=snap)
        diag = snap["last_suggest"] or {}
        labels = diag.get("labels", {})
        ei_max = [
            d["ei_max"] for d in labels.values() if d["ei_max"] is not None
        ]
        flats = [
            d["ei_flatness"] for d in labels.values()
            if d["ei_flatness"] is not None
        ]
        return {
            "study": str(self.study_id),
            "best_loss": snap["best_loss"],
            "regret": snap["regret"],
            "gamma": diag.get("gamma"),
            "n_below": diag.get("n_below"),
            "ei_max": float(np.max(ei_max)) if ei_max else None,
            "ei_flatness": float(np.mean(flats)) if flats else None,
            "state": h["state"],
        }
