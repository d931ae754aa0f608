"""Overlap accounting of the speculative suggest engine, and the fault
counters of the resilience layer.

Reference parity: ``SpeculationStats`` and ``FaultStats`` of
``hyperopt_tpu/observability.py`` (``:71-274``).  The rest of that module
(phase timings, latency histograms, store and service stats, Prometheus
rendering) is not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict

logger = logging.getLogger(__name__)


class SpeculationStats:
    """Overlap accounting for the pipelined suggest engine.

    Splits per-suggest wall-clock into **hidden** time (speculative
    dispatch work done while the user objective runs — off the critical
    path) and **exposed** time (work the fmin loop had to wait for: resolving
    a speculative readback, or a fully synchronous suggest after a miss /
    invalidation).  ``hidden_s / (hidden_s + exposed_s)`` is the fraction
    of suggest cost the pipeline removed from the wall clock.
    """

    def __init__(self):
        self.dispatch_s = 0.0  # hidden: speculative launch (host work and kernel launches)
        self.reissue_exposed_s = 0.0  # exposed: relaunch at consume time
        self.resolve_s = 0.0  # exposed: blocking readback of a used speculation
        self.sync_s = 0.0  # exposed: synchronous suggest (miss or no speculation)
        self.n_dispatched = 0
        self.n_hypothesis = 0
        self.n_used = 0
        self.n_invalidated = 0
        self.n_sync = 0
        self.n_discarded = 0

    def record_dispatch(self, seconds, hypothesis=False, exposed=False):
        # ``exposed``: the launch ran on the fmin loop's critical path (an
        # invalidation relaunch at consume time), not behind an objective
        if exposed:
            self.reissue_exposed_s += seconds
        else:
            self.dispatch_s += seconds
        self.n_dispatched += 1
        if hypothesis:
            # fit against the hypothetical lands-above history (exact
            # when the prediction holds; see hyperopt_tpu_torch.pipeline)
            self.n_hypothesis += 1

    def record_resolve(self, seconds):
        self.resolve_s += seconds
        self.n_used += 1

    def record_sync(self, seconds):
        self.sync_s += seconds
        self.n_sync += 1

    def record_invalidation(self, n=1):
        self.n_invalidated += n

    def record_discard(self, n=1):
        self.n_discarded += n

    @property
    def hidden_s(self):
        return self.dispatch_s

    @property
    def exposed_s(self):
        return self.resolve_s + self.sync_s + self.reissue_exposed_s

    def summary(self):
        total = self.hidden_s + self.exposed_s
        return {
            "hidden_s": round(self.hidden_s, 6),
            "exposed_s": round(self.exposed_s, 6),
            "hidden_frac": round(self.hidden_s / total, 4) if total else None,
            "resolve_s": round(self.resolve_s, 6),
            "sync_s": round(self.sync_s, 6),
            "reissue_exposed_s": round(self.reissue_exposed_s, 6),
            "n_dispatched": self.n_dispatched,
            "n_hypothesis": self.n_hypothesis,
            "n_used": self.n_used,
            "n_invalidated": self.n_invalidated,
            "n_sync": self.n_sync,
            "n_discarded": self.n_discarded,
        }

    def log_summary(self, level=logging.INFO):
        s = self.summary()
        logger.log(
            level,
            "speculation: hidden %.3fs exposed %.3fs (frac %s) "
            "dispatched=%d (hypothesis=%d) used=%d invalidated=%d "
            "sync=%d discarded=%d",
            s["hidden_s"],
            s["exposed_s"],
            s["hidden_frac"],
            s["n_dispatched"],
            s["n_hypothesis"],
            s["n_used"],
            s["n_invalidated"],
            s["n_sync"],
            s["n_discarded"],
        )


class FaultStats:
    """Fault-tolerance accounting for :mod:`hyperopt_tpu_torch.resilience`.

    Every recovery event in the fault-tolerance layer — lease expiries and
    reclamations, retries and their backoff sleeps, quarantines, device
    re-initializations, CPU fallbacks, dropped stale results, and every
    chaos-injected fault (``chaos_*`` keys) — lands here, so a run can
    assert that injected faults and recoveries balance (the chaos
    campaign's accounting invariant).

    Counters are an open set keyed by event name; the well-known keys are

    - ``lease_expired`` / ``lease_reclaimed`` / ``lease_quarantined`` —
      reaper activity (expiries observed, trials re-queued, trials moved
      to ``JOB_STATE_ERROR`` after ``max_attempts``)
    - ``stale_lock_cleared`` — torn/orphaned lock files removed
    - ``trial_failure`` / ``trial_retried`` / ``trial_quarantined`` —
      retry-policy activity (plus ``backoff_s`` accumulated sleep)
    - ``objective_timeout`` — per-trial watchdog expiries
    - ``stale_result_dropped`` — a worker's result discarded because its
      lease had been reclaimed while it ran
    - ``heartbeat`` — lease renewals
    - ``device_error`` / ``device_reinit`` / ``cpu_fallback`` — device
      recovery activity (the reference's; the port records none yet)
    - ``chaos_<site>`` — faults injected by the chaos harness

    Thread-safe: the reaper, worker threads, and the driver all record
    concurrently.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = defaultdict(int)
        self._backoff_s = 0.0

    def record(self, event: str, n: int = 1):
        with self._lock:
            self._counts[event] += n

    def record_backoff(self, seconds: float):
        with self._lock:
            self._backoff_s += float(seconds)

    def get(self, event: str) -> int:
        with self._lock:
            return self._counts.get(event, 0)

    @property
    def backoff_s(self) -> float:
        with self._lock:
            return self._backoff_s

    def counts(self) -> dict:
        """Snapshot of all counters (sorted, chaos keys included)."""
        with self._lock:
            return dict(sorted(self._counts.items()))

    def injected(self) -> dict:
        """Just the chaos-injected fault counters, keyed by site."""
        with self._lock:
            return {
                k[len("chaos_"):]: v
                for k, v in sorted(self._counts.items())
                if k.startswith("chaos_")
            }

    def merge(self, other: "FaultStats"):
        """Fold another FaultStats into this one (campaign aggregation)."""
        o = other.counts()
        ob = other.backoff_s
        with self._lock:
            for k, v in o.items():
                self._counts[k] += v
            self._backoff_s += ob

    def summary(self) -> dict:
        out = self.counts()
        out["backoff_s"] = round(self.backoff_s, 6)
        return out

    def log_summary(self, level=logging.INFO):
        s = self.summary()
        if len(s) == 1:  # only backoff_s, nothing happened
            return
        logger.log(
            level,
            "faults: %s",
            " ".join(f"{k}={v}" for k, v in s.items()),
        )
