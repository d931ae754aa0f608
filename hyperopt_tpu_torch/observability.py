"""Driver and device-plane telemetry: phase timings, the speculative
engine's overlap accounting, the resilience layer's fault counters,
latency histograms, the roofline profiler's device stats, the durable
store's stats, and their Prometheus text rendering.

Reference parity: ``hyperopt_tpu/observability.py``, ``ServiceStats``
included (``:361-737``).  Every metric name and label is the
reference's, so a scraper of the JAX package reads the port unchanged;
the one difference is the identity gauge, whose labels name torch and
CUDA (:func:`build_info`).  The reference's ``traced_suggest`` and
``annotate`` (``jax.profiler`` hooks) have no counterpart: the bounded
``torch.profiler`` capture is ``profiling.ProfileCapture``, and the fmin
loop's host time splits into ``tracing`` spans (``fmin(tracer=...)``,
``docs/torch_fmin_spans.md``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from functools import wraps

from . import tracing

logger = logging.getLogger(__name__)


class PhaseTimings:
    """Accumulated wall-clock per driver phase (suggest / evaluate / ...).

    Thread-safe: the driver loop owns one, but the optimization service
    records into a shared instance from concurrent handler threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name, span=None):
        """Time the block under ``name`` on ``time.monotonic()``.  With
        ``span`` given and a trace bound to this thread, the block is also
        a tracing span of that name (the ``with`` target; else the no-op
        span), and the phase takes the span's own clock reads: the spans'
        and the phase's totals agree exactly."""
        sp = tracing.NULL_SPAN
        t0 = time.monotonic()
        try:
            with tracing.span(span) if span is not None else tracing.NULL_SPAN as sp:
                yield sp
        finally:
            seconds = sp.duration_s
            self.record(name, time.monotonic() - t0 if seconds is None else seconds)

    def record(self, name, seconds):
        with self._lock:
            self._total[name] += seconds
            self._count[name] += 1

    def summary(self):
        with self._lock:
            totals = dict(self._total)
            counts = dict(self._count)
        return {
            name: {
                "total_s": round(totals[name], 6),
                "count": counts[name],
                "mean_ms": round(1e3 * totals[name] / max(counts[name], 1), 3),
            }
            for name in sorted(totals)
        }

    def log_summary(self, level=logging.INFO):
        for name, stats in self.summary().items():
            logger.log(
                level,
                "phase %-12s total %8.3fs  n=%-5d mean %8.3fms",
                name,
                stats["total_s"],
                stats["count"],
                stats["mean_ms"],
            )



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
      recovery activity (``resilience.device.DeviceRecovery``; the port
      has no CPU fallback, so ``cpu_fallback`` stays 0)
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


# Fixed histogram bucket upper bounds (seconds) for suggest latency —
# log-spaced from sub-millisecond out to a minute, the reference's edges
# so the two packages' histograms compare bucket for bucket; +Inf implied.
SUGGEST_DURATION_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


# Fixed histogram bucket upper bounds (seconds) for store fsync latency
# — local SSDs fsync in fractions of a millisecond, NFS/GCS-fuse mounts
# in tens to hundreds; the tail past 1 s is the "storage plane is the
# bottleneck" evidence the segmented-store roadmap item needs.
FSYNC_DURATION_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


def quantile_from_counts(edges, counts, q):
    """The q-quantile of a fixed-bucket histogram given per-bucket (NOT
    cumulative) counts — shared by :class:`LatencyHistogram` and the SLO
    engine's window deltas (a window histogram is the elementwise
    difference of two cumulative snapshots).  ``counts`` has one more
    entry than ``edges`` (the +Inf bucket); observations there report
    the last finite edge (a floor).  None when empty."""
    total = sum(counts)
    if not total:
        return None
    rank = q * total
    seen = 0.0
    lo = 0.0
    for i, edge in enumerate(edges):
        n = counts[i]
        if seen + n >= rank:
            if n == 0:
                return edge
            frac = (rank - seen) / n
            return lo + frac * (edge - lo)
        seen += n
        lo = edge
    return edges[-1] if edges else None


class LatencyHistogram:
    """A fixed-bucket latency histogram (the Prometheus histogram
    shape: cumulative ``_bucket{le=...}`` counts + ``_sum``/``_count``).

    Unlike a bounded percentile ring buffer, bucket counts never evict:
    the exported p99 is the p99 of EVERY observation, not "p99 of the
    last N" — under load a ring silently narrows its window exactly when
    the tail matters most.  Quantiles are interpolated within the
    containing bucket (exact at bucket edges, monotone in between).

    NOT thread-safe on its own; the owner (:class:`StoreStats`, the
    service's stats once ported) serializes access under its lock.
    """

    def __init__(self, buckets=SUGGEST_DURATION_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(self.buckets)
        # counts[i] = observations <= buckets[i]; counts[-1] = +Inf bucket
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0
        self.sum_s = 0.0

    def observe(self, seconds: float):
        s = float(seconds)
        self.total += 1
        self.sum_s += s
        for i, edge in enumerate(self.buckets):
            if s <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float):
        """The q-quantile in seconds (None when empty), linearly
        interpolated inside the containing bucket.  The +Inf bucket has
        no upper edge; observations there report the last finite edge
        (a floor — the true value is at least that)."""
        return quantile_from_counts(self.buckets, self.counts, q)

    def state(self) -> dict:
        """A diffable snapshot: per-bucket (non-cumulative) counts plus
        total/sum — what the SLO engine stores per tick so a window's
        histogram is the elementwise difference of two snapshots."""
        return {
            "edges": self.buckets,
            "counts": list(self.counts),
            "total": self.total,
            "sum_s": self.sum_s,
        }

    def to_dict(self) -> dict:
        """Cumulative bucket counts keyed by upper edge (the Prometheus
        exposition shape), plus sum/count."""
        cum, acc = [], 0
        for i, edge in enumerate(self.buckets):
            acc += self.counts[i]
            cum.append((edge, acc))
        cum.append((float("inf"), acc + self.counts[-1]))
        return {"buckets": cum, "count": self.total, "sum_s": self.sum_s}



class ServiceStats:
    """Request / latency / batch-occupancy accounting for the
    optimization service (:mod:`hyperopt_tpu_torch.service`).

    Tracks, per endpoint, how many requests were served and how many
    were rejected with backpressure; per study, how many suggests were
    served; and for the continuous-batching scheduler, how many fused
    device dispatches ran and how many suggest requests each one
    carried (``mean_batch_occupancy`` — the "requests per device
    program" number the service exists to push above 1).

    Suggest latency lives in a fixed-bucket :class:`LatencyHistogram`
    (the exported source of truth — no eviction, so p99 means p99 of
    everything) with per-phase attributed-seconds counters fed by the
    scheduler, plus a bounded ring sample kept only for the human
    ``/v1/status`` JSON (its quantiles are "of the last N" and say so).
    Idempotent replays are tagged and excluded from latency — a journal
    hit must not fake a fast suggest or mask a slow one.

    Thread-safe: HTTP handler threads and the scheduler thread record
    concurrently.
    """

    def __init__(self, max_latency_samples=65536):
        from collections import deque

        self._lock = threading.Lock()
        self._requests = defaultdict(int)       # endpoint -> served
        self._rejected = defaultdict(int)       # endpoint -> 429s
        self._errors = defaultdict(int)         # endpoint -> 5xx/504s
        self._replayed = defaultdict(int)       # endpoint -> journal hits
        self._study_suggests = defaultdict(int)  # study -> suggests served
        # the exported latency source of truth: fixed buckets, no window
        self._suggest_hist = LatencyHistogram()
        # the warm/cold split: every suggest lands in the union histogram
        # above AND in exactly one of these — "cold" means the fused
        # dispatch that served it carried a compile event (first-touch:
        # see hyperopt_tpu_torch.compile_ledger), "warm" is steady state
        self._suggest_hist_warm = LatencyHistogram()
        self._suggest_hist_cold = LatencyHistogram()
        # ring buffer: a bounded human-readable sample of RECENT traffic
        # for /v1/status only (window size is reported alongside)
        self._suggest_latencies = deque(maxlen=int(max_latency_samples))
        # per-phase attributed seconds (queue_wait/coalesce/prepare/
        # dispatch/readback/finish/inline), fed by the scheduler
        self._phase_s = defaultdict(float)
        self._phase_n = defaultdict(int)
        # compile events (the first dispatch in the process of a program
        # key, see hyperopt_tpu_torch.compile_ledger) keyed by
        # (trial-bucket, families);
        # request-path events counted separately (background warmup/
        # containment compiles are excluded from cold attribution)
        self._compile_events = defaultdict(int)
        self._n_request_compile_events = 0
        self._n_dispatches = 0        # fused device programs launched
        self._n_batched = 0           # suggests served through a dispatch
        self._n_inline = 0            # host-side suggests (startup/rand)
        self._dispatch_s = 0.0
        self._queue_depth = 0         # last-observed scheduler queue depth
        # cumulative depth accounting: every observation adds to the
        # sum, so a window delta (sum/samples) yields the MEAN depth
        # over that window — the controller's objective term.  Sampled
        # at request arrival AND at batch dispatch (a quiet tenant's
        # drained queue is an observation too, not a blind spot).
        self._queue_depth_sum = 0     # sum of observed depths
        self._queue_depth_samples = 0  # number of observations
        self._n_studies = 0
        # compile-plane accounting (hyperopt_tpu_torch.compile_ledger):
        # cold suggests overall, cold suggests AFTER the service first
        # reported ready (the SL607 numerator — post-warmup the request
        # path must pay ~zero compiles), and host-side cold-containment
        # fallbacks served while a compile proceeded off-thread
        self._n_cold_suggests = 0
        self._n_cold_after_ready = 0
        self._n_cold_fallbacks = 0
        self._ready = False           # latched by mark_ready()

    def record_request(self, endpoint: str, seconds=None, study=None,
                       replay=False, cold=False):
        """``replay=True`` marks a response served from the idempotency
        journal: counted as a request, NEVER as a latency observation
        (journal hits are instant and would dilute the histogram's
        tail exactly when retries spike).  ``cold=True`` marks a suggest
        whose fused dispatch carried a compile event: it lands in the
        union histogram AND the cold split (warm otherwise)."""
        with self._lock:
            self._requests[endpoint] += 1
            if endpoint == "suggest" and not replay:
                if study is not None:
                    self._study_suggests[str(study)] += 1
                if cold:
                    self._n_cold_suggests += 1
                    if self._ready:
                        self._n_cold_after_ready += 1
                if seconds is not None:
                    self._suggest_hist.observe(float(seconds))
                    split = (
                        self._suggest_hist_cold if cold
                        else self._suggest_hist_warm
                    )
                    split.observe(float(seconds))
                    self._suggest_latencies.append(float(seconds))

    def mark_ready(self):
        """Latch "the service has reported ready": cold suggests from
        here on count against SL607 (a compile in the request path
        after warmup is the failure the warmup exists to prevent).

        Armed by the first GREEN ``/readyz`` evaluation — deliberately:
        an embedded service that is never readiness-probed keeps SL607
        in ``no_data``, because without a readiness barrier its traffic
        legitimately interleaves with first-touch compiles (a short
        in-process campaign runs ~10% cold organically, and paging on
        that would punish correct behavior).  Serving deployments
        always probe ``/readyz`` (``wait_ready``, k8s), which is
        exactly the population the rule guards."""
        with self._lock:
            self._ready = True

    def record_cold_fallback(self):
        """One suggest served host-side (cold containment) while its
        unwarmed fused program compiled off-thread."""
        with self._lock:
            self._n_cold_fallbacks += 1

    @property
    def n_cold_fallbacks(self) -> int:
        with self._lock:
            return self._n_cold_fallbacks

    def record_rejection(self, endpoint: str):
        with self._lock:
            self._rejected[endpoint] += 1

    def record_error(self, endpoint: str):
        """A request that failed server-side (5xx/504) — the numerator
        of the SL603 error-rate objective, next to backpressure 429s."""
        with self._lock:
            self._errors[endpoint] += 1

    def record_replay(self, endpoint: str):
        """A retried request answered from the idempotency journal —
        exactly-once doing its job (no seed consumed, no state change)."""
        with self._lock:
            self._replayed[endpoint] += 1

    def record_dispatch(self, n_requests: int, seconds: float):
        """One fused device program carrying ``n_requests`` suggests."""
        with self._lock:
            self._n_dispatches += 1
            self._n_batched += int(n_requests)
            self._dispatch_s += float(seconds)

    def record_phase(self, phase: str, seconds: float, n: int = 1):
        """Attribute ``seconds`` of suggest wall-time to a named phase
        (the histogram's per-phase sums — always on, tracing or not)."""
        with self._lock:
            self._phase_s[str(phase)] += float(seconds)
            self._phase_n[str(phase)] += int(n)

    def record_compile(self, bucket, families, background=False):
        """One compile event of the fused suggest program, keyed by its
        (trial-count bucket, family composition).  ``background=True``
        marks an off-request-path compile (AOT warmup replay, cold-
        containment background thread): counted in the per-key event
        map but excluded from :attr:`n_compile_events`, so a request
        that merely OVERLAPPED it is never attributed cold."""
        with self._lock:
            self._compile_events[(int(bucket), str(families))] += 1
            if not background:
                self._n_request_compile_events += 1

    @property
    def n_compile_events(self) -> int:
        """Request-path compile events only (the cold-attribution
        delta); the full per-key map is :meth:`compile_events`."""
        with self._lock:
            return self._n_request_compile_events

    def record_inline(self, n: int = 1):
        """Suggests served host-side (random startup) — no device
        program, so they count toward requests but not occupancy."""
        with self._lock:
            self._n_inline += int(n)

    def set_queue_depth(self, n: int):
        with self._lock:
            self._queue_depth = int(n)
            self._queue_depth_sum += int(n)
            self._queue_depth_samples += 1

    def set_n_studies(self, n: int):
        with self._lock:
            self._n_studies = int(n)

    @property
    def mean_batch_occupancy(self):
        with self._lock:
            if not self._n_dispatches:
                return None
            return self._n_batched / self._n_dispatches

    def latency_quantiles(self):
        """{"p50_ms": ..., "p99_ms": ...} over the FULL histogram — the
        exported source of truth (bucket-interpolated, no eviction)."""
        with self._lock:
            p50 = self._suggest_hist.quantile(0.50)
            p99 = self._suggest_hist.quantile(0.99)
        return {
            "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
            "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        }

    @staticmethod
    def _split_quantiles(hist):
        p50, p99 = hist.quantile(0.50), hist.quantile(0.99)
        return {
            "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
            "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
            "count": hist.total,
        }

    def split_latency_quantiles(self):
        """{"warm": {...}, "cold": {...}} — the first-touch (compile-
        carrying) vs steady-state attribution of the suggest latency."""
        with self._lock:
            return {
                "warm": self._split_quantiles(self._suggest_hist_warm),
                "cold": self._split_quantiles(self._suggest_hist_cold),
            }

    def warm_hist_state(self) -> dict:
        """Diffable snapshot of the STEADY-STATE (compile-excluded)
        suggest histogram — the SLO engine's latency-rule input
        (compile-carrying dispatches are real cost but meaningless
        steady-state latency)."""
        with self._lock:
            return self._suggest_hist_warm.state()

    def slo_counters(self) -> dict:
        """The scalar counters the SLO engine snapshots per tick.
        ``requests_mutating`` counts only the suggest/report/create
        routes — the SL603 denominator must not be diluted by a
        dashboard polling /v1/alerts or /metrics between incidents."""
        with self._lock:
            mutating = ("suggest", "report", "create_study")
            return {
                "requests_suggest": self._requests.get("suggest", 0),
                "requests_mutating": sum(
                    self._requests.get(e, 0) for e in mutating
                ),
                "requests_total": sum(self._requests.values()),
                "rejected_total": sum(self._rejected.values()),
                # numerator and denominator must cover the SAME routes:
                # a flaky read-only endpoint's 500s would otherwise
                # overstate the mutating error rate
                "errors_mutating": sum(
                    self._errors.get(e, 0) for e in mutating
                ),
                "errors_total": sum(self._errors.values()),
                # compile-plane counters (SL607 + cold containment)
                "suggests_cold": self._n_cold_suggests,
                "suggests_cold_after_ready": self._n_cold_after_ready,
                "cold_fallbacks": self._n_cold_fallbacks,
                # cumulative queue-depth accounting: a window delta of
                # sum/samples is the mean depth over that window (the
                # control plane's backlog objective term)
                "queue_depth_sum": self._queue_depth_sum,
                "queue_depth_samples": self._queue_depth_samples,
            }

    def window_quantiles(self):
        """Ring-buffer quantiles over the last-N sample — the HUMAN
        numbers for /v1/status, with the window size spelled out so
        "p99" can never be silently read as all-time."""
        import numpy as np

        with self._lock:
            lat = list(self._suggest_latencies)
            cap = self._suggest_latencies.maxlen
        if not lat:
            return {"p50_ms": None, "p99_ms": None,
                    "window": 0, "max_window": cap}
        arr = np.asarray(lat)
        return {
            "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3),
            "window": len(lat),
            "max_window": cap,
        }

    def phase_summary(self) -> dict:
        with self._lock:
            return {
                phase: {
                    "total_s": round(self._phase_s[phase], 6),
                    "count": self._phase_n[phase],
                }
                for phase in sorted(self._phase_s)
            }

    def compile_events(self) -> dict:
        """{"<bucket>/<families>": count} snapshot."""
        with self._lock:
            return {
                f"{bucket}/{families}": n
                for (bucket, families), n in sorted(
                    self._compile_events.items()
                )
            }

    def histogram_dict(self) -> dict:
        with self._lock:
            return self._suggest_hist.to_dict()

    def summary(self) -> dict:
        q = self.latency_quantiles()
        split = self.split_latency_quantiles()
        window = self.window_quantiles()
        phases = self.phase_summary()
        compiles = self.compile_events()
        with self._lock:
            occ = (
                self._n_batched / self._n_dispatches
                if self._n_dispatches
                else None
            )
            return {
                "requests": dict(sorted(self._requests.items())),
                "rejected": dict(sorted(self._rejected.items())),
                "errors": dict(sorted(self._errors.items())),
                "idempotent_replays": dict(sorted(self._replayed.items())),
                "study_suggests": dict(sorted(self._study_suggests.items())),
                "n_dispatches": self._n_dispatches,
                "n_batched_suggests": self._n_batched,
                "n_inline_suggests": self._n_inline,
                "mean_batch_occupancy": (
                    round(occ, 4) if occ is not None else None
                ),
                "dispatch_s": round(self._dispatch_s, 6),
                "queue_depth": self._queue_depth,
                "queue_depth_mean": (
                    round(
                        self._queue_depth_sum
                        / self._queue_depth_samples, 4,
                    )
                    if self._queue_depth_samples else None
                ),
                "n_studies": self._n_studies,
                "n_cold_suggests": self._n_cold_suggests,
                "n_cold_after_ready": self._n_cold_after_ready,
                "n_cold_fallbacks": self._n_cold_fallbacks,
                # histogram-derived (all observations ever)
                "suggest_latency": q,
                # first-touch (compile-carrying) vs steady-state split
                "suggest_latency_warm": split["warm"],
                "suggest_latency_cold": split["cold"],
                # ring-derived (recent window; human eyes only)
                "suggest_latency_window": window,
                "phase_seconds": phases,
                "compile_events": compiles,
            }

    def log_summary(self, level=logging.INFO):
        s = self.summary()
        logger.log(
            level,
            "service: requests=%s rejected=%s dispatches=%d occupancy=%s "
            "p50=%sms p99=%sms",
            s["requests"],
            s["rejected"],
            s["n_dispatches"],
            s["mean_batch_occupancy"],
            s["suggest_latency"]["p50_ms"],
            s["suggest_latency"]["p99_ms"],
        )


class DeviceStats:
    """Per-dispatch device-plane accounting for the roofline profiler
    (:mod:`hyperopt_tpu_torch.profiling`).

    Every fused suggest dispatch an installed
    :class:`~hyperopt_tpu_torch.profiling.DeviceProfiler` observes lands here
    as one record: host-observed device seconds, modeled FLOPs and HBM
    bytes, achieved TFLOP/s and GB/s, and the roofline attribution —
    WHICH ceiling binds the program (HBM bandwidth vs peak FLOP/s) and
    what fraction of that binding ceiling it achieved.  Aggregates:

    - **duty cycle** — device-busy seconds over wall seconds since this
      stats object started (host-observed dispatch->resolve intervals;
      exact on the sync/service paths, an upper bound under
      speculative overlap);
    - **binding-ceiling histogram** — dispatch counts per ceiling, the
      one-line answer to "is this workload bandwidth- or compute-
      bound";
    - **memory watermarks** — the high-water of live program bytes
      (inputs + output of a dispatch) and, when the backend reports
      one, its peak allocated bytes;
    - a bounded **per-signature table** (the DEVICE_PROFILE.json
      roofline table): per fused-program signature, dispatch count,
      mean device time, cost, and mean/last roofline attribution.

    Thread-safe: resolver callbacks record from scheduler/driver
    threads while ``/metrics`` renders concurrently.
    """

    MAX_SIGNATURES = 128
    MAX_RECENT = 128

    def __init__(self):
        from collections import deque

        self._lock = threading.Lock()
        # bounded ring of the most recent dispatch records — the flight
        # recorder's device-plane evidence at breach time
        self._recent = deque(maxlen=self.MAX_RECENT)  # guarded-by: _lock
        self._t_started = time.monotonic()
        self._n_dispatches = 0  # guarded-by: _lock
        self._n_requests = 0  # guarded-by: _lock
        self._busy_s = 0.0  # guarded-by: _lock
        self._launch_s = 0.0  # guarded-by: _lock
        self._readback_s = 0.0  # guarded-by: _lock
        self._flops_total = 0.0  # guarded-by: _lock
        self._bytes_total = 0.0  # guarded-by: _lock
        self._n_compiled = 0  # guarded-by: _lock
        self._ceiling_counts = defaultdict(int)  # guarded-by: _lock
        # roofline-percent aggregation over STEADY-STATE dispatches only
        # (a record tagged ``compiled`` timed a compile inside its
        # interval — real cost, meaningless throughput)
        self._pct_sum = defaultdict(float)  # guarded-by: _lock
        self._pct_n = defaultdict(int)  # guarded-by: _lock
        self._live_bytes_hw = 0  # guarded-by: _lock
        self._backend_peak_bytes = None  # guarded-by: _lock
        self._sigs = {}  # guarded-by: _lock
        self._sig_drops = 0  # guarded-by: _lock
        self._last = None  # guarded-by: _lock
        # per-device split (mesh execution mode): busy seconds and
        # dispatch counts per chip label ('<platform>:<id>') — a
        # dispatch's device interval is attributed to EVERY chip its
        # program spanned, so a chip left out of the mesh (or only
        # reached by single-chip traffic) shows as the cold/hot one
        # instead of blending into one average.  Allocator peaks are
        # genuinely per-chip (each device reports its own memory_stats).
        self._busy_by_device = defaultdict(float)  # guarded-by: _lock
        self._n_by_device = defaultdict(int)  # guarded-by: _lock
        self._live_hw_by_device = defaultdict(int)  # guarded-by: _lock
        self._backend_peak_by_device = {}  # guarded-by: _lock

    def record_dispatch(self, rec: dict):
        """One completed fused dispatch (record shape documented in
        :meth:`hyperopt_tpu_torch.profiling.DeviceProfiler._observe`)."""
        device_s = float(rec.get("device_s") or 0.0)
        ceiling = rec.get("binding_ceiling")
        pct = rec.get("roofline_pct")
        live = int(rec.get("live_bytes") or 0)
        compiled = bool(rec.get("compiled"))
        with self._lock:
            self._n_dispatches += 1
            self._n_requests += int(rec.get("n_requests") or 1)
            self._n_compiled += int(compiled)
            self._busy_s += device_s
            self._launch_s += float(rec.get("launch_s") or 0.0)
            self._readback_s += float(rec.get("readback_s") or 0.0)
            self._flops_total += float(rec.get("flops") or 0.0)
            self._bytes_total += float(rec.get("hbm_bytes") or 0.0)
            if ceiling is not None:
                # the ceiling classification is pure arithmetic
                # intensity — timing-independent, so compiled
                # dispatches count here too
                self._ceiling_counts[str(ceiling)] += 1
                if pct is not None and not compiled:
                    self._pct_sum[str(ceiling)] += float(pct)
                    self._pct_n[str(ceiling)] += 1
            if live > self._live_bytes_hw:
                self._live_bytes_hw = live
            # a device repeated over mesh slots counts once per dispatch
            for dev in dict.fromkeys(str(d) for d in rec.get("devices") or ()):
                self._busy_by_device[dev] += device_s
                self._n_by_device[dev] += 1
                # upper bound per chip: replicated history buffers are
                # resident full-size on every mesh device; only the
                # sharded scoring intermediates split
                if live > self._live_hw_by_device[dev]:
                    self._live_hw_by_device[dev] = live
            self._last = dict(rec)
            self._recent.append(dict(rec))
            sig = str(rec.get("sig", "?"))
            agg = self._sigs.get(sig)
            if agg is None:
                if len(self._sigs) >= self.MAX_SIGNATURES:
                    self._sig_drops += 1
                    return
                agg = self._sigs[sig] = {
                    "n": 0, "n_requests": 0, "n_compiled": 0,
                    "steady_s": 0.0, "n_steady": 0, "any_s": 0.0,
                    "pct_sum": 0.0, "ceilings": defaultdict(int),
                    "last": None, "last_any": None,
                }
            agg["n"] += 1
            agg["n_requests"] += int(rec.get("n_requests") or 1)
            agg["n_compiled"] += int(compiled)
            agg["any_s"] += device_s
            agg["last_any"] = dict(rec)
            if not compiled:
                agg["steady_s"] += device_s
                agg["n_steady"] += 1
                if pct is not None:
                    agg["pct_sum"] += float(pct)
                agg["last"] = dict(rec)
            if ceiling is not None:
                agg["ceilings"][str(ceiling)] += 1

    def set_backend_peak_bytes(self, nbytes, device=None):
        """Record the backend allocator's peak (on the card,
        ``torch.cuda.max_memory_allocated``; the CPU reports none).
        With ``device`` (a '<platform>:<id>' label) the peak is ALSO
        tracked per chip — the mesh-mode skew signal."""
        if nbytes is None:
            return
        with self._lock:
            if (
                self._backend_peak_bytes is None
                or nbytes > self._backend_peak_bytes
            ):
                self._backend_peak_bytes = int(nbytes)
            if device is not None:
                prev = self._backend_peak_by_device.get(str(device))
                if prev is None or nbytes > prev:
                    self._backend_peak_by_device[str(device)] = int(nbytes)

    @property
    def n_dispatches(self) -> int:
        with self._lock:
            return self._n_dispatches

    def last_record(self):
        with self._lock:
            return dict(self._last) if self._last is not None else None

    def recent_records(self) -> list:
        """The last ``MAX_RECENT`` dispatch records, oldest first (a
        snapshot) — pulled by the flight recorder at dump time."""
        with self._lock:
            return [dict(r) for r in self._recent]

    def slo_counters(self) -> dict:
        """The scalar counters the SLO engine snapshots per tick."""
        with self._lock:
            return {
                "busy_s": self._busy_s,
                "dispatches": self._n_dispatches,
            }

    def duty_cycle(self):
        """Device-busy fraction of wall time since this object started
        (None before the first dispatch); clamped at 1.0 — overlapping
        host-observed intervals cannot mean >100% busy."""
        with self._lock:
            busy = self._busy_s
            n = self._n_dispatches
        if not n:
            return None
        elapsed = time.monotonic() - self._t_started
        return min(busy / elapsed, 1.0) if elapsed > 0 else None

    def duty_cycle_by_device(self) -> dict:
        """{device_label: busy fraction of wall time} over the chips
        any observed dispatch spanned (same clamp semantics as the
        blended :meth:`duty_cycle`)."""
        with self._lock:
            busy = dict(self._busy_by_device)
        elapsed = time.monotonic() - self._t_started
        if elapsed <= 0:
            return {}
        return {
            dev: min(b / elapsed, 1.0) for dev, b in sorted(busy.items())
        }

    def per_device(self) -> dict:
        """The per-chip telemetry rows: busy seconds, dispatch count,
        duty cycle, live-buffer high-water (upper bound — replicated
        buffers are full-size per chip), and the chip's own allocator
        peak when the backend reports one."""
        duty = self.duty_cycle_by_device()
        with self._lock:
            labels = set(self._busy_by_device) | set(
                self._backend_peak_by_device
            )
            return {
                dev: {
                    "busy_s": round(self._busy_by_device.get(dev, 0.0), 6),
                    "n_dispatches": self._n_by_device.get(dev, 0),
                    "duty_cycle": (
                        round(duty[dev], 6) if dev in duty else None
                    ),
                    "live_buffer_highwater_bytes": (
                        self._live_hw_by_device.get(dev, 0)
                    ),
                    "backend_peak_bytes": (
                        self._backend_peak_by_device.get(dev)
                    ),
                }
                for dev in sorted(labels)
            }

    def ceiling_counts(self) -> dict:
        with self._lock:
            return dict(sorted(self._ceiling_counts.items()))

    def mean_roofline_pct(self) -> dict:
        """{ceiling: mean roofline_pct over the STEADY-STATE dispatches
        it bound} (compile-carrying dispatches excluded)."""
        with self._lock:
            return {
                c: self._pct_sum[c] / n
                for c, n in sorted(self._pct_n.items())
                if n
            }

    def signature_table(self) -> list:
        """The per-signature roofline table, most-dispatched first.
        Rows prefer steady-state records; a signature whose only
        dispatches carried a compile falls back to those (flagged by
        ``steady: false``) — either way every row reports a non-null
        binding ceiling and roofline_pct (the DEVICE_PROFILE
        acceptance gate)."""
        with self._lock:
            rows = []
            for sig, agg in self._sigs.items():
                steady = agg["n_steady"] > 0
                last = (agg["last"] if steady else agg["last_any"]) or {}
                mean_s = (
                    agg["steady_s"] / agg["n_steady"] if steady
                    else agg["any_s"] / max(agg["n"], 1)
                )
                rows.append({
                    "sig": sig,
                    "n_dispatches": agg["n"],
                    "n_compile_dispatches": agg["n_compiled"],
                    "n_requests": agg["n_requests"],
                    "steady": steady,
                    "device_ms_mean": round(mean_s * 1e3, 4),
                    "flops_per_dispatch": last.get("flops"),
                    "mxu_flops_per_dispatch": last.get("mxu_flops"),
                    "hbm_bytes_per_dispatch": last.get("hbm_bytes"),
                    "ai_flops_per_byte": last.get("ai_flops_per_byte"),
                    "achieved_tflops": last.get("achieved_tflops"),
                    "achieved_GBps": last.get("achieved_GBps"),
                    "binding_ceiling": last.get("binding_ceiling"),
                    "roofline_pct": last.get("roofline_pct"),
                    "roofline_pct_mean": round(
                        agg["pct_sum"] / agg["n_steady"], 4
                    ) if steady else last.get("roofline_pct"),
                    "ceilings": dict(sorted(agg["ceilings"].items())),
                    "cost_source": last.get("cost_source"),
                })
        rows.sort(key=lambda r: -r["n_dispatches"])
        return rows

    def summary(self) -> dict:
        duty = self.duty_cycle()
        pct = self.mean_roofline_pct()
        table = self.signature_table()
        per_device = self.per_device()
        with self._lock:
            return {
                "n_dispatches": self._n_dispatches,
                "n_requests": self._n_requests,
                "n_compile_dispatches": self._n_compiled,
                "busy_s": round(self._busy_s, 6),
                "launch_s": round(self._launch_s, 6),
                "readback_s": round(self._readback_s, 6),
                "duty_cycle": round(duty, 6) if duty is not None else None,
                "flops_total": self._flops_total,
                "hbm_bytes_total": self._bytes_total,
                "binding_ceiling_counts": dict(
                    sorted(self._ceiling_counts.items())
                ),
                "roofline_pct_mean": {
                    k: round(v, 4) for k, v in pct.items()
                },
                "memory": {
                    "live_buffer_highwater_bytes": self._live_bytes_hw,
                    "backend_peak_bytes": self._backend_peak_bytes,
                },
                "per_device": per_device,
                "signatures": table,
                "signature_drops": self._sig_drops,
            }

    def log_summary(self, level=logging.INFO):
        s = self.summary()
        if not s["n_dispatches"]:
            return
        logger.log(
            level,
            "device: dispatches=%d duty=%s GB=%.3f ceilings=%s "
            "roofline_pct=%s",
            s["n_dispatches"],
            s["duty_cycle"],
            s["hbm_bytes_total"] / 1e9,
            s["binding_ceiling_counts"],
            s["roofline_pct_mean"],
        )


class StoreStats:
    """Storage-plane accounting for the FileTrials queue, the response
    journal, and the lease protocol.

    Every durability-relevant filesystem operation lands here:

    - **fsyncs** — count + fixed-bucket latency histogram + bytes, by
      ``kind`` (``doc``/``segment``/``journal``/``attachment``/
      ``counter``/``lease``/``bundle``) — the SL606 objective's input;
    - **segments** — appends (write calls vs records: the group-commit
      ratio), seals, compactions, O(delta) replays + their record
      counts, torn records, and replica pulls of the segmented trial
      store (the committed before/after proof for the per-doc →
      segment migration);
    - **doc writes** — trial-doc inserts/rewrites and their encoded
      bytes (reconciles against trial counts: one insert + one result
      write per completed trial on the service path);
    - **directory scans** — every O(N) ``all_docs``/native state scan,
      with entries scanned (the cost ``refresh_local`` exists to dodge);
    - **refreshes** — local (in-memory recompute) vs full (disk
      re-read); the local hit rate is the single-writer fast path
      working as designed;
    - **journal** — appends/bytes/compactions/torn lines of the
      exactly-once response journal;
    - **leases** — grants/renewals/reaps/clears;
    - **quarantines** — torn docs moved aside by ``_read_doc``.

    A bounded ring of recent notable ops (every fsync, with kind,
    latency, and bytes) feeds the flight recorder at dump time.

    Thread-safe: handler/scheduler/reaper/worker threads record while
    ``/metrics`` renders concurrently.
    """

    MAX_RECENT_OPS = 256

    # lock-order: _lock
    def __init__(self):
        from collections import deque

        self._lock = threading.Lock()
        self._fsync_hist = LatencyHistogram(FSYNC_DURATION_BUCKETS)  # guarded-by: _lock
        self._fsync_kinds = defaultdict(int)  # guarded-by: _lock
        self._fsync_bytes = 0  # guarded-by: _lock
        self._doc_writes = 0  # guarded-by: _lock
        self._doc_write_bytes = 0  # guarded-by: _lock
        self._attachment_writes = 0  # guarded-by: _lock
        self._attachment_bytes = 0  # guarded-by: _lock
        self._scans = 0  # guarded-by: _lock
        self._scan_entries = 0  # guarded-by: _lock
        self._refresh_local = 0  # guarded-by: _lock
        self._refresh_full = 0  # guarded-by: _lock
        self._journal_appends = 0  # guarded-by: _lock
        self._journal_bytes = 0  # guarded-by: _lock
        self._journal_compactions = 0  # guarded-by: _lock
        self._journal_torn = 0  # guarded-by: _lock
        self._lease_events = defaultdict(int)  # guarded-by: _lock
        self._quarantined = 0  # guarded-by: _lock
        # segmented trial store (parallel.segment_store)
        self._segment_appends = 0  # guarded-by: _lock  (write calls)
        self._segment_records = 0  # guarded-by: _lock  (docs appended)
        self._segment_bytes = 0  # guarded-by: _lock
        self._segment_seals = 0  # guarded-by: _lock
        self._segment_compactions = 0  # guarded-by: _lock
        self._segments_retired = 0  # guarded-by: _lock
        self._segment_replays = 0  # guarded-by: _lock  (refresh calls)
        self._segment_replays_full = 0  # guarded-by: _lock
        self._segment_replay_records = 0  # guarded-by: _lock  (delta docs)
        self._segment_torn = 0  # guarded-by: _lock
        self._segments_pulled = 0  # guarded-by: _lock  (replication)
        self._segment_pull_bytes = 0  # guarded-by: _lock
        self._recent_ops = deque(maxlen=self.MAX_RECENT_OPS)  # guarded-by: _lock

    # -- recording -----------------------------------------------------
    def record_fsync(self, seconds: float, kind: str = "doc",
                     nbytes: int = 0):
        with self._lock:
            self._fsync_hist.observe(float(seconds))
            self._fsync_kinds[str(kind)] += 1
            self._fsync_bytes += int(nbytes)
            self._recent_ops.append({
                "op": "fsync", "kind": str(kind),
                "seconds": round(float(seconds), 6),
                "bytes": int(nbytes), "t": time.time(),
            })

    def record_doc_write(self, nbytes: int):
        with self._lock:
            self._doc_writes += 1
            self._doc_write_bytes += int(nbytes)

    def record_attachment_write(self, nbytes: int):
        with self._lock:
            self._attachment_writes += 1
            self._attachment_bytes += int(nbytes)

    def record_scan(self, n_entries: int):
        with self._lock:
            self._scans += 1
            self._scan_entries += int(n_entries)

    def record_refresh(self, local: bool):
        with self._lock:
            if local:
                self._refresh_local += 1
            else:
                self._refresh_full += 1

    def record_journal_append(self, nbytes: int):
        with self._lock:
            self._journal_appends += 1
            self._journal_bytes += int(nbytes)

    def record_journal_compaction(self, nbytes: int = 0):
        with self._lock:
            self._journal_compactions += 1

    def record_journal_torn(self, n: int = 1):
        with self._lock:
            self._journal_torn += int(n)

    def record_segment_append(self, n_records: int, nbytes: int):
        """One segment write call (group commit): ``n_records``
        trial-state transitions landed in ONE O_APPEND write."""
        with self._lock:
            self._segment_appends += 1
            self._segment_records += int(n_records)
            self._segment_bytes += int(nbytes)

    def record_segment_seal(self, n: int = 1):
        with self._lock:
            self._segment_seals += int(n)

    def record_segment_compaction(self, n_retired: int = 0):
        with self._lock:
            self._segment_compactions += 1
            self._segments_retired += int(n_retired)

    def record_segment_replay(self, n_records: int, full: bool = False):
        """One O(delta) tail refresh replaying ``n_records`` docs
        (``full``: a from-scratch replay — initial load or a
        post-compaction epoch change)."""
        with self._lock:
            self._segment_replays += 1
            if full:
                self._segment_replays_full += 1
            self._segment_replay_records += int(n_records)

    def record_segment_torn(self, n: int = 1):
        with self._lock:
            self._segment_torn += int(n)

    def record_segment_pull(self, n_segments: int, nbytes: int):
        """Sealed segments shipped to a replica by SegmentMirror."""
        with self._lock:
            self._segments_pulled += int(n_segments)
            self._segment_pull_bytes += int(nbytes)

    def record_lease(self, event: str, n: int = 1):
        """``event``: grant | renew | reap | clear | quarantine."""
        with self._lock:
            self._lease_events[str(event)] += int(n)

    def record_quarantine(self, n: int = 1):
        with self._lock:
            self._quarantined += int(n)

    # -- reading -------------------------------------------------------
    def fsync_hist_state(self) -> dict:
        with self._lock:
            return self._fsync_hist.state()

    def fsync_histogram_dict(self) -> dict:
        with self._lock:
            return self._fsync_hist.to_dict()

    def slo_counters(self) -> dict:
        """The scalar counters the SLO engine snapshots per tick —
        ``store_bad`` is the SL605 zero-tolerance numerator (torn
        journal lines + quarantined docs)."""
        with self._lock:
            return {
                "store_bad": (
                    self._journal_torn + self._quarantined
                    + self._segment_torn
                ),
                "fsyncs_total": sum(self._fsync_kinds.values()),
            }

    def recent_ops(self) -> list:
        """The last ``MAX_RECENT_OPS`` store operations, oldest first
        (a snapshot) — pulled by the flight recorder at dump time."""
        with self._lock:
            return [dict(o) for o in self._recent_ops]

    def summary(self) -> dict:
        with self._lock:
            p50 = self._fsync_hist.quantile(0.50)
            p99 = self._fsync_hist.quantile(0.99)
            n_refresh = self._refresh_local + self._refresh_full
            return {
                "fsyncs": dict(sorted(self._fsync_kinds.items())),
                "fsyncs_total": sum(self._fsync_kinds.values()),
                "fsync_bytes_total": self._fsync_bytes,
                "fsync_p50_ms": (
                    round(p50 * 1e3, 4) if p50 is not None else None
                ),
                "fsync_p99_ms": (
                    round(p99 * 1e3, 4) if p99 is not None else None
                ),
                "fsync_sum_s": round(self._fsync_hist.sum_s, 6),
                "doc_writes": self._doc_writes,
                "doc_write_bytes": self._doc_write_bytes,
                "attachment_writes": self._attachment_writes,
                "attachment_bytes": self._attachment_bytes,
                "scans": self._scans,
                "scan_entries": self._scan_entries,
                "refresh_local": self._refresh_local,
                "refresh_full": self._refresh_full,
                "refresh_local_hit_rate": (
                    round(self._refresh_local / n_refresh, 4)
                    if n_refresh else None
                ),
                "journal_appends": self._journal_appends,
                "journal_bytes": self._journal_bytes,
                "journal_compactions": self._journal_compactions,
                "journal_torn_lines": self._journal_torn,
                "segment_appends": self._segment_appends,
                "segment_records": self._segment_records,
                "segment_bytes": self._segment_bytes,
                "segment_seals": self._segment_seals,
                "segment_compactions": self._segment_compactions,
                "segments_retired": self._segments_retired,
                "segment_replays": self._segment_replays,
                "segment_replays_full": self._segment_replays_full,
                "segment_replay_records": self._segment_replay_records,
                "segment_torn_lines": self._segment_torn,
                "segments_pulled": self._segments_pulled,
                "segment_pull_bytes": self._segment_pull_bytes,
                "lease_events": dict(sorted(self._lease_events.items())),
                "quarantined_docs": self._quarantined,
            }

    def log_summary(self, level=logging.INFO):
        s = self.summary()
        if not s["fsyncs_total"] and not s["scans"]:
            return
        logger.log(
            level,
            "store: fsyncs=%d (p99 %sms) doc_writes=%d scans=%d "
            "(entries=%d) refresh_local_rate=%s journal_appends=%d",
            s["fsyncs_total"], s["fsync_p99_ms"], s["doc_writes"],
            s["scans"], s["scan_entries"], s["refresh_local_hit_rate"],
            s["journal_appends"],
        )



def build_info() -> dict:
    """{"version", "torch", "cuda", "backend"} — the identity labels of the
    ``hyperopt_build_info`` gauge, so a scrape says WHAT it measured.
    Never initializes CUDA: ``cuda`` is the toolkit torch was built with
    (``torch.version.cuda``, "none" for a CPU build), and ``backend`` is
    "cuda" once this process has initialized CUDA, else "uninitialized"
    (a metrics render must not pay, or hang on, device init)."""
    import torch

    try:
        from . import __version__ as version
    except ImportError:  # pragma: no cover - defensive
        version = "unknown"
    return {
        "version": str(version),
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda or "none"),
        "backend": "cuda" if torch.cuda.is_initialized() else "uninitialized",
    }


# ---------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------


def _prom_escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_value(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def render_prometheus(
    timings: "PhaseTimings" = None,
    speculation: "SpeculationStats" = None,
    faults: "FaultStats" = None,
    service: "ServiceStats" = None,
    device: "DeviceStats" = None,
    study_health: dict = None,
    store: "StoreStats" = None,
    slo: list = None,
    control: dict = None,
    build: dict = None,
    extra: dict = None,
    namespace: str = "hyperopt",
):
    """Render the observability counters in the Prometheus text
    exposition format (version 0.0.4) — the payload of the optimization
    server's ``/metrics`` endpoint, and usable standalone for any run
    that holds these stats objects.

    Every argument is optional; only the sections passed render.
    ``extra`` is a flat ``{metric_suffix: scalar}`` dict rendered as
    gauges (for ad-hoc gauges like process uptime).

    ``study_health``: ``{"rows": [...], "truncated_total": int}`` — the
    per-study search-health gauge block.  Each row is one
    :meth:`hyperopt_tpu_torch.diagnostics.SearchStats.metrics_row` dict; the
    CALLER bounds the row count (top-N studies by recency — see
    ``OptimizationService.metrics_text``), and ``truncated_total``
    counts the studies dropped by that bound so a million-study fleet
    can never blow up the exposition unnoticed.

    ``store``: a :class:`StoreStats` — the storage-plane gauge block.
    ``slo``: a list of SLO rule rows (``hyperopt_tpu_torch.slo.SloEngine
    .metrics_rows``) — status/burn-rate/breaches per SL6xx rule.
    ``control``: the control-plane block
    (``hyperopt_tpu_torch.control.ControlStats.control_metrics``) —
    self-tuning decision counters, the last objective, the frozen
    flag, and the SH5xx admission-reclaim counter.
    ``build``: the :func:`build_info` labels dict — one
    ``hyperopt_build_info{version,torch,cuda,backend} 1`` identity gauge.
    """
    lines = []

    def head(name, help_text, kind):
        lines.append(f"# HELP {namespace}_{name} {help_text}")
        lines.append(f"# TYPE {namespace}_{name} {kind}")

    def sample(name, labels, value):
        if labels:
            lbl = ",".join(
                f'{k}="{_prom_escape(v)}"' for k, v in sorted(labels.items())
            )
            lines.append(f"{namespace}_{name}{{{lbl}}} {_prom_value(value)}")
        else:
            lines.append(f"{namespace}_{name} {_prom_value(value)}")

    if timings is not None:
        summ = timings.summary()
        head("phase_seconds_total", "Accumulated wall-clock per driver phase.", "counter")
        for phase, st in summ.items():
            sample("phase_seconds_total", {"phase": phase}, st["total_s"])
        head("phase_count_total", "Invocations per driver phase.", "counter")
        for phase, st in summ.items():
            sample("phase_count_total", {"phase": phase}, st["count"])

    if speculation is not None:
        s = speculation.summary()
        head("speculation_seconds_total",
             "Pipelined-suggest time split into hidden vs exposed.", "counter")
        sample("speculation_seconds_total", {"kind": "hidden"}, s["hidden_s"])
        sample("speculation_seconds_total", {"kind": "exposed"}, s["exposed_s"])
        head("speculation_events_total",
             "Pipelined-suggest engine event counts.", "counter")
        for key in (
            "n_dispatched", "n_hypothesis", "n_used", "n_invalidated",
            "n_sync", "n_discarded",
        ):
            sample("speculation_events_total", {"event": key[2:]}, s[key])

    if faults is not None:
        counts = faults.counts()
        head("fault_events_total",
             "Fault-tolerance recovery and chaos-injection events.", "counter")
        for event, n in counts.items():
            sample("fault_events_total", {"event": event}, n)
        head("fault_backoff_seconds_total",
             "Accumulated retry-backoff sleep.", "counter")
        sample("fault_backoff_seconds_total", None, faults.backoff_s)

    def histogram(name, help_text, hist_dict):
        head(name, help_text, "histogram")
        for edge, cum in hist_dict["buckets"]:
            le = "+Inf" if edge == float("inf") else repr(float(edge))
            lines.append(f'{namespace}_{name}_bucket{{le="{le}"}} {cum}')
        lines.append(
            f"{namespace}_{name}_sum {_prom_value(hist_dict['sum_s'])}"
        )
        lines.append(f"{namespace}_{name}_count {hist_dict['count']}")

    if service is not None:
        s = service.summary()
        head("service_requests_total", "Requests served per endpoint.", "counter")
        for endpoint, n in s["requests"].items():
            sample("service_requests_total", {"endpoint": endpoint}, n)
        head("service_rejected_total",
             "Requests rejected with backpressure per endpoint.", "counter")
        for endpoint, n in s["rejected"].items():
            sample("service_rejected_total", {"endpoint": endpoint}, n)
        head("service_errors_total",
             "Requests that failed server-side (5xx/504) per endpoint.",
             "counter")
        for endpoint, n in s.get("errors", {}).items():
            sample("service_errors_total", {"endpoint": endpoint}, n)
        head("service_idempotent_replays_total",
             "Retried requests answered from the response journal.",
             "counter")
        for endpoint, n in s.get("idempotent_replays", {}).items():
            sample(
                "service_idempotent_replays_total",
                {"endpoint": endpoint}, n,
            )
        head("service_study_suggests_total",
             "Suggest requests served per study.", "counter")
        for study, n in s["study_suggests"].items():
            sample("service_study_suggests_total", {"study": study}, n)
        head("service_dispatches_total",
             "Fused device suggest programs launched.", "counter")
        sample("service_dispatches_total", None, s["n_dispatches"])
        head("service_batched_suggests_total",
             "Suggest requests served through a fused dispatch.", "counter")
        sample("service_batched_suggests_total", None, s["n_batched_suggests"])
        head("service_inline_suggests_total",
             "Suggest requests served host-side (startup/random).", "counter")
        sample("service_inline_suggests_total", None, s["n_inline_suggests"])
        hist = service.histogram_dict()
        head("service_suggest_duration_seconds",
             "Suggest latency histogram (fixed buckets, no eviction — "
             "the exported quantile source of truth).", "histogram")
        for edge, cum in hist["buckets"]:
            le = "+Inf" if edge == float("inf") else repr(float(edge))
            lines.append(
                f'{namespace}_service_suggest_duration_seconds_bucket'
                f'{{le="{le}"}} {cum}'
            )
        lines.append(
            f"{namespace}_service_suggest_duration_seconds_sum "
            f"{_prom_value(hist['sum_s'])}"
        )
        lines.append(
            f"{namespace}_service_suggest_duration_seconds_count "
            f"{hist['count']}"
        )
        head("service_suggest_phase_seconds_total",
             "Suggest wall-time attributed to a named phase "
             "(queue_wait/coalesce/draw/prepare/dispatch/readback/"
             "finish/inline).", "counter")
        for phase, st in s.get("phase_seconds", {}).items():
            sample("service_suggest_phase_seconds_total",
                   {"phase": phase}, st["total_s"])
        head("compile_events_total",
             "XLA (re)compiles of the fused suggest program, keyed by "
             "(trial-count bucket, family composition).", "counter")
        for key, n in s.get("compile_events", {}).items():
            bucket, _, families = key.partition("/")
            sample("compile_events_total",
                   {"bucket": bucket, "families": families}, n)
        head("service_batch_occupancy",
             "Mean suggest requests per fused device dispatch.", "gauge")
        sample("service_batch_occupancy", None, s["mean_batch_occupancy"])
        head("service_queue_depth", "Scheduler queue depth (last observed).", "gauge")
        sample("service_queue_depth", None, s["queue_depth"])
        head("service_studies", "Registered studies.", "gauge")
        sample("service_studies", None, s["n_studies"])
        head("service_suggest_latency_ms",
             "Suggest latency quantiles derived from the duration "
             "histogram (kept for dashboard compatibility).", "gauge")
        for q_key, q_name in (("p50_ms", "0.5"), ("p99_ms", "0.99")):
            sample(
                "service_suggest_latency_ms",
                {"quantile": q_name},
                s["suggest_latency"][q_key],
            )
        head("service_suggest_split_latency_ms",
             "Suggest latency quantiles split by first-touch attribution "
             "(cold = the fused dispatch carried an XLA compile; warm = "
             "steady state).", "gauge")
        for split in ("warm", "cold"):
            for q_key, q_name in (("p50_ms", "0.5"), ("p99_ms", "0.99")):
                sample(
                    "service_suggest_split_latency_ms",
                    {"split": split, "quantile": q_name},
                    s[f"suggest_latency_{split}"][q_key],
                )
        head("service_suggest_split_total",
             "Suggests served per first-touch attribution class.",
             "counter")
        for split in ("warm", "cold"):
            sample("service_suggest_split_total", {"split": split},
                   s[f"suggest_latency_{split}"]["count"])

    if device is not None:
        s = device.summary()
        head("device_dispatches_total",
             "Fused device programs observed by the roofline profiler.",
             "counter")
        sample("device_dispatches_total", None, s["n_dispatches"])
        head("device_busy_seconds_total",
             "Host-observed device-busy seconds (dispatch to resolve).",
             "counter")
        sample("device_busy_seconds_total", None, s["busy_s"])
        head("device_duty_cycle",
             "Device-busy fraction of wall time since stats start: the "
             "unlabeled series blends all chips; {device=...} series "
             "split per chip (mesh execution mode) — a chip only "
             "reached by single-chip traffic, or skipped by the mesh, "
             "shows as the outlier instead of blending in.", "gauge")
        sample("device_duty_cycle", None, s["duty_cycle"])
        for dev, row in s["per_device"].items():
            if row["duty_cycle"] is not None:
                sample("device_duty_cycle", {"device": dev},
                       row["duty_cycle"])
        head("device_hbm_bytes_total",
             "Modeled HBM bytes moved by observed dispatches.", "counter")
        sample("device_hbm_bytes_total", None, s["hbm_bytes_total"])
        head("device_flops_total",
             "Modeled FLOPs executed by observed dispatches.", "counter")
        sample("device_flops_total", None, s["flops_total"])
        head("device_binding_dispatches_total",
             "Dispatches per binding roofline ceiling "
             "(hbm_bw = bandwidth-bound, flops = compute-bound).",
             "counter")
        for ceiling, n in s["binding_ceiling_counts"].items():
            sample("device_binding_dispatches_total",
                   {"ceiling": ceiling}, n)
        head("device_roofline_pct",
             "Mean achieved fraction (percent) of the BINDING ceiling, "
             "per ceiling, over the dispatches it bound.", "gauge")
        for ceiling, pct in s["roofline_pct_mean"].items():
            sample("device_roofline_pct", {"ceiling": ceiling}, pct)
        head("device_memory_highwater_bytes",
             "Memory high-water: live program buffers (inputs+output of "
             "one dispatch) and backend allocator peak when reported; "
             "{device=...} series split per chip (allocator peaks are "
             "genuinely per-chip; live-buffer rows are an upper bound — "
             "replicated history buffers are full-size on every mesh "
             "device).", "gauge")
        mem = s["memory"]
        sample("device_memory_highwater_bytes",
               {"kind": "live_buffers"},
               mem["live_buffer_highwater_bytes"])
        if mem["backend_peak_bytes"] is not None:
            sample("device_memory_highwater_bytes",
                   {"kind": "backend_peak"}, mem["backend_peak_bytes"])
        for dev, row in s["per_device"].items():
            if row["live_buffer_highwater_bytes"]:
                sample("device_memory_highwater_bytes",
                       {"kind": "live_buffers", "device": dev},
                       row["live_buffer_highwater_bytes"])
            if row["backend_peak_bytes"] is not None:
                sample("device_memory_highwater_bytes",
                       {"kind": "backend_peak", "device": dev},
                       row["backend_peak_bytes"])

    if study_health is not None:
        rows = study_health.get("rows", ())
        gauges = (
            ("study_best_loss", "best_loss",
             "Best (lowest) finite reported loss per study."),
            ("study_regret", "regret",
             "Simple regret (best loss minus the known optimum) per "
             "study; NaN when no optimum was declared."),
            ("study_gamma", "gamma",
             "TPE gamma quantile of the study's latest fused suggest."),
            ("study_n_below", "n_below",
             "Below-set size of the study's latest fused suggest."),
            ("study_ei_max", "ei_max",
             "Max EI log-ratio over candidates, latest fused suggest "
             "(max over dimensions)."),
            ("study_ei_flatness", "ei_flatness",
             "EI landscape flatness (max minus log-mean-exp score; ~0 "
             "means no candidate ranks above any other), mean over "
             "dimensions."),
        )
        for metric, key, help_text in gauges:
            head(metric, help_text, "gauge")
            for row in rows:
                sample(metric, {"study": row["study"]}, row.get(key))
        head("study_health",
             "Per-study SH5xx search-health verdict (1 on the current "
             "state).", "gauge")
        for row in rows:
            sample(
                "study_health",
                {"study": row["study"], "state": row["state"]}, 1,
            )
        head("studies_truncated_total",
             "Studies omitted from the per-study gauge families by the "
             "cardinality bound (top-N by recency).", "counter")
        sample("studies_truncated_total", None,
               study_health.get("truncated_total", 0))

    if store is not None:
        s = store.summary()
        head("store_fsyncs_total",
             "Storage-plane fsyncs by kind (doc/segment/journal/"
             "attachment/counter/lease/bundle).", "counter")
        for kind, n in s["fsyncs"].items():
            sample("store_fsyncs_total", {"kind": kind}, n)
        histogram("store_fsync_duration_seconds",
                  "fsync latency histogram across the storage plane "
                  "(the SL606 objective's input).",
                  store.fsync_histogram_dict())
        head("store_fsync_bytes_total",
             "Bytes written through fsync'd storage-plane writes.",
             "counter")
        sample("store_fsync_bytes_total", None, s["fsync_bytes_total"])
        head("store_doc_writes_total",
             "Trial-doc writes (inserts + state rewrites).", "counter")
        sample("store_doc_writes_total", None, s["doc_writes"])
        head("store_doc_write_bytes_total",
             "Encoded bytes of trial-doc writes.", "counter")
        sample("store_doc_write_bytes_total", None, s["doc_write_bytes"])
        head("store_attachment_writes_total",
             "Attachment blob writes (config, seed cursor, ...).",
             "counter")
        sample("store_attachment_writes_total", None,
               s["attachment_writes"])
        head("store_scans_total",
             "O(N) trial-directory scans (all_docs / native state "
             "scans) — the cost refresh_local exists to dodge.",
             "counter")
        sample("store_scans_total", None, s["scans"])
        head("store_scan_entries_total",
             "Directory entries touched by those scans.", "counter")
        sample("store_scan_entries_total", None, s["scan_entries"])
        head("store_refresh_total",
             "Trials view refreshes: local (in-memory recompute) vs "
             "full (disk re-read).", "counter")
        sample("store_refresh_total", {"kind": "local"},
               s["refresh_local"])
        sample("store_refresh_total", {"kind": "full"}, s["refresh_full"])
        head("store_journal_appends_total",
             "Response-journal record appends (each one fsync'd).",
             "counter")
        sample("store_journal_appends_total", None, s["journal_appends"])
        head("store_journal_bytes_total",
             "Response-journal bytes appended.", "counter")
        sample("store_journal_bytes_total", None, s["journal_bytes"])
        head("store_journal_compactions_total",
             "Response-journal in-place compactions.", "counter")
        sample("store_journal_compactions_total", None,
               s["journal_compactions"])
        head("store_journal_torn_lines_total",
             "Torn response-journal lines seen at load (SL605 input).",
             "counter")
        sample("store_journal_torn_lines_total", None,
               s["journal_torn_lines"])
        head("store_segment_appends_total",
             "Segment-log write calls (each ONE O_APPEND write + one "
             "fsync; a batch of docs group-commits as one).", "counter")
        sample("store_segment_appends_total", None, s["segment_appends"])
        head("store_segment_records_total",
             "Trial-state transitions appended to the segment log.",
             "counter")
        sample("store_segment_records_total", None, s["segment_records"])
        head("store_segment_bytes_total",
             "Bytes appended to the segment log.", "counter")
        sample("store_segment_bytes_total", None, s["segment_bytes"])
        head("store_segment_seals_total",
             "Segments sealed (made immutable and manifest-pinned).",
             "counter")
        sample("store_segment_seals_total", None, s["segment_seals"])
        head("store_segment_compactions_total",
             "Segment-log compactions (latest-doc-per-tid folds).",
             "counter")
        sample("store_segment_compactions_total", None,
               s["segment_compactions"])
        head("store_segments_retired_total",
             "Segments retired (unlinked) by compaction.", "counter")
        sample("store_segments_retired_total", None,
               s["segments_retired"])
        head("store_segment_replays_total",
             "O(delta) segment-tail refreshes, by scope.", "counter")
        sample("store_segment_replays_total", {"scope": "delta"},
               s["segment_replays"] - s["segment_replays_full"])
        sample("store_segment_replays_total", {"scope": "full"},
               s["segment_replays_full"])
        head("store_segment_replay_records_total",
             "Docs replayed by segment-tail refreshes (the delta cost "
             "that replaces O(N) directory scans).", "counter")
        sample("store_segment_replay_records_total", None,
               s["segment_replay_records"])
        head("store_segment_torn_lines_total",
             "Torn segment records seen at replay (SL605 input).",
             "counter")
        sample("store_segment_torn_lines_total", None,
               s["segment_torn_lines"])
        head("store_segments_pulled_total",
             "Sealed segments pulled by replica mirrors.", "counter")
        sample("store_segments_pulled_total", None, s["segments_pulled"])
        head("store_segment_pull_bytes_total",
             "Bytes shipped to replica mirrors as sealed segments.",
             "counter")
        sample("store_segment_pull_bytes_total", None,
               s["segment_pull_bytes"])
        head("store_lease_events_total",
             "Lease protocol events (grant/renew/reap/clear).", "counter")
        for event, n in s["lease_events"].items():
            sample("store_lease_events_total", {"event": event}, n)
        head("store_quarantined_docs_total",
             "Torn trial docs quarantined by the reader (SL605 input).",
             "counter")
        sample("store_quarantined_docs_total", None, s["quarantined_docs"])

    if slo is not None:
        head("slo_status",
             "Per-rule SLO status (1 = breaching, 0 = within "
             "objective; SL6xx catalog in docs/observability.md).",
             "gauge")
        for row in slo:
            sample("slo_status", {"rule": row["rule"]},
                   1 if row["status"] == "breach" else 0)
        head("slo_burn_rate",
             "Per-rule error-budget burn rate over the fast/slow "
             "windows (>= 1 means the objective is being violated at "
             "budget-exhausting speed).", "gauge")
        for row in slo:
            for window in ("fast", "slow"):
                sample("slo_burn_rate",
                       {"rule": row["rule"], "window": window},
                       row.get(f"burn_{window}"))
        head("slo_breaches_total",
             "Breach transitions (ok -> breach) per rule since start.",
             "counter")
        for row in slo:
            sample("slo_breaches_total", {"rule": row["rule"]},
                   row.get("breaches_total", 0))

    if control is not None:
        head("control_decisions_total",
             "Closed-loop controller decisions by outcome (proposed/"
             "applied/evaluated/discarded/reverted/held/rearmed).",
             "counter")
        for outcome, n in sorted(control.get("decisions", {}).items()):
            sample("control_decisions_total", {"outcome": outcome}, n)
        head("control_objective",
             "Last evaluated controller objective (weighted warm p99 + "
             "queue depth, duty-cycle tie-break; lower is better).",
             "gauge")
        sample("control_objective", None, control.get("objective"))
        head("control_frozen",
             "1 while the controller is frozen (post-revert backoff; "
             "knobs pinned to the static config).", "gauge")
        sample("control_frozen", None, control.get("frozen", 0))
        head("control_freezes_total",
             "Controller freeze transitions (breach- or exception-"
             "triggered reverts to the static config).", "counter")
        sample("control_freezes_total", None,
               control.get("freezes_total", 0))
        head("control_reclaimed_studies_total",
             "Admission slots reclaimed from SH5xx-stopped studies "
             "(per-study early_stop opt-in).", "counter")
        sample("control_reclaimed_studies_total", None,
               control.get("reclaimed_studies_total", 0))
        head("control_resumed_studies_total",
             "Stopped studies re-admitted via resume.", "counter")
        sample("control_resumed_studies_total", None,
               control.get("resumed_studies_total", 0))

    if build is not None:
        head("build_info",
             "Build/runtime identity (value is always 1; the labels "
             "are the information).", "gauge")
        sample("build_info", dict(build), 1)

    if extra:
        for key, value in sorted(extra.items()):
            head(key, "Ad-hoc gauge.", "gauge")
            sample(key, None, value)

    return "\n".join(lines) + "\n"


def timed_suggest(algo, timings: PhaseTimings):
    """Wrap a suggest function so each call lands in ``timings``."""

    @wraps(algo)
    def wrapper(new_ids, domain, trials, seed, *args, **kwargs):
        with timings.phase("suggest"):
            return algo(new_ids, domain, trials, seed, *args, **kwargs)

    return wrapper
