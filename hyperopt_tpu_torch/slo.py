"""SLO guardrails: declarative SL6xx objectives, multi-window burn
rates, and a breach-triggered flight recorder.

Reference parity: ``hyperopt_tpu/slo.py``.  Three read-only telemetry
pillars — request tracing, device roofline profiling, search-health
verdicts — are watched here ("model search as an experiment apparatus",
Bergstra, Yamins & Cox, ICML 2013: the apparatus must report when it is
out of tolerance, not just log numbers).  SL608 reads the replica
plane's ``ReplicaStats``; a single-process service passes
``replica_stats=None`` and SL608 reports ``no_data``.

- **SL6xx rules** — declarative objectives over the existing stats
  objects (:class:`~hyperopt_tpu_torch.observability.ServiceStats` /
  ``DeviceStats`` / ``StoreStats``): steady-state suggest latency
  (ratio and absolute, compile-tagged requests excluded),
  error/backpressure rate, device duty-cycle floor,
  store cleanliness, fsync latency.  Surfaced at ``/v1/alerts``, as
  ``hyperopt_slo_{status,burn_rate,breaches_total}{rule=...}`` gauges
  on ``/metrics``, and as ``slo_breach`` attrs on traced roots.
- **Multi-window burn rates** — every rule is evaluated over a fast
  (default 5 m) and a slow (default 1 h) trailing window, computed as
  counter/histogram-bucket DELTAS between the live state and periodic
  snapshots (the ``LatencyHistogram`` fixed buckets make a window
  histogram an elementwise subtraction).  ``burn`` is uniformly
  *measured over allowed*: for event-rate rules it is the classic
  error-budget burn rate (bad-fraction / budget); for threshold rules
  it is how far past the objective the window sits.  A rule
  **breaches** only when BOTH windows burn ≥ 1 — the Google-SRE
  multi-window discipline that keeps a single slow request from paging
  and a recovered incident from staying red for an hour.
- **Flight recorder** — bounded in-memory rings of recent evidence
  (finished traces regardless of head-sampling, device dispatch
  records, per-study health rows, chaos injections, store ops) dumped
  as an fsync'd, CRC-per-record JSONL bundle (the journal discipline)
  on SLO breach, SIGQUIT, or unhandled crash — so a slow p99 comes
  with the exact traces that paid it.

Rule catalog (primary ids, mirroring the SP/PL/RL/FS/SH convention):

========  ==================  =============================================
rule      name                objective (breach when both windows burn ≥ 1)
========  ==================  =============================================
SL601     latency_ratio       steady-state suggest p99 ≤ ratio_max × p50
SL602     latency_absolute    99% of steady-state suggests ≤ p99_bound_s
SL603     error_rate          (backpressure 429s + 5xx) / requests ≤ budget
SL604     duty_cycle          device duty cycle ≥ floor while under load
SL605     store_clean         zero torn journal lines / quarantined docs,
                              startup fsck clean (zero-tolerance)
SL606     fsync_latency       99% of storage-plane fsyncs ≤ bound_s
SL607     cold_compile        ~zero compile-carrying suggests after ready
                              (the AOT-warmup closed-loop guard)
SL608     failover_mttr       zero failed/slow replica takeovers (claim +
                              fsck + recover + pre-warm within the MTTR
                              bound; multi-replica mode only)
========  ==================  =============================================

``no_data`` (too few observations in a window) never breaches: silence
is not an SLO violation, and a rule must not page an idle server.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from . import tracing
from .observability import quantile_from_counts

logger = logging.getLogger(__name__)

DEFAULT_FAST_WINDOW = 300.0     # 5 m — the paging window
DEFAULT_SLOW_WINDOW = 3600.0    # 1 h — the budget window
DEFAULT_SNAPSHOT_INTERVAL = 10.0
DEFAULT_TICK_INTERVAL = 5.0

_NO_DATA = "no_data"
_OK = "ok"
_BREACH = "breach"


# ---------------------------------------------------------------------
# window arithmetic
# ---------------------------------------------------------------------


def _hist_delta(cur: dict, old: dict) -> dict:
    """Elementwise difference of two LatencyHistogram ``state()``
    snapshots — the window histogram (same edges)."""
    if old is None:
        return dict(cur, counts=list(cur["counts"]))
    return {
        "edges": cur["edges"],
        "counts": [
            c - o for c, o in zip(cur["counts"], old["counts"])
        ],
        "total": cur["total"] - old["total"],
        "sum_s": cur["sum_s"] - old["sum_s"],
    }


def _count_above(state: dict, bound: float) -> int:
    """Observations strictly above ``bound`` in a (window) histogram
    state.  A bucket counts only when its LOWER edge is ≥ ``bound`` —
    exact when ``bound`` is a bucket edge; otherwise the bucket
    containing ``bound`` is excluded entirely (an undercount —
    conservative: a mis-set bound must not page on observations that
    may be under the objective)."""
    above = 0
    lo = 0.0
    for edge, n in zip(state["edges"], state["counts"]):
        if lo >= bound:
            above += n
        lo = edge
    if lo >= bound:  # the +Inf bucket (lower edge = last finite edge)
        above += state["counts"][-1]
    return above


class _Window:
    """One evaluated trailing window: counter deltas + histogram deltas
    + the actual covered seconds (shorter than nominal early in the
    process lifetime — windows never extend past process start)."""

    __slots__ = ("seconds", "nominal_s", "counters", "hists")

    def __init__(self, seconds, nominal_s, counters, hists):
        self.seconds = float(seconds)
        self.nominal_s = float(nominal_s)
        self.counters = counters
        self.hists = hists

    def counter(self, key) -> float:
        return self.counters.get(key, 0) or 0

    def hist(self, name) -> dict:
        return self.hists[name]


# ---------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------


class SloRule:
    """One declarative objective.  Subclasses implement
    :meth:`eval_window` returning ``(burn, value, detail)`` — ``burn``
    is measured/allowed (≥ 1 means the window violates the objective),
    ``None`` means not enough data in this window."""

    rule_id = "SL6xx"
    name = "abstract"
    description = ""

    def eval_window(self, win: _Window, absolute: dict):
        raise NotImplementedError

    def objective(self) -> dict:
        """The rule's static parameters, for report/alerts payloads."""
        return {}


class LatencyRatioRule(SloRule):
    """SL601: steady-state (compile-excluded) suggest p99 must stay
    within ``ratio_max`` × p50 — the ROADMAP's "p99 within a small
    multiple of p50" tail-latency gate, over the warm split so a cold
    compile storm is SL-attributed to first-touch, not steady state."""

    rule_id = "SL601"
    name = "latency_ratio"
    description = (
        "steady-state suggest p99 <= ratio_max * p50 (compile-carrying "
        "requests excluded)"
    )

    def __init__(self, ratio_max=25.0, min_count=20):
        self.ratio_max = float(ratio_max)
        self.min_count = int(min_count)

    def objective(self):
        return {"ratio_max": self.ratio_max, "min_count": self.min_count}

    def eval_window(self, win, absolute):
        h = win.hist("suggest_warm")
        if h["total"] < self.min_count:
            return None, None, f"{h['total']} warm suggests (< {self.min_count})"
        p50 = quantile_from_counts(h["edges"], h["counts"], 0.50)
        p99 = quantile_from_counts(h["edges"], h["counts"], 0.99)
        if not p50:
            return None, None, "p50 at histogram floor"
        ratio = p99 / p50
        return ratio / self.ratio_max, ratio, (
            f"warm p99/p50 = {p99 * 1e3:.1f}ms/{p50 * 1e3:.1f}ms = "
            f"{ratio:.1f}x (max {self.ratio_max:g}x, n={h['total']})"
        )


class LatencyAbsoluteRule(SloRule):
    """SL602: 99% of steady-state suggests complete within
    ``p99_bound_s`` — the absolute arm of the tail gate (a ratio alone
    would bless a uniformly slow server)."""

    rule_id = "SL602"
    name = "latency_absolute"
    description = (
        "99% of steady-state suggests complete within p99_bound_s"
    )

    def __init__(self, p99_bound_s=2.5, min_count=20):
        self.p99_bound_s = float(p99_bound_s)
        self.budget = 0.01
        self.min_count = int(min_count)

    def objective(self):
        return {
            "p99_bound_s": self.p99_bound_s, "budget": self.budget,
            "min_count": self.min_count,
        }

    def eval_window(self, win, absolute):
        h = win.hist("suggest_warm")
        if h["total"] < self.min_count:
            return None, None, f"{h['total']} warm suggests (< {self.min_count})"
        bad = _count_above(h, self.p99_bound_s)
        frac = bad / h["total"]
        return frac / self.budget, frac, (
            f"{bad}/{h['total']} warm suggests over "
            f"{self.p99_bound_s:g}s (budget {self.budget:.0%})"
        )


class ErrorRateRule(SloRule):
    """SL603: backpressure rejections + server-side errors stay within
    ``budget`` of total traffic — the classic availability SLO."""

    rule_id = "SL603"
    name = "error_rate"
    description = "(429 rejections + 5xx errors) / requests <= budget"

    def __init__(self, budget=0.05, min_requests=10):
        self.budget = float(budget)
        self.min_requests = int(min_requests)

    def objective(self):
        return {"budget": self.budget, "min_requests": self.min_requests}

    def eval_window(self, win, absolute):
        bad = (
            win.counter("rejected_total")
            + win.counter("errors_mutating")
        )
        # numerator and denominator cover the SAME population: every
        # mutating request that ARRIVED — served (requests_mutating),
        # rejected, or errored (errored ones never reach
        # record_request).  Read-route traffic is excluded from BOTH
        # sides: a dashboard polling /v1/alerts must not dilute the
        # rate, and a flaky read-only endpoint must not inflate it.
        total = (
            win.counter("requests_mutating")
            + win.counter("rejected_total")
            + win.counter("errors_mutating")
        )
        if total < self.min_requests:
            return None, None, f"{total} requests (< {self.min_requests})"
        frac = bad / total
        return frac / self.budget, frac, (
            f"{bad:g}/{total:g} mutating requests rejected-or-errored "
            f"(budget {self.budget:.0%})"
        )


class DutyCycleRule(SloRule):
    """SL604: the device stays at least ``floor`` busy while requests
    flow — a server paying 26-second tails while its accelerator idles
    is a scheduling bug, not a capacity problem.  Gated on a minimum
    dispatch count so an idle server never pages."""

    rule_id = "SL604"
    name = "duty_cycle"
    description = (
        "device duty cycle >= floor over windows carrying "
        ">= min_dispatches fused dispatches"
    )

    def __init__(self, floor=0.05, min_dispatches=5):
        self.floor = float(floor)
        self.min_dispatches = int(min_dispatches)

    def objective(self):
        return {
            "floor": self.floor, "min_dispatches": self.min_dispatches,
        }

    def eval_window(self, win, absolute):
        n = win.counter("dispatches")
        if n < self.min_dispatches or win.seconds <= 0:
            return None, None, (
                f"{n:g} dispatches (< {self.min_dispatches})"
            )
        duty = win.counter("busy_s") / win.seconds
        # a fully idle device is the WORST breach, not a null one: cap
        # the burn finite so /metrics and /v1/alerts still carry a
        # >= 1 value an external burn-rate alert can fire on
        burn = min(self.floor / duty, 1e6) if duty > 0 else 1e6
        return burn, duty, (
            f"duty {duty:.3f} over {win.seconds:.0f}s "
            f"({n:g} dispatches; floor {self.floor:g})"
        )


class StoreCleanRule(SloRule):
    """SL605: the storage plane stays clean — zero torn journal lines,
    zero quarantined docs, startup fsck clean.  Zero-tolerance: the
    burn IS the bad-event count (any event in the window breaches)."""

    rule_id = "SL605"
    name = "store_clean"
    description = (
        "zero torn journal lines / quarantined docs; startup fsck clean"
    )

    def objective(self):
        return {"budget": 0}

    def eval_window(self, win, absolute):
        bad = win.counter("store_bad")
        if absolute.get("fsck_unclean"):
            bad += 1
        return float(bad), bad, (
            f"{bad:g} store integrity event(s) "
            f"(torn journal lines + quarantined docs"
            + ("; startup fsck UNCLEAN" if absolute.get("fsck_unclean")
               else "")
            + ")"
        )


class FsyncLatencyRule(SloRule):
    """SL606: 99% of storage-plane fsyncs complete within ``bound_s`` —
    the storage plane announcing itself BEFORE it owns the suggest
    tail (an NFS mount gone slow shows here first)."""

    rule_id = "SL606"
    name = "fsync_latency"
    description = "99% of storage-plane fsyncs complete within bound_s"

    def __init__(self, bound_s=0.25, min_count=20):
        self.bound_s = float(bound_s)
        self.budget = 0.01
        self.min_count = int(min_count)

    def objective(self):
        return {
            "bound_s": self.bound_s, "budget": self.budget,
            "min_count": self.min_count,
        }

    def eval_window(self, win, absolute):
        h = win.hist("fsync")
        if h["total"] < self.min_count:
            return None, None, f"{h['total']} fsyncs (< {self.min_count})"
        bad = _count_above(h, self.bound_s)
        frac = bad / h["total"]
        return frac / self.budget, frac, (
            f"{bad}/{h['total']} fsyncs over {self.bound_s:g}s "
            f"(budget {self.budget:.0%})"
        )


class ColdCompileRule(SloRule):
    """SL607: the cold-compile rate in the request path stays ≈ 0
    AFTER the service first reported ready — the closed-loop guard
    over the warmup (:mod:`hyperopt_tpu_torch.compile_ledger`): a
    post-ready cold suggest means the warmup grid missed a program the
    traffic needed.  A small budget (default 1% of suggests) tolerates
    the unavoidable first-touch of a study CREATED after startup
    (warmup cannot predict a study that does not exist yet) without
    letting a compile storm hide; a fully warmed restart must sit at
    exactly zero.  Note the cold attribution is per REQUEST: every
    batch member that waited on the compile counts,
    so one first-touch under heavy batching costs ~batch_size budget —
    intentionally, because each of those requests really paid the
    compile event's cost; ``--cold-fallback`` containment is the remedy
    that keeps them out of the numerator entirely.  Compiles before readiness are warmup's own business
    and never counted, and the rule only ARMS on the first green
    ``/readyz`` (``ServiceStats.mark_ready``): an embedded service
    that is never readiness-probed stays ``no_data`` by design —
    without a readiness barrier, traffic interleaving with first-touch
    compiles is correct behavior, not an SLO violation.  Off-request-
    path compiles (warmup replays, cold-containment background
    threads) are excluded from the numerator at the attribution layer
    (``tpe_device.background_compiles``)."""

    rule_id = "SL607"
    name = "cold_compile"
    description = (
        "compile-carrying (cold) suggests after /readyz first reported "
        "ready stay within budget of suggest traffic (~0)"
    )

    def __init__(self, budget=0.01, min_requests=20):
        self.budget = float(budget)
        self.min_requests = int(min_requests)

    def objective(self):
        return {"budget": self.budget, "min_requests": self.min_requests}

    def eval_window(self, win, absolute):
        bad = win.counter("suggests_cold_after_ready")
        total = win.counter("requests_suggest")
        if total < self.min_requests:
            if bad:
                # a cold suggest in a quiet window must not hide behind
                # the traffic floor: evaluate against the floor itself
                total = self.min_requests
            else:
                return None, None, (
                    f"{total:g} suggests (< {self.min_requests})"
                )
        frac = bad / total
        return frac / self.budget, frac, (
            f"{bad:g}/{total:g} post-ready suggests carried a "
            f"compile event (budget {self.budget:.0%})"
        )


class FailoverMttrRule(SloRule):
    """SL608: every replica takeover completes fast and clean — zero
    failed takeovers and zero takeovers slower than the MTTR bound
    (classified at record time by
    :class:`~hyperopt_tpu_torch.service.replicas.ReplicaStats` against its
    ``mttr_bound_s``, default 30 s).  Zero-tolerance like SL605: the
    burn IS the bad-takeover count.  A takeover's duration covers the
    whole claim → fsck → recover → ledger-pre-warm pipeline, so a slow
    one usually means the pre-warm degenerated into real cold compiles
    — exactly the failover compile storm the ledger exists to pre-pay.
    ``no_data`` on single-process deployments (no replica plane) and in
    windows with no takeovers."""

    rule_id = "SL608"
    name = "failover_mttr"
    description = (
        "zero failed takeovers; every replica takeover (claim + fsck + "
        "recover + pre-warm) within the MTTR bound"
    )

    def __init__(self, min_takeovers=1):
        self.min_takeovers = int(min_takeovers)

    def objective(self):
        return {"budget": 0, "min_takeovers": self.min_takeovers}

    def eval_window(self, win, absolute):
        total = win.counter("replica_takeovers")
        bad = (
            win.counter("replica_takeovers_slow")
            + win.counter("replica_takeovers_failed")
        )
        if total < self.min_takeovers and not bad:
            return None, None, f"{total:g} takeover(s) in window"
        return float(bad), bad, (
            f"{bad:g}/{total:g} takeover(s) failed or exceeded the "
            f"MTTR bound"
        )


def default_rules(**overrides) -> list:
    """The SL6xx catalog with default objectives.  ``overrides`` maps
    rule name → kwargs dict (e.g. ``latency_ratio={"ratio_max": 10}``)."""
    builders = (
        ("latency_ratio", LatencyRatioRule),
        ("latency_absolute", LatencyAbsoluteRule),
        ("error_rate", ErrorRateRule),
        ("duty_cycle", DutyCycleRule),
        ("store_clean", StoreCleanRule),
        ("fsync_latency", FsyncLatencyRule),
        ("cold_compile", ColdCompileRule),
        ("failover_mttr", FailoverMttrRule),
    )
    unknown = set(overrides) - {name for name, _ in builders}
    if unknown:
        raise ValueError(f"unknown SLO rule overrides: {sorted(unknown)}")
    return [cls(**overrides.get(name, {})) for name, cls in builders]


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------


class SloEngine:
    """Evaluates the rule catalog over multi-window counter deltas and
    drives the flight recorder on breach transitions.

    Sources are the service's existing stats objects (all optional —
    a rule whose source is absent reports ``no_data``).  Snapshots of
    their cumulative counters are taken at most every
    ``snapshot_interval`` seconds into a bounded ring; a window's value
    is the LIVE state minus the oldest in-window snapshot, so the
    engine never re-aggregates raw events.

    Thread-safe: the ticker thread, ``/metrics`` renders, and
    ``/v1/alerts`` reads evaluate concurrently.
    """

    # lock-order: _lock
    def __init__(self, service_stats=None, device_stats=None,
                 store_stats=None, replica_stats=None, rules=None,
                 recorder=None, fast_window=DEFAULT_FAST_WINDOW,
                 slow_window=DEFAULT_SLOW_WINDOW,
                 snapshot_interval=DEFAULT_SNAPSHOT_INTERVAL,
                 min_eval_interval=1.0, min_window_s=30.0,
                 fsck_unclean=False, time_fn=time.monotonic):
        from collections import deque

        self.service_stats = service_stats
        self.device_stats = device_stats
        self.store_stats = store_stats
        self.replica_stats = replica_stats
        self.rules = list(rules) if rules is not None else default_rules()
        self.recorder = recorder
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.snapshot_interval = float(snapshot_interval)
        self.min_eval_interval = float(min_eval_interval)
        # a window younger than this reads no_data: a 3-second-old
        # process extrapolating one slow fsync into a "1.9% over
        # budget" page is noise, not an SLO violation
        self.min_window_s = float(min_window_s)
        self.fsck_unclean = bool(fsck_unclean)
        self._time = time_fn
        self._lock = threading.Lock()
        cap = max(int(self.slow_window / max(self.snapshot_interval, 1e-6))
                  + 2, 16)
        self._snapshots = deque(maxlen=cap)  # guarded-by: _lock
        self._breaching = set()  # guarded-by: _lock  (rule ids)
        self._breaches_total = {}  # guarded-by: _lock
        self._last_eval = None  # guarded-by: _lock  (rows list)
        self._last_eval_t = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread = None
        # the t=0 snapshot: every window is bounded by process start
        self._snapshots.append(self._capture())

    # -- capture -------------------------------------------------------
    def _capture(self) -> dict:
        counters = {}
        hists = {}
        if self.service_stats is not None:
            counters.update(self.service_stats.slo_counters())
            hists["suggest_warm"] = self.service_stats.warm_hist_state()
        else:
            hists["suggest_warm"] = {
                "edges": (), "counts": [0], "total": 0, "sum_s": 0.0,
            }
        if self.device_stats is not None:
            counters.update(self.device_stats.slo_counters())
        if self.replica_stats is not None:
            counters.update(self.replica_stats.slo_counters())
        if self.store_stats is not None:
            counters.update(self.store_stats.slo_counters())
            hists["fsync"] = self.store_stats.fsync_hist_state()
        else:
            hists["fsync"] = {
                "edges": (), "counts": [0], "total": 0, "sum_s": 0.0,
            }
        return {"t": self._time(), "counters": counters, "hists": hists}

    def _window(self, cur: dict, nominal_s: float, snapshots) -> _Window:
        """The trailing window ending at ``cur``: delta against the
        NEWEST snapshot at least ``nominal_s`` old (window ≈ nominal at
        ticker cadence), falling back to the earliest snapshot when the
        process is younger than the window (or a tick gap starved it) —
        a window errs toward MORE coverage, never empty: evaluating
        right after a snapshot must not see a zero-length window."""
        cutoff = cur["t"] - nominal_s
        base = snapshots[0]
        for snap in snapshots:
            if snap["t"] <= cutoff:
                base = snap
            else:
                break
        counters = {
            k: v - base["counters"].get(k, 0)
            for k, v in cur["counters"].items()
        }
        hists = {
            name: _hist_delta(state, base["hists"].get(name))
            for name, state in cur["hists"].items()
        }
        return _Window(
            max(cur["t"] - base["t"], 1e-9), nominal_s, counters, hists
        )

    # -- evaluation ----------------------------------------------------
    def evaluate(self, force=False) -> list:
        """The current rule table (one row per rule).  Cached for
        ``min_eval_interval`` unless ``force``; breach transitions
        increment ``breaches_total`` and trigger the flight recorder."""
        now = self._time()
        with self._lock:
            if (
                not force
                and self._last_eval is not None
                and now - self._last_eval_t < self.min_eval_interval
            ):
                return list(self._last_eval)
            snapshots = list(self._snapshots)
        cur = self._capture()
        absolute = {"fsck_unclean": self.fsck_unclean}
        fast = self._window(cur, self.fast_window, snapshots)
        slow = self._window(cur, self.slow_window, snapshots)
        young = fast.seconds < self.min_window_s
        rows, newly_breaching = [], []
        with self._lock:
            for rule in self.rules:
                try:
                    if young:
                        burn_f = burn_s = value_f = None
                        detail_f = (
                            f"window {fast.seconds:.0f}s younger than "
                            f"min_window_s {self.min_window_s:g}s"
                        )
                    else:
                        burn_f, value_f, detail_f = rule.eval_window(
                            fast, absolute
                        )
                        burn_s, _value_s, _detail_s = rule.eval_window(
                            slow, absolute
                        )
                except Exception:  # pragma: no cover - defensive
                    logger.exception("SLO rule %s failed", rule.rule_id)
                    burn_f = burn_s = value_f = None
                    detail_f = "rule evaluation failed (see server log)"
                if burn_f is None or burn_s is None:
                    status = _NO_DATA
                else:
                    # the multi-window discipline: page only when the
                    # fast window is hot AND the slow window confirms
                    # real budget spend
                    status = (
                        _BREACH if burn_f >= 1.0 and burn_s >= 1.0
                        else _OK
                    )
                was = rule.rule_id in self._breaching
                if status == _BREACH and not was:
                    self._breaching.add(rule.rule_id)
                    self._breaches_total[rule.rule_id] = (
                        self._breaches_total.get(rule.rule_id, 0) + 1
                    )
                    newly_breaching.append((rule.rule_id, detail_f))
                elif status != _BREACH and was:
                    self._breaching.discard(rule.rule_id)
                rows.append({
                    "rule": rule.rule_id,
                    "name": rule.name,
                    "status": status,
                    "ok": status != _BREACH,
                    "value": value_f,
                    "burn_fast": _round6(burn_f),
                    "burn_slow": _round6(burn_s),
                    "window_fast_s": round(fast.seconds, 3),
                    "window_slow_s": round(slow.seconds, 3),
                    "breaches_total": self._breaches_total.get(
                        rule.rule_id, 0
                    ),
                    "objective": rule.objective(),
                    "detail": detail_f,
                })
            self._last_eval = list(rows)
            self._last_eval_t = now
        if newly_breaching and self.recorder is not None:
            reason = "slo:" + ",".join(r for r, _ in newly_breaching)
            try:
                self.recorder.dump(reason, context={
                    "breaching": [
                        {"rule": r, "detail": d}
                        for r, d in newly_breaching
                    ],
                    "rules": rows,
                })
            except Exception:  # pragma: no cover - defensive
                logger.exception("flight-recorder dump failed")
        for rule_id, detail in newly_breaching:
            logger.error("SLO BREACH %s: %s", rule_id, detail)
        return rows

    def tick(self):
        """One scheduler beat: snapshot if due, then evaluate (which
        handles breach transitions and recorder dumps)."""
        now = self._time()
        with self._lock:
            due = (
                not self._snapshots
                or now - self._snapshots[-1]["t"]
                >= self.snapshot_interval
            )
        if due:
            snap = self._capture()
            with self._lock:
                self._snapshots.append(snap)
        self.evaluate(force=True)

    # -- read surfaces -------------------------------------------------
    def current_breaching(self) -> list:
        """Rule ids currently in breach (cheap cached read — safe on
        the request hot path for the traced-root attr)."""
        with self._lock:
            return sorted(self._breaching)

    def metrics_rows(self) -> list:
        """Rows for ``render_prometheus(slo=...)``."""
        return self.evaluate()

    def alerts_payload(self) -> dict:
        """The ``/v1/alerts`` document."""
        rows = self.evaluate()
        return {
            "rules": rows,
            "breaching": [r["rule"] for r in rows if not r["ok"]],
            "windows": {
                "fast_s": self.fast_window, "slow_s": self.slow_window,
            },
            "recorder": (
                self.recorder.summary()
                if self.recorder is not None else None
            ),
        }

    # -- ticker thread -------------------------------------------------
    def start(self, interval=DEFAULT_TICK_INTERVAL):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._interval = float(interval)
        self._thread = threading.Thread(
            target=self._run, name="hyperopt-slo-ticker", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.tick()
            except Exception:  # pragma: no cover - defensive
                logger.exception("SLO tick failed; continuing")

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def _round6(v):
    if v is None:
        return None
    v = float(v)
    if v != v or v in (float("inf"), float("-inf")):
        return None
    return round(v, 6)


# ---------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------


class FlightRecorder:
    """Bounded in-memory rings of recent evidence + the breach-time
    bundle dump.

    Push feed: :meth:`record_trace` receives EVERY finished trace from
    the :class:`~hyperopt_tpu_torch.tracing.Tracer` (before its head-sampling
    keep/drop decision — the recorder's window is "last N finished",
    not "last N sampled"; a fully disabled tracer begins no traces, so
    off still means off).  Pull feeds: providers registered with
    :meth:`set_provider` (device dispatch records, store ops, chaos
    injections, per-study health rows, service status) are read only at
    dump time — zero hot-path cost.

    A bundle is ONE file of ``\\n<crc32 hex> <json>`` records (the
    journal/trace-log discipline; parse with :func:`read_bundle`):
    a ``manifest`` record first, then typed evidence records, then an
    ``end`` record whose count makes truncation detectable.  Written
    to a tmp file, fsync'd, atomically renamed; at most
    ``max_bundles`` bundle files are kept (oldest deleted).
    """

    # lock-order: _lock
    def __init__(self, bundle_dir=None, max_traces=64, max_bundles=8):
        from collections import deque

        self.bundle_dir = bundle_dir
        self.max_bundles = int(max_bundles)
        self._lock = threading.Lock()
        self._traces = deque(maxlen=int(max_traces))  # guarded-by: _lock
        self._providers = {}  # guarded-by: _lock
        self._n_dumps = 0  # guarded-by: _lock
        self._n_dump_failures = 0  # guarded-by: _lock
        self._last_bundle = None  # guarded-by: _lock

    # -- feeds ---------------------------------------------------------
    def record_trace(self, trace):
        """One finished trace (a ``tracing.Trace`` or an already-built
        record dict).  O(1): the ring holds the object; serialization
        happens at dump time."""
        with self._lock:
            self._traces.append(trace)

    def set_provider(self, name: str, fn):
        """Register a pull feed: ``fn()`` → list[dict] | dict, read at
        dump time only."""
        with self._lock:
            self._providers[str(name)] = fn

    # -- dump ----------------------------------------------------------
    def _trace_records(self):
        with self._lock:
            traces = list(self._traces)
        out = []
        for tr in traces:
            try:
                rec = tr if isinstance(tr, dict) else tr.to_record()
            except Exception:  # pragma: no cover - defensive
                continue
            out.append(dict(rec, kind="trace"))
        return out

    def dump(self, reason: str, context=None):
        """Write one diagnostic bundle; returns its path (None when no
        ``bundle_dir`` is configured or the write failed — the dump
        must never take the server down with it)."""
        if not self.bundle_dir:
            logger.warning(
                "flight recorder: dump(%r) requested but no bundle_dir "
                "configured", reason,
            )
            return None
        try:
            return self._dump(reason, context)
        except Exception:
            with self._lock:
                self._n_dump_failures += 1
            logger.exception("flight-recorder dump failed")
            return None

    def _dump(self, reason, context):
        from .observability import build_info

        os.makedirs(self.bundle_dir, exist_ok=True)
        records = []
        traces = self._trace_records()
        sections = {"trace": len(traces)}
        evidence = []
        with self._lock:
            providers = dict(self._providers)
        for name, fn in sorted(providers.items()):
            try:
                items = fn()
            except Exception:  # pragma: no cover - defensive
                logger.exception(
                    "flight-recorder provider %r failed", name
                )
                continue
            if isinstance(items, dict):
                items = [items]
            rows = [dict(item, kind=name) for item in items or ()]
            sections[name] = len(rows)
            evidence.extend(rows)
        manifest = {
            "kind": "manifest",
            "reason": str(reason),
            "wall_time": time.time(),
            "pid": os.getpid(),
            "build": build_info(),
            "sections": sections,
            "context": context or {},
        }
        records.append(manifest)
        records.extend(traces)
        records.extend(evidence)
        records.append({"kind": "end", "n_records": len(records) + 1})
        # the trace-log record format (ONE definition, in tracing.py)
        # with a stringify fallback: provider evidence must never fail
        # the dump it exists for
        blob = b"".join(
            tracing.format_record(r, default=str) for r in records
        )
        with self._lock:
            self._n_dumps += 1
            seq = self._n_dumps
        safe_reason = "".join(
            c if c.isalnum() or c in "._-" else "-" for c in str(reason)
        )[:48]
        path = os.path.join(
            self.bundle_dir, f"flightrec-{seq:04d}-{safe_reason}.jsonl"
        )
        tmp = f"{path}.tmp.{os.getpid()}"
        t0 = time.perf_counter()
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        fsync_s = time.perf_counter() - t0
        os.replace(tmp, path)
        from .parallel.file_trials import store_stats

        stats = store_stats()
        if stats is not None:
            # the MEASURED duration: during a slow-storage incident the
            # dump's own fsync is evidence, and a fabricated 0.0 would
            # dilute exactly the SL606 window that fired it
            stats.record_fsync(fsync_s, kind="bundle", nbytes=len(blob))
        with self._lock:
            self._last_bundle = path
        self._prune()
        logger.warning(
            "flight recorder: dumped %d record(s) to %s (reason: %s)",
            len(records), path, reason,
        )
        return path

    def _prune(self):
        """Keep at most ``max_bundles`` bundle files (oldest first)."""
        try:
            names = sorted(
                n for n in os.listdir(self.bundle_dir)
                if n.startswith("flightrec-") and n.endswith(".jsonl")
            )
        except OSError:
            return
        for name in names[: max(len(names) - self.max_bundles, 0)]:
            try:
                os.unlink(os.path.join(self.bundle_dir, name))
            except OSError:
                pass

    def summary(self) -> dict:
        with self._lock:
            return {
                "bundle_dir": self.bundle_dir,
                "n_buffered_traces": len(self._traces),
                "providers": sorted(self._providers),
                "n_dumps": self._n_dumps,
                "n_dump_failures": self._n_dump_failures,
                "last_bundle": self._last_bundle,
            }


def read_bundle(path):
    """(records, n_torn) for a flight-recorder bundle — the trace-log
    parser (same CRC-per-record, leading-newline-resync format)."""
    with open(path, "rb") as f:
        raw = f.read()
    return tracing.parse_trace_log(raw)


def validate_bundle(path) -> dict:
    """Parse + structural check of one bundle: manifest first, end
    record's count matches, zero torn lines.  Returns a report dict
    (``ok`` plus counts) — the round-trip gate of SLO_SERVE.json."""
    records, torn = read_bundle(path)
    ok = (
        torn == 0
        and len(records) >= 2
        and records[0].get("kind") == "manifest"
        and records[-1].get("kind") == "end"
        and records[-1].get("n_records") == len(records)
    )
    kinds = {}
    for r in records:
        kinds[r.get("kind")] = kinds.get(r.get("kind"), 0) + 1
    return {
        "ok": bool(ok),
        "n_records": len(records),
        "n_torn": torn,
        "kinds": kinds,
        "reason": records[0].get("reason") if records else None,
        "trace_ids": [
            r.get("trace_id") for r in records if r.get("kind") == "trace"
        ],
    }


# ---------------------------------------------------------------------
# trigger installation (server CLI)
# ---------------------------------------------------------------------


def install_signal_dump(recorder: FlightRecorder, signum=None):
    """Dump a bundle on SIGQUIT (the operator's "show me what you were
    doing" signal) — returns True when installed, False off the main
    thread or on platforms without SIGQUIT."""
    import signal as _signal

    if signum is None:
        signum = getattr(_signal, "SIGQUIT", None)
    if signum is None:
        return False

    def _on_signal(sig, frame):
        # off the handler frame: dump() does file I/O and logging
        threading.Thread(
            target=recorder.dump, args=("sigquit",), daemon=True
        ).start()

    try:
        _signal.signal(signum, _on_signal)
    except ValueError:  # not on the main thread (embedded use)
        return False
    return True


def install_crash_dump(recorder: FlightRecorder):
    """Chain ``sys.excepthook`` and ``threading.excepthook`` so an
    unhandled crash dumps a bundle before the previous hook runs —
    the post-mortem always has its evidence."""
    import sys as _sys

    prev_sys = _sys.excepthook
    prev_threading = threading.excepthook

    def _sys_hook(exc_type, exc, tb):
        recorder.dump(f"crash:{exc_type.__name__}")
        prev_sys(exc_type, exc, tb)

    def _threading_hook(args):
        recorder.dump(
            f"crash:{getattr(args.exc_type, '__name__', 'Exception')}"
        )
        prev_threading(args)

    _sys.excepthook = _sys_hook
    threading.excepthook = _threading_hook
    return prev_sys, prev_threading
