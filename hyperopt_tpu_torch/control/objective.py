"""The controller's objective: one SLO-window delta, scored.

A candidate knob configuration is evaluated over exactly one
observation window using the same delta machinery the SLO engine runs
on: snapshot the service's cumulative counters and the warm
suggest histogram at window open, snapshot again at close, and score
the DELTA — never the process-lifetime aggregate, which would let an
old incident bias every future decision.

Score (lower is better)::

    loss = warm_p99_s + queue_weight * mean_queue_depth
           - duty_tiebreak * duty_cycle

The p99 term dominates (it is the SLO the service sells), queue depth
weighs sustained backlog the p99 alone can hide on a quiet tenant, and
the duty-cycle term is a pure tie-breaker (``duty_tiebreak`` is small
enough that it can never trade against a millisecond of p99).

Steady-state convention: a window containing a request-path compile
event or a chaos injection is CONTAMINATED — the
measurement is real cost but meaningless as a comparison between knob
settings, so the trial is discarded (recorded as a failed trial; TPE
ignores it).  A window with fewer than ``min_warm`` warm suggests is
insufficient traffic and likewise discarded.
"""

import time

from ..observability import quantile_from_counts

__all__ = ["ObjectiveProbe", "WindowResult"]


def _hist_delta(cur, base):
    counts = [
        c - b for c, b in zip(cur["counts"], base["counts"])
    ]
    return {
        "edges": cur["edges"],
        "counts": counts,
        "total": cur["total"] - base["total"],
        "sum_s": cur["sum_s"] - base["sum_s"],
    }


class WindowResult:
    """One evaluated window: either a usable loss or a discard
    reason."""

    __slots__ = (
        "ok", "reason", "loss", "warm_p99_s", "mean_queue_depth",
        "duty_cycle", "warm_count", "wall_s",
    )

    def __init__(self, ok, reason=None, loss=None, warm_p99_s=None,
                 mean_queue_depth=None, duty_cycle=None, warm_count=0,
                 wall_s=0.0):
        self.ok = ok
        self.reason = reason
        self.loss = loss
        self.warm_p99_s = warm_p99_s
        self.mean_queue_depth = mean_queue_depth
        self.duty_cycle = duty_cycle
        self.warm_count = warm_count
        self.wall_s = wall_s

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "reason": self.reason,
            "loss": self.loss,
            "warm_p99_s": self.warm_p99_s,
            "mean_queue_depth": self.mean_queue_depth,
            "duty_cycle": self.duty_cycle,
            "warm_count": self.warm_count,
            "wall_s": round(self.wall_s, 3),
        }


class ObjectiveProbe:
    """Open/close snapshot pairs over the service's live stats.

    Stateless between windows (each :meth:`open` returns a snapshot
    the caller holds), so overlapping evaluations cannot corrupt each
    other and the controller can drop a window on revert without any
    cleanup.
    """

    def __init__(self, service_stats, device_stats=None,
                 fault_stats=None, queue_weight=0.010,
                 duty_tiebreak=1e-4, min_warm=5,
                 time_fn=time.monotonic):
        self.service_stats = service_stats
        self.device_stats = device_stats
        self.fault_stats = fault_stats
        # seconds of loss per unit of mean queue depth: ~10ms per
        # queued request keeps backlog visible without drowning p99
        self.queue_weight = float(queue_weight)
        self.duty_tiebreak = float(duty_tiebreak)
        self.min_warm = int(min_warm)
        self._time = time_fn

    def open(self) -> dict:
        """Snapshot every cumulative source the close-side delta
        needs."""
        snap = {
            "t": self._time(),
            "warm_hist": self.service_stats.warm_hist_state(),
            "counters": self.service_stats.slo_counters(),
            "compile_events": self.service_stats.n_compile_events,
        }
        if self.device_stats is not None:
            snap["device"] = self.device_stats.slo_counters()
        if self.fault_stats is not None:
            snap["injected"] = sum(
                self.fault_stats.injected().values()
            )
        return snap

    def close(self, opened: dict) -> WindowResult:
        """Delta against ``opened`` and score it (or discard)."""
        wall_s = max(self._time() - opened["t"], 1e-9)
        # contamination checks FIRST — a contaminated window's numbers
        # are never even computed, matching the SLO engine's
        # steady-state discipline
        if self.service_stats.n_compile_events > opened["compile_events"]:
            return WindowResult(
                False, reason="contaminated:compile", wall_s=wall_s
            )
        if self.fault_stats is not None:
            injected = sum(self.fault_stats.injected().values())
            if injected > opened.get("injected", 0):
                return WindowResult(
                    False, reason="contaminated:chaos", wall_s=wall_s
                )
        warm = _hist_delta(
            self.service_stats.warm_hist_state(), opened["warm_hist"]
        )
        if warm["total"] < self.min_warm:
            return WindowResult(
                False, reason="insufficient_traffic",
                warm_count=warm["total"], wall_s=wall_s,
            )
        p99 = quantile_from_counts(warm["edges"], warm["counts"], 0.99)
        if p99 is None:
            return WindowResult(
                False, reason="insufficient_traffic",
                warm_count=warm["total"], wall_s=wall_s,
            )
        counters = self.service_stats.slo_counters()
        depth_sum = (
            counters.get("queue_depth_sum", 0)
            - opened["counters"].get("queue_depth_sum", 0)
        )
        depth_n = (
            counters.get("queue_depth_samples", 0)
            - opened["counters"].get("queue_depth_samples", 0)
        )
        mean_depth = (depth_sum / depth_n) if depth_n > 0 else 0.0
        duty = None
        if self.device_stats is not None and "device" in opened:
            dev = self.device_stats.slo_counters()
            busy = dev["busy_s"] - opened["device"]["busy_s"]
            duty = min(max(busy / wall_s, 0.0), 1.0)
        loss = float(p99) + self.queue_weight * mean_depth
        if duty is not None:
            # tie-breaker only: prefer the busier device at equal
            # latency/backlog (throughput per watt), never trade
            # against them
            loss -= self.duty_tiebreak * duty
        return WindowResult(
            True, loss=loss, warm_p99_s=float(p99),
            mean_queue_depth=mean_depth, duty_cycle=duty,
            warm_count=warm["total"], wall_s=wall_s,
        )
