"""Overlap accounting of the speculative suggest engine.

Reference parity: ``SpeculationStats`` of ``hyperopt_tpu/observability.py``
(``:71-163``).  The rest of that module (phase timings, fault counts, the
suggest observers) is not ported yet (ROADMAP.md, queue A item 8).
"""

from __future__ import annotations

import logging

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
