"""Simulated-annealing-style suggest.

Reference parity (SURVEY.md §2 #10): ``hyperopt/anneal.py`` —
``AnnealingAlgo(SuggestAlgo)`` with ``shrink_coef``/``avg_best_idx`` and
per-distribution handlers sampling near an incumbent good point with a
radius that shrinks as observations accumulate (~L30-340).

Behavioral contract (validated by quality-threshold tests, the reference's
own conformance style):
- an observed (loss, tid, val) is chosen with rank ~ Geometric(1/avg_best_idx)
  over loss-sorted history, so good-but-not-always-best incumbents seed the
  next draw;
- continuous draws are uniform (or normal) around the incumbent with width
  ``support · shrinking(T) = support / (1 + T·shrink_coef)``, clipped to
  stay inside the support; log-family handled in log space, q-family
  re-quantized;
- index draws keep the incumbent with probability ``1 − shrinking`` and
  explore uniformly otherwise.

Per-suggest cost is O(labels) scalar math, so this algorithm intentionally
stays host-side numpy (SURVEY.md §7: the device budget goes to TPE's
O(history × candidates) kernels; anneal shares the compiled space table and
activity machinery instead).
"""

from __future__ import annotations

import numpy as np

from .algobase import SuggestAlgo, prior_sample


class AnnealingAlgo(SuggestAlgo):
    def __init__(self, domain, trials, seed, avg_best_idx=2.0, shrink_coef=0.1):
        super().__init__(domain, trials, seed)
        self.avg_best_idx = avg_best_idx
        self.shrink_coef = shrink_coef
        hist = trials.history
        # per-label loss-sorted observations as (losses, tids, vals)
        # numpy triples — lookups via the cache's vectorized tid→loss
        # join (a python tuple-list build + sort here costs ~130
        # ms/suggest at a 10k-trial history, dominating the algorithm)
        self.observations = {}
        for label in self.specs:
            tids = np.asarray(hist.idxs.get(label, ()), dtype=np.int64)
            vals = np.asarray(hist.vals.get(label, ()))
            ok, ls = hist.join_losses(tids)
            tids, vals = tids[ok], vals[ok]
            srt = np.lexsort((tids, ls))  # by (loss, tid) — ref tiebreak
            self.observations[label] = (ls[srt], tids[srt], vals[srt])

    # -- annealing primitives -----------------------------------------
    def shrinking(self, label):
        T = len(self.observations[label][0])
        return 1.0 / (1.0 + T * self.shrink_coef)

    def choose_ltv(self, label):
        """Loss-biased incumbent choice: rank ~ Geometric(1/avg_best_idx)."""
        ls, tids, vals = self.observations[label]
        if not len(ls):
            return None
        rank = min(
            int(self.rng.geometric(1.0 / self.avg_best_idx)) - 1, len(ls) - 1
        )
        return (float(ls[rank]), int(tids[rank]), vals[rank])

    def _incumbent(self, label):
        ltv = self.choose_ltv(label)
        return None if ltv is None else ltv[2]

    def _shrunk_uniform(self, label, val, low, high):
        width = (high - low) * self.shrinking(label)
        half = 0.5 * width
        midpt = np.clip(np.clip(val, low, high), low + half, high - half)
        return float(self.rng.uniform(midpt - half, midpt + half))

    @staticmethod
    def _q(x, q):
        return float(np.round(x / q) * q)

    # -- handlers ------------------------------------------------------
    def hp_uniform(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        return self._shrunk_uniform(label, val, p["low"], p["high"])

    def hp_quniform(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        return self._q(self._shrunk_uniform(label, val, p["low"], p["high"]), p["q"])

    def hp_uniformint(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        return int(
            self._q(
                self._shrunk_uniform(label, val, p["low"], p["high"]),
                p.get("q", 1.0),
            )
        )

    def hp_loguniform(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        log_val = np.log(np.maximum(val, 1e-12))
        return float(np.exp(self._shrunk_uniform(label, log_val, p["low"], p["high"])))

    def hp_qloguniform(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        log_val = np.log(np.maximum(val, 1e-12))
        raw = np.exp(self._shrunk_uniform(label, log_val, p["low"], p["high"]))
        return self._q(raw, p["q"])

    def hp_normal(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        return float(self.rng.normal(val, p["sigma"] * self.shrinking(label)))

    def hp_qnormal(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        return self._q(
            self.rng.normal(val, p["sigma"] * self.shrinking(label)), p["q"]
        )

    def hp_lognormal(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        log_val = np.log(np.maximum(val, 1e-12))
        return float(
            np.exp(self.rng.normal(log_val, p["sigma"] * self.shrinking(label)))
        )

    def hp_qlognormal(self, label, spec):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        p = spec.params
        log_val = np.log(np.maximum(val, 1e-12))
        raw = np.exp(self.rng.normal(log_val, p["sigma"] * self.shrinking(label)))
        return self._q(raw, p["q"])

    def _index_draw(self, label, spec, upper, offset=0):
        val = self._incumbent(label)
        if val is None:
            return prior_sample(spec, self.rng)
        if self.rng.uniform() < self.shrinking(label):
            return int(self.rng.integers(0, upper)) + offset
        return int(val)

    def hp_randint(self, label, spec):
        p = spec.params
        low = int(p.get("low", 0))
        return self._index_draw(label, spec, spec.upper, offset=low)

    def hp_categorical(self, label, spec):
        return self._index_draw(label, spec, spec.upper)


def suggest(new_ids, domain, trials, seed, avg_best_idx=2.0, shrink_coef=0.1):
    algo = AnnealingAlgo(
        domain, trials, seed, avg_best_idx=avg_best_idx, shrink_coef=shrink_coef
    )
    return algo.suggest_docs(list(new_ids))
