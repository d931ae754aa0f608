"""Shared machinery for per-label suggest algorithms.

Reference parity (SURVEY.md §2 #9): ``hyperopt/algobase.py`` —
``ExprEvaluator`` / ``SuggestAlgo`` (~L20-270): walk the hyperparameters,
dispatch a per-distribution ``hp_<dist>`` handler, assemble misc docs.

Redesign: the reference walks the *vectorized pyll graph*; here algorithms
walk the compiled :class:`~hyperopt_tpu_torch.vectorize.ParamSpec` table (same
information, no graph interpretation) and activity masks come from the DNF
conditions.  Algorithms whose per-suggest math is O(labels) (anneal) stay
host-side numpy; the O(history × candidates) math (TPE) runs on the card
instead of through this class.
"""

from __future__ import annotations

import numpy as np

from ..base import miscs_update_idxs_vals
from ..vectorize import idxs_vals_from_batch


def prior_sample(spec, rng):
    """Draw one value from a ParamSpec's prior (numpy semantics)."""
    p = spec.params
    d = spec.dist

    def q_round(x, q):
        return np.round(x / q) * q

    if d == "uniform":
        return float(rng.uniform(p["low"], p["high"]))
    if d == "quniform":
        return float(q_round(rng.uniform(p["low"], p["high"]), p["q"]))
    if d == "uniformint":
        return int(q_round(rng.uniform(p["low"], p["high"]), p.get("q", 1.0)))
    if d == "loguniform":
        return float(np.exp(rng.uniform(p["low"], p["high"])))
    if d == "qloguniform":
        return float(q_round(np.exp(rng.uniform(p["low"], p["high"])), p["q"]))
    if d == "normal":
        return float(rng.normal(p["mu"], p["sigma"]))
    if d == "qnormal":
        return float(q_round(rng.normal(p["mu"], p["sigma"]), p["q"]))
    if d == "lognormal":
        return float(np.exp(rng.normal(p["mu"], p["sigma"])))
    if d == "qlognormal":
        return float(q_round(np.exp(rng.normal(p["mu"], p["sigma"])), p["q"]))
    if d == "randint":
        return int(rng.integers(p.get("low", 0), p["high"]))
    if d == "categorical":
        pr = np.asarray(p["p"], dtype=float)
        return int(rng.choice(len(pr), p=pr / pr.sum()))
    raise ValueError(d)


class SuggestAlgo:
    """Base class: per-label handler dispatch + trial-doc assembly."""

    def __init__(self, domain, trials, seed):
        self.domain = domain
        self.trials = trials
        self.rng = np.random.default_rng(seed)
        self.specs = domain.space.specs

    # -- per-label dispatch -------------------------------------------
    def on_node(self, label, spec):
        handler = getattr(self, f"hp_{spec.dist}", None)
        if handler is None:
            return prior_sample(spec, self.rng)
        return handler(label, spec)

    def active_for(self, chosen):
        """Evaluate each label's DNF conditions against chosen values."""
        active = {}
        for label, spec in self.specs.items():
            if not spec.conditions or any(len(c) == 0 for c in spec.conditions):
                active[label] = True
                continue
            active[label] = any(
                all(chosen[name] == val for (name, val) in conj)
                for conj in spec.conditions
            )
        return active

    # -- doc assembly --------------------------------------------------
    def __call__(self, new_id):
        chosen = {lb: self.on_node(lb, sp) for lb, sp in self.specs.items()}
        active = self.active_for(chosen)
        vals_arr = {lb: np.asarray([v]) for lb, v in chosen.items()}
        act_arr = {lb: np.asarray([active[lb]]) for lb in chosen}
        idxs, vals = idxs_vals_from_batch([new_id], vals_arr, act_arr, self.specs)
        misc = {
            "tid": new_id,
            "cmd": self.domain.cmd,
            "workdir": self.domain.workdir,
            "idxs": {},
            "vals": {},
        }
        miscs_update_idxs_vals([misc], idxs, vals)
        return self.trials.new_trial_docs(
            [new_id], [None], [self.domain.new_result()], [misc]
        )

    def suggest_docs(self, new_ids):
        docs = []
        for nid in new_ids:
            docs.extend(self(nid))
        return docs
