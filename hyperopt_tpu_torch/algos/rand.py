"""Random search.

Reference parity (SURVEY.md §2 #8): ``hyperopt/rand.py`` —
``suggest(new_ids, domain, trials, seed)``, ``suggest_batch``.

The whole batch of ``new_ids`` is drawn by the space's compiled sampler in
one pass on the device (``CompiledSpace.sample_batch``), with
branch-activity masks deciding which labels appear in each trial's sparse
idxs/vals.
"""

from __future__ import annotations

from ..base import miscs_update_idxs_vals
from ..vectorize import idxs_vals_from_batch


def suggest_batch(new_ids, domain, trials, seed, device=None):
    """Draw one configuration per id → aggregated (idxs, vals) dicts."""
    vals, active = domain.space.sample_batch(seed, len(new_ids), device=device)
    return idxs_vals_from_batch(new_ids, vals, active, domain.space.specs)


def suggest(new_ids, domain, trials, seed, device=None):
    """``device``: where the draws run (None: the CUDA card)."""
    new_ids = list(new_ids)
    idxs, vals = suggest_batch(new_ids, domain, trials, seed, device=device)
    miscs = [
        {"tid": tid, "cmd": domain.cmd, "workdir": domain.workdir, "idxs": {}, "vals": {}}
        for tid in new_ids
    ]
    miscs_update_idxs_vals(miscs, idxs, vals)
    results = [domain.new_result() for _ in new_ids]
    return trials.new_trial_docs(new_ids, [None] * len(new_ids), results, miscs)


# random search reads nothing from the trial history: a speculative
# suggestion computed before a trial completed equals one computed after,
# so the speculative engine never relaunches it
suggest.speculation_policy = "independent"
