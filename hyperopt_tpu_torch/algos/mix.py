"""Mixture-of-algorithms suggest.

Reference parity (SURVEY.md §2 #16): ``hyperopt/mix.py`` —
``suggest(new_ids, domain, trials, seed, p_suggest)``: a categorical draw
over sub-algorithms per suggest call.

Usage::

    algo = partial(mix.suggest, p_suggest=[
        (0.1, rand.suggest),
        (0.2, anneal.suggest),
        (0.7, tpe.suggest),
    ])
"""

from __future__ import annotations

import numpy as np


def suggest(new_ids, domain, trials, seed, p_suggest):
    """Draw a sub-algorithm ~ p, then delegate with a derived seed."""
    rng = np.random.default_rng(seed)
    ps, suggests = list(zip(*p_suggest))
    ps = np.asarray(ps, dtype=float)
    if abs(ps.sum() - 1.0) > 1e-5:
        raise ValueError(f"p_suggest probabilities must sum to 1: {ps}")
    idx = rng.choice(len(suggests), p=ps / ps.sum())
    return suggests[idx](
        new_ids, domain, trials, seed=int(rng.integers(2 ** 31 - 1))
    )
