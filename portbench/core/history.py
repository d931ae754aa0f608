"""The history a cell starts from: a TPE study made by the plain reference.

A study that has run 10,000 trials was run by an optimizer, so the
benchmark makes its history with one: hyperopt's ``tpe.suggest`` at its
published defaults (:data:`UPSTREAM`), as the plain reference
(:mod:`portbench.reference.tpe_reference`, float64) computes it, from the
seed.  The first ``n_startup_jobs`` trials are drawn from the priors;
after them the study runs on ``workers`` workers in rounds: each round's
suggests are made from the history as the round found it, and their
losses, from the configuration's objective, join it together.  Nothing
here calls the program, so a change to the program's sampler never
changes a cell's inputs.

The reference runs on the device it is given, in a few large calls per
round; the same seed on the same device gives the same history.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import tpe_reference as ref
from . import spaces

UPSTREAM = {"n_EI_candidates": 24, "gamma": 0.25, "linear_forgetting": 25,
            "n_startup_jobs": 20, "prior_weight": 1.0}


def torch_generator(seed: int, tag: int, device) -> torch.Generator:
    """A torch stream for ``(seed, tag)`` on ``device``; any whole seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 63, tag, 1]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) % 2 ** 63)


def _recorded(lab, v):
    """Values as the program records them: float32-exact floats."""
    if lab["dist"] in spaces.INDEX:
        return np.asarray(v, np.int64)
    return np.asarray(v, np.float64).astype(np.float32).astype(np.float64)


def make_history(labels, loss_fn, seed, tag, n, device, workers):
    """``n`` completed trials of a TPE study: ``(vals, losses)``, ``vals``
    a dict of arrays in trial order, ``losses`` float64 values that
    float32 represents exactly (the program ranks losses in float32)."""
    rng = spaces.rng_for(seed, tag)
    gen = torch_generator(seed, tag, device)
    first = min(n, int(UPSTREAM["n_startup_jobs"]))
    vals = {lab["label"]: spaces.sample_prior(lab, rng, first) for lab in labels}
    losses = np.asarray(loss_fn(spaces.point_from_vals(labels, vals)), np.float64)
    while len(losses) < n:
        k = min(int(workers), n - len(losses))
        new = ref.reference_round(labels, vals, losses, UPSTREAM,
                                  int(UPSTREAM["n_EI_candidates"]), k, gen, device)
        new = {lab["label"]: _recorded(lab, new[lab["label"]]) for lab in labels}
        for name in vals:
            vals[name] = np.concatenate([vals[name], new[name]])
        losses = np.concatenate([losses, np.asarray(
            loss_fn(spaces.point_from_vals(labels, new)), np.float64).reshape(k)])
    return vals, losses.astype(np.float32).astype(np.float64)

