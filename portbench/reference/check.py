"""The comparison that decides ``correct``.

What a run hands in, per study: the history the benchmark made from the
seed (values and losses), and then every trial the program produced, in
order, as recorded: its id, its values and the loss the program stored.
The reference
recomputes every loss with the configuration's own objective, rebuilds
each sampled suggest's posterior from the history as it stood, and reads
each winner's deficit (:mod:`.tpe_reference`).

The numbers compared, each with a limit of its own
(``portbench/limits/<cell>.json``):

- ``failed``: trials or requests of the window that never produced an
  answer (limit 0);
- ``out_of_support``: recorded values the label cannot take (limit 0);
- ``loss_mismatch``: trials whose stored loss is not the objective's at
  their values (limit 0);
- ``winner_deficit_p90``: the 90th percentile of the winners' deficits
  over the sampled (suggest, label) pairs.  An exact argmax of
  ``n_EI_candidates`` draws gives deficits of mean 1 (p90 2.3); scoring in
  float32, as the port does, leaves near-ties among the best few of 8192
  candidates unresolved (score gaps under ~1e-5) and reads higher; a
  winner that is not an argmax of draws from l reads far higher.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import spaces
from . import tpe_reference as ref

QUANTILE = 90
TAU = 5.0  # the deficit above which a pair counts in the printed share
SAMPLE = 240  # suggests judged per run, drawn from the seed


def check_study(labels, loss_fn, study):
    """The exact checks of one study: ``(n_trials, out_of_support,
    loss_mismatch, losses)`` with ``losses`` the recomputed ones."""
    oos = mism = 0
    losses = []
    for t in study["trials"]:
        vals = t["vals"]
        ok = all(lab["label"] in vals and spaces.in_support(lab, vals[lab["label"]])
                 for lab in labels)
        oos += not ok
        loss = float(loss_fn(spaces.point_from_vals(labels, vals))) if ok else math.nan
        losses.append(loss)
        stored = t.get("stored_loss")
        if stored is None or not ok or float(stored) != loss:
            mism += 1
    return len(study["trials"]), oos, mism, losses


def deficits(labels, algo, study, losses, picks, rng, device):
    """The winners' deficits at the suggests ``picks`` (trial positions)."""
    n_cand = int(algo["n_EI_candidates"])
    hv = study["history_vals"]
    hl = np.asarray(study["history_losses"], np.float64)
    trials = study["trials"]
    out = []
    for j in picks:
        vals = {lab["label"]: np.concatenate(
            [hv[lab["label"]], [float(t["vals"][lab["label"]]) for t in trials[:j]]])
            for lab in labels}
        hist_losses = np.concatenate([hl, np.asarray(losses[:j], np.float64)])
        models = ref.label_models(labels, vals, hist_losses, algo, device)
        for m in models:
            out.append((m.lab["label"], m.deficit(float(trials[j]["vals"][m.lab["label"]]),
                                                  n_cand, float(rng.uniform(1e-12, 1.0)))))
    return out


def judge(cfg, loss_fn, studies, n_failed, seed, device, sample=SAMPLE):
    """Every number compared, from the studies a run produced.  Each
    study: ``history_vals``, ``history_losses``, ``trials`` (dicts with
    ``vals`` and ``stored_loss``) and
    ``window_from``, the position of its first trial of the window."""
    labels, algo = cfg["labels"], cfg["algo"]
    n = oos = mism = 0
    recomputed = []
    for st in studies:
        k, o, m, losses = check_study(labels, loss_fn, st)
        n, oos, mism = n + k, oos + o, mism + m
        recomputed.append(losses)
    rng = spaces.rng_for(seed, 9)
    pool = [(i, j) for i, st in enumerate(studies)
            for j in range(st["window_from"], len(st["trials"]))]
    take = sorted(rng.choice(len(pool), size=min(sample, len(pool)), replace=False)) \
        if pool else []
    picks = {}
    for p in take:
        i, j = pool[p]
        picks.setdefault(i, []).append(j)
    gamma, lf = float(algo.get("gamma", 0.25)), algo.get("linear_forgetting", 25)
    entries = 0   # window trials that joined the γ best as they were added
    for st, losses in zip(studies, recomputed):
        hl = np.concatenate([np.asarray(st["history_losses"], np.float64),
                             np.asarray(losses, np.float64)])
        n0 = len(st["history_losses"])
        entries += sum(bool(ref.below_mask(hl[:n0 + j + 1], gamma, lf)[-1])
                       for j in range(st["window_from"], len(losses))
                       if math.isfinite(losses[j]))
    defs = []
    if oos == 0:
        for i, js in picks.items():
            defs += deficits(labels, algo, studies[i], recomputed[i], js, rng, device)
    by_label = {}
    for name, d in defs:
        by_label.setdefault(name, []).append(d)
    defs = np.asarray([d for _, d in defs], np.float64)
    p90 = float(np.percentile(np.minimum(defs, 1e9), QUANTILE)) if len(defs) else math.nan
    return {
        "failed": int(n_failed),
        "out_of_support": int(oos),
        "loss_mismatch": int(mism),
        "winner_deficit_p90": p90,
    }, {
        "trials_checked": n,
        "below_entries": int(entries),
        "pairs_judged": int(len(defs)),
        "deficit_mean": float(defs[np.isfinite(defs)].mean()) if len(defs) else math.nan,
        "deficit_max": float(defs.max()) if len(defs) else math.nan,
        "deficit_share_above_tau": float(np.mean(defs > TAU)) if len(defs) else math.nan,
        "deficit_by_label": {k: [round(float(np.mean(np.minimum(v, 1e3))), 4),
                                 round(float(np.mean(np.asarray(v) > TAU)), 4)]
                             for k, v in by_label.items()},
    }


def verdict(numbers, limits):
    """``(correct, [(name, value, limit)])``: every number at or under
    its limit; a number that is NaN or has no limit fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
