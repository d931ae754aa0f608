"""Suggest algorithms.

Every algorithm is a function ``suggest(new_ids, domain, trials, seed, ...)``
returning new trial documents — the reference's plugin boundary
(``hyperopt/base.py — Trials.fmin``, SURVEY.md §1), preserved exactly.
"""

from . import anneal, atpe, criteria, mix, rand, tpe

__all__ = ["anneal", "atpe", "criteria", "mix", "rand", "tpe"]
