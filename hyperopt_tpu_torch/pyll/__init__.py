"""Expression-graph frontend (the ``pyll`` equivalent).

Mirrors the public surface of ``hyperopt.pyll``: ``scope``, ``Apply``,
``Literal``, ``as_apply``, ``rec_eval``, ``dfs``, ``toposort``, ``clone``,
``clone_merge``, and ``stochastic.sample``.
"""

from . import base, stochastic
from .base import (
    Apply,
    GarbageCollected,
    Literal,
    as_apply,
    clone,
    clone_merge,
    dfs,
    rec_eval,
    scope,
    toposort,
)
from .stochastic import implicit_stochastic_symbols, recursive_set_rng_kwarg, sample

__all__ = [
    "Apply",
    "GarbageCollected",
    "Literal",
    "as_apply",
    "base",
    "clone",
    "clone_merge",
    "dfs",
    "implicit_stochastic_symbols",
    "rec_eval",
    "recursive_set_rng_kwarg",
    "sample",
    "scope",
    "stochastic",
    "toposort",
]
