"""Search-space DSL facade.

Reference parity (SURVEY.md §2 #4): ``hyperopt/hp.py`` — thin re-exports of
the ``hp_*`` constructors in ``pyll_utils``.
"""

from .pyll_utils import (
    hp_choice as choice,
    hp_loguniform as loguniform,
    hp_lognormal as lognormal,
    hp_normal as normal,
    hp_pchoice as pchoice,
    hp_qloguniform as qloguniform,
    hp_qlognormal as qlognormal,
    hp_qnormal as qnormal,
    hp_quniform as quniform,
    hp_randint as randint,
    hp_uniform as uniform,
    hp_uniformint as uniformint,
)

__all__ = [
    "choice",
    "loguniform",
    "lognormal",
    "normal",
    "pchoice",
    "qloguniform",
    "qlognormal",
    "qnormal",
    "quniform",
    "randint",
    "uniform",
    "uniformint",
]
