"""Acquisition criteria reference math.

Reference parity (SURVEY.md §2 #14): ``hyperopt/criteria.py`` —
``EI_empirical``, ``EI_gaussian``, ``logEI_gaussian`` (asymptotic branch),
``UCB``.  Maximization convention: EI is expected improvement *above*
``thresh``.  (TPE inlines its own l/g ratio; these are the reference
formulas, kept numpy for direct use and testing.)
"""

from __future__ import annotations

import numpy as np
from scipy.special import erf


def _phi(z):
    return np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)


def _Phi(z):
    return 0.5 * (1 + erf(z / np.sqrt(2)))


def EI_empirical(samples, thresh):
    """Expected improvement over ``thresh`` from an empirical sample set."""
    samples = np.asarray(samples, dtype=float)
    return float(np.maximum(samples - thresh, 0).mean())


def EI_gaussian(mean, var, thresh):
    """Analytic EI of a Gaussian belief above ``thresh``."""
    sigma = np.sqrt(var)
    z = (mean - thresh) / sigma
    return float(sigma * (z * _Phi(z) + _phi(z)))


def logEI_gaussian(mean, var, thresh):
    """log(EI_gaussian), with the asymptotic branch for very negative z
    (where the direct formula underflows to log(0))."""
    sigma = np.sqrt(var)
    z = (mean - thresh) / sigma
    if z > -34:
        return float(np.log(sigma * (z * _Phi(z) + _phi(z))))
    # z -> -inf: EI ~ sigma * phi(z) / z^2
    return float(
        np.log(sigma) - 0.5 * z ** 2 - 0.5 * np.log(2 * np.pi) - 2 * np.log(-z)
    )


def UCB(mean, var, zscore):
    """Upper confidence bound."""
    return float(mean + np.sqrt(var) * zscore)
