"""Exact scipy-style mirrors of the DSL distributions.

Reference parity (SURVEY.md §2 #22): ``hyperopt/rdists.py`` —
``loguniform_gen``, ``lognorm_tx_gen``, ``quniform_gen``,
``qloguniform_gen``, ``qnormal_gen``, ``qlognormal_gen``: closed-form
pdfs/cdfs/pmfs for every ``hp.*`` distribution, used by the statistical
(KS / total-variation) conformance tests to pin the compiled sampler to
the exact semantics.  A copy of ``hyperopt_tpu/rdists.py``: numpy and
scipy only.
"""

from __future__ import annotations

import numpy as np
from scipy import stats
from scipy.stats import rv_continuous


class loguniform_gen(rv_continuous):
    """x with log(x) ~ Uniform(low, high); support [e^low, e^high]."""

    def __init__(self, low=0, high=1):
        super().__init__(a=np.exp(low), b=np.exp(high), name="loguniform")
        self._low = low
        self._high = high

    def _pdf(self, x):
        return 1.0 / (x * (self._high - self._low))

    def _logpdf(self, x):
        return -np.log(x) - np.log(self._high - self._low)

    def _cdf(self, x):
        return (np.log(x) - self._low) / (self._high - self._low)


class lognorm_tx_gen:
    """exp(Normal(mu, sigma)) — thin adapter over scipy.stats.lognorm."""

    def __init__(self, mu, sigma):
        self._dist = stats.lognorm(s=sigma, scale=np.exp(mu))

    def __getattr__(self, name):
        return getattr(self._dist, name)


class _QuantizedBase:
    """Discrete distribution over the quantization grid {k·q}.

    ``pmf(v) = F(min(v+q/2, hi)) − F(max(v−q/2, lo))`` where F is the
    underlying continuous CDF — exactly the mass that rounds to v.
    """

    def __init__(self, q):
        self.q = q

    # subclasses: _base_cdf(x), support()
    def _bucket(self, v):
        v = np.asarray(v, dtype=float)
        ub = v + self.q / 2.0
        lb = v - self.q / 2.0
        return lb, ub

    def pmf(self, v):
        v = np.asarray(v, dtype=float)
        on_grid = np.isclose(np.round(v / self.q) * self.q, v, atol=1e-9)
        lb, ub = self._bucket(v)
        p = self._base_cdf(ub) - self._base_cdf(lb)
        return np.where(on_grid, np.maximum(p, 0.0), 0.0)

    def logpmf(self, v):
        with np.errstate(divide="ignore"):
            return np.log(self.pmf(v))

    def cdf(self, v):
        lb, ub = self._bucket(v)
        return self._base_cdf(ub)

    def rvs(self, size=(), random_state=None):
        rng = np.random.default_rng(random_state)
        x = self._base_rvs(size, rng)
        return np.round(x / self.q) * self.q


class quniform_gen(_QuantizedBase):
    def __init__(self, low, high, q):
        super().__init__(q)
        self.low, self.high = low, high

    def _base_cdf(self, x):
        return np.clip((np.asarray(x) - self.low) / (self.high - self.low), 0, 1)

    def _base_rvs(self, size, rng):
        return rng.uniform(self.low, self.high, size=size)

    def support(self):
        lo = np.round(self.low / self.q) * self.q
        hi = np.round(self.high / self.q) * self.q
        return np.arange(lo, hi + self.q / 2, self.q)


class qloguniform_gen(_QuantizedBase):
    def __init__(self, low, high, q):
        super().__init__(q)
        self.low, self.high = low, high  # log-space bounds

    def _base_cdf(self, x):
        x = np.asarray(x, dtype=float)
        with np.errstate(divide="ignore"):
            lx = np.where(x > 0, np.log(np.maximum(x, 1e-300)), -np.inf)
        return np.clip((lx - self.low) / (self.high - self.low), 0, 1)

    def _base_rvs(self, size, rng):
        return np.exp(rng.uniform(self.low, self.high, size=size))

    def support(self):
        lo = np.round(np.exp(self.low) / self.q) * self.q
        hi = np.round(np.exp(self.high) / self.q) * self.q
        return np.arange(max(lo, 0.0), hi + self.q / 2, self.q)


class qnormal_gen(_QuantizedBase):
    def __init__(self, mu, sigma, q):
        super().__init__(q)
        self.mu, self.sigma = mu, sigma

    def _base_cdf(self, x):
        return stats.norm.cdf(x, loc=self.mu, scale=self.sigma)

    def _base_rvs(self, size, rng):
        return rng.normal(self.mu, self.sigma, size=size)


class qlognormal_gen(_QuantizedBase):
    def __init__(self, mu, sigma, q):
        super().__init__(q)
        self.mu, self.sigma = mu, sigma

    def _base_cdf(self, x):
        x = np.asarray(x, dtype=float)
        return np.where(
            x > 0,
            stats.lognorm.cdf(np.maximum(x, 1e-300), s=self.sigma, scale=np.exp(self.mu)),
            0.0,
        )

    def _base_rvs(self, size, rng):
        return np.exp(rng.normal(self.mu, self.sigma, size=size))
