"""Stochastic scope symbols + graph sampling.

Reference parity (SURVEY.md §2 #2): ``hyperopt/pyll/stochastic.py`` —
``@implicit_stochastic`` registry, distribution scope symbols (~L20-130),
``recursive_set_rng_kwarg`` (~L130-155), ``sample`` (~L155-170).

These numpy implementations define the *semantics* of every distribution
(support, quantization rule) and serve the interpreted fallback path and the
statistical test suite.  The device execution path does not call them per
trial: ``hyperopt_tpu_torch.vectorize`` lowers the same distributions onto
``torch.Generator`` draws (see ``hyperopt_tpu_torch.ops.dists``) in place of
the mutable ``rng`` literal injected here.
"""

from __future__ import annotations

import numpy as np

from .base import Apply, Literal, as_apply, clone, dfs, rec_eval, scope

# names of scope symbols that consume an `rng` keyword implicitly
implicit_stochastic_symbols = set()


def implicit_stochastic(f):
    implicit_stochastic_symbols.add(f.__name__)
    return f


def _rng(rng):
    if rng is None:
        raise ValueError(
            "stochastic node evaluated without an rng; use "
            "hyperopt_tpu_torch.pyll.stochastic.sample() or inject one with "
            "recursive_set_rng_kwarg()"
        )
    return rng


def _quantize(x, q):
    return np.round(x / q) * q


@implicit_stochastic
@scope.define
def uniform(low, high, rng=None, size=()):
    return _rng(rng).uniform(low, high, size=size)


@implicit_stochastic
@scope.define
def loguniform(low, high, rng=None, size=()):
    # low/high are bounds in log space, as in the reference DSL
    return np.exp(_rng(rng).uniform(low, high, size=size))


@implicit_stochastic
@scope.define
def quniform(low, high, q, rng=None, size=()):
    return _quantize(_rng(rng).uniform(low, high, size=size), q)


@implicit_stochastic
@scope.define
def qloguniform(low, high, q, rng=None, size=()):
    return _quantize(np.exp(_rng(rng).uniform(low, high, size=size)), q)


@implicit_stochastic
@scope.define
def uniformint(low, high, q=1.0, rng=None, size=()):
    return _quantize(_rng(rng).uniform(low, high, size=size), q).astype(np.int64)


@implicit_stochastic
@scope.define
def normal(mu, sigma, rng=None, size=()):
    return _rng(rng).normal(mu, sigma, size=size)


@implicit_stochastic
@scope.define
def qnormal(mu, sigma, q, rng=None, size=()):
    return _quantize(_rng(rng).normal(mu, sigma, size=size), q)


@implicit_stochastic
@scope.define
def lognormal(mu, sigma, rng=None, size=()):
    return np.exp(_rng(rng).normal(mu, sigma, size=size))


@implicit_stochastic
@scope.define
def qlognormal(mu, sigma, q, rng=None, size=()):
    return _quantize(np.exp(_rng(rng).normal(mu, sigma, size=size)), q)


@implicit_stochastic
@scope.define
def randint(low, high=None, rng=None, size=()):
    """``randint(upper)`` draws from [0, upper); ``randint(low, high)``
    from [low, high) — both reference DSL forms."""
    if high is None:
        low, high = 0, low
    return _rng(rng).integers(low, high, size=size)


@implicit_stochastic
@scope.define
def randint_via_categorical(p, rng=None, size=()):
    """Categorical draw used by TPE's posterior over integer/choice params."""
    p = np.asarray(p, dtype=np.float64)
    p = p / p.sum()
    rng = _rng(rng)
    if size == () or size is None:
        return np.argmax(rng.multinomial(1, p))
    n = int(np.prod(size))
    draws = np.array([np.argmax(rng.multinomial(1, p)) for _ in range(n)])
    return draws.reshape(size)


@implicit_stochastic
@scope.define
def categorical(p, upper=None, rng=None, size=()):
    """Draw an index according to probability vector ``p``."""
    p = np.asarray(p, dtype=np.float64)
    if p.ndim == 2 and p.shape[0] == 1:
        p = p[0]
    p = p / p.sum()
    rng = _rng(rng)
    if size == () or size is None:
        return np.argmax(rng.multinomial(1, p))
    n = int(np.prod(size))
    draws = np.array([np.argmax(rng.multinomial(1, p)) for _ in range(n)])
    return draws.reshape(size)


def recursive_set_rng_kwarg(expr, rng=None):
    """Inject an rng literal into every implicit-stochastic node in place."""
    if rng is None:
        rng = np.random.default_rng()
    rng_lit = rng if isinstance(rng, Apply) else Literal(rng)
    for node in dfs(as_apply(expr)):
        if node.name in implicit_stochastic_symbols:
            if not any(k == "rng" for k, _ in node.named_args):
                node.named_args.append(["rng", rng_lit])
                node.named_args.sort(key=lambda kv: kv[0])
    return expr


def sample(expr, rng=None, **kwargs):
    """Draw one realization of a stochastic expression graph.

    Clones the graph (so the caller's space is untouched), injects the rng,
    and evaluates.  This is the interpreted reference path; the compiled path
    is ``CompiledSpace.sample_batch`` in ``hyperopt_tpu_torch.vectorize``.
    """
    if rng is None:
        rng = np.random.default_rng()
    if isinstance(rng, np.random.RandomState):  # legacy numpy API
        rng = np.random.default_rng(rng.randint(2 ** 31))
    foo = recursive_set_rng_kwarg(clone(as_apply(expr)), rng)
    return rec_eval(foo, **kwargs)
