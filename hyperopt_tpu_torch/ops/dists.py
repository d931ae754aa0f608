"""Torch samplers for the search-space DSL distributions.

The numpy implementations in ``hyperopt_tpu_torch.pyll.stochastic`` define
the semantics (support + quantization rule); these are the batched torch
versions the compiled sampler uses — same distributions, drawn from an
explicit ``torch.Generator`` instead of a shared mutable rng (reference:
``hyperopt/pyll/stochastic.py`` ~L20-130).

Every sampler has signature ``f(gen, params: dict, n: int) -> Tensor``;
the tensor lies on the generator's device.  Quantization matches the
reference rule ``round(x / q) * q`` (round-half-to-even, numpy semantics)
exactly: ``torch.round`` rounds half to even.
"""

from __future__ import annotations

import torch

_FLOAT = torch.float32
_INT = torch.int32


def _quantize(x, q):
    return torch.round(x / q) * q


def _f32(v, gen):
    return torch.tensor(v, dtype=_FLOAT, device=gen.device)


def uniform(gen, p, n):
    lo, hi = _f32(p["low"], gen), _f32(p["high"], gen)
    u = torch.rand(n, generator=gen, device=gen.device, dtype=_FLOAT)
    return torch.maximum(lo, u * (hi - lo) + lo)


def quniform(gen, p, n):
    return _quantize(uniform(gen, p, n), p["q"])


def loguniform(gen, p, n):
    return torch.exp(uniform(gen, p, n))


def qloguniform(gen, p, n):
    return _quantize(loguniform(gen, p, n), p["q"])


def uniformint(gen, p, n):
    # reference semantics: round(uniform(low, high) / q) * q, as integer —
    # endpoints get half weight (NOT the same as randint(low, high))
    return _quantize(uniform(gen, p, n), p.get("q", 1.0)).to(_INT)


def normal(gen, p, n):
    z = torch.randn(n, generator=gen, device=gen.device, dtype=_FLOAT)
    return _f32(p["mu"], gen) + _f32(p["sigma"], gen) * z


def qnormal(gen, p, n):
    return _quantize(normal(gen, p, n), p["q"])


def lognormal(gen, p, n):
    return torch.exp(normal(gen, p, n))


def qlognormal(gen, p, n):
    return _quantize(lognormal(gen, p, n), p["q"])


def randint(gen, p, n):
    low = int(p.get("low", 0))
    high = int(p["high"])
    return torch.randint(low, high, (n,), generator=gen, device=gen.device,
                         dtype=_INT)


def inverse_cdf(p, u):
    """Category indices for uniforms ``u`` ([..., n]) under the
    (unnormalized) probabilities ``p`` ([..., K]): ``searchsorted`` on the
    cumulative mass.  Zero-probability categories own zero-width CDF
    intervals, which ``right=True`` never selects; ``t`` is clamped below
    the total so f32 rounding of ``u·total`` cannot step past the last
    positive category."""
    cdf = torch.cumsum(p, dim=-1)
    total = cdf[..., -1:]
    t = torch.minimum(u * total, total * (1.0 - 1e-6))
    idx = torch.searchsorted(cdf.contiguous(), t.contiguous(), right=True)
    return idx.clamp_(0, p.shape[-1] - 1)


def categorical(gen, p, n):
    probs = torch.as_tensor(p["p"], dtype=_FLOAT, device=gen.device)
    u = torch.rand(n, generator=gen, device=gen.device, dtype=_FLOAT)
    return inverse_cdf(probs, u).to(_INT)


SAMPLERS = {
    "uniform": uniform,
    "quniform": quniform,
    "loguniform": loguniform,
    "qloguniform": qloguniform,
    "uniformint": uniformint,
    "normal": normal,
    "qnormal": qnormal,
    "lognormal": lognormal,
    "qlognormal": qlognormal,
    "randint": randint,
    "categorical": categorical,
}

# distributions whose values are integer-valued indices/counts
INT_DISTS = {"uniformint", "randint", "categorical"}
