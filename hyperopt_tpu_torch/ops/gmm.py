"""Truncated (log-)GMM sampling and log-density scoring, label-stacked.

Reference parity (SURVEY.md §2 #11): ``hyperopt/tpe.py`` — ``GMM1``,
``GMM1_lpdf``, ``LGMM1``, ``LGMM1_lpdf`` and the q-variants via
``normal_cdf``/``lognormal_cdf`` erf sums (~L200-520).

Semantics notes (match the reference exactly, by construction):
- Truncation: the reference rejection-samples the *mixture* restricted to
  ``[low, high)``, i.e. density ∝ Σ wᵢ N(x; μᵢ, σᵢ) on the interval with a
  single global normalizer ``p_accept = Σ wᵢ (Φᵢ(high) − Φᵢ(low))``.  The
  equivalent here: re-weight components by their in-bounds mass
  (``wᵢ·Zᵢ``), then draw an exact truncated normal within the chosen
  component — same joint density, zero rejection loops.
- Log-scale (``LGMM1``): the mixture lives in log space; truncation bounds
  are log-space bounds; samples are exponentiated.
- Quantization: ``round(x/q)·q`` buckets; lpdf integrates the bucket via
  CDF differences (the reference's two-sided erf sum).

Every function takes a leading label axis: mixtures ``[L, K]``, points
``[L, C]``, bounds and ``q`` ``[L]``.  Random draws come in as uniform
streams, so the caller owns the generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .dists import inverse_cdf
from .parzen import linear_forgetting_weights_padded

_SQRT_2PI = 2.5066282746310002
_SQRT2 = math.sqrt(2.0)
_INV_SQRT2 = float(np.float32(1.0) / np.float32(_SQRT2))  # f32 1/√2, as XLA folds x/√2
EPS = 1e-12
# bound on the [L, chunk, K] intermediates of the per-candidate lpdf
_LPDF_CHUNK_ELEMS = 1 << 24


def _safe_log(x):
    return torch.log(x.clamp(min=EPS))


def _log_weights(w):
    """Component log-weights with exact-zero weights mapped to -inf.

    Padding components (weight exactly 0, from the padded Parzen fit) must
    contribute zero mass — ``_safe_log`` alone would give them a spurious
    ~1e-12 density floor visible deep in the tails."""
    return torch.where(w > 0, torch.log(w.clamp(min=EPS)), float("-inf"))


def _cdf(v, mu, sigma):
    """Normal CDF Φ((v−μ)/σ), safe for ±inf v."""
    z = (v - mu) / sigma.clamp(min=EPS)
    return torch.special.ndtr(z.clamp(-40.0, 40.0))


def _log_cdf_arg(v):
    """log of a raw-space quantized bound, mapping v<=0 to -inf (CDF 0)."""
    return torch.where(v > 0, torch.log(v.clamp(min=EPS)), float("-inf"))


def _fma(a, b, c):
    """``a·b + c`` rounded once to f32 (via f64, where ``a·b`` is exact)."""
    return (a.double() * b.double() + c).float()


def _horner(x, coefs):
    p = torch.zeros_like(x)
    for c in coefs:
        p = _fma(p, x, float(np.float32(c)))  # f32 coefficients, as XLA's
    return p


# XLA's f32 erf (Eigen's rational approximation) and erf_inv (Giles,
# "Approximating the erfinv function"), Horner steps as fused
# multiply-adds the way XLA's CPU backend contracts them.  Used by the
# truncated-normal draw so that streams injected from JAX reproduce its
# values to within float rounding; torch.erf / torch.erfinv differ from
# them by up to ~7 and ~60 ulp.
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.7439211627767994  # erfinv(1 - 2^-23): erf is ±1 beyond
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_f32(x):
    x = x.clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    return x * _horner(x2, _ERF_ALPHA) / _horner(x2, _ERF_BETA)


def erfinv_f32(x):
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = _fma(p, ww, torch.where(lt, c_lt, c_ge).double())
    # erfinv(±1) = ±inf: the polynomial is indeterminate there
    return torch.where(x.abs() == 1, x * torch.finfo(x.dtype).max, p * x)


def draw_param_rows(w, mu, sigma, low, high):
    """The truncated-GMM draw's per-component table ``[L, 7, K]``:

    ``cdf`` (cumsum of each component's in-bounds mass, the inverse-CDF
    table), ``mu``, ``sigma``, ``erf(a/√2)``, ``erf(b/√2)`` (the
    truncated-normal uniform bounds) and ``nextafter(a, +inf)``,
    ``nextafter(b, −inf)`` (its clamp bounds), with ``a``/``b`` the
    standardized bounds.  ``w``/``mu``/``sigma``: ``[L, K]``;
    ``low``/``high``: ``[L]``.  Reference: ``draw_param_rows`` of
    ``hyperopt_tpu/ops/pallas_fused.py``, with XLA's ``erf`` and its
    ``x·(1/√2)`` folding."""
    s = sigma.clamp(min=EPS)
    a = ((low[:, None] - mu) / s).clamp(-30.0, 30.0)
    b = ((high[:, None] - mu) / s).clamp(-30.0, 30.0)
    Z = torch.special.ndtr(b) - torch.special.ndtr(a)
    cdf = torch.cumsum((w * Z).clamp(min=0.0), dim=-1)
    inf = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    return torch.stack([
        cdf, mu, sigma, erf_f32(a * _INV_SQRT2), erf_f32(b * _INV_SQRT2),
        torch.nextafter(a, inf), torch.nextafter(b, -inf),
    ], dim=1)


def draw_from_rows(u_comp, u_val, rows, log_scale: bool):
    """Unquantized draws ``[L, n]`` from uniforms ``u_comp``/``u_val``
    (``[L, n]``) and the table of :func:`draw_param_rows`: an inverse-CDF
    component pick (``searchsorted(cdf, t, right=True)``, i.e. the count
    of ``cdf ≤ t``), then ``√2·erfinv`` of a uniform between the erf
    images of the bounds, clamped inside the open interval — the op chain
    of ``jax.random.truncated_normal``.  The fused kernel
    (``csrc/fused_suggest.cu``) repeats it term for term."""
    cdf = rows[:, 0].contiguous()
    total = cdf[:, -1:]
    t = torch.minimum(u_comp * total, total * (1.0 - 1e-6))
    comp = torch.searchsorted(cdf, t.contiguous(), right=True).clamp_(0, cdf.shape[1] - 1)

    def pick(r):
        return rows[:, r].gather(1, comp)

    ea, eb = pick(3), pick(4)
    u = torch.maximum(ea, _fma(u_val, eb - ea, ea))
    t = _SQRT2 * erfinv_f32(u)
    t = torch.minimum(torch.maximum(t, pick(5)), pick(6))
    x = _fma(pick(2), t, pick(1))
    return torch.exp(x) if log_scale else x


def gmm_sample(u_comp, u_val, w, mu, sigma, low, high, q, log_scale: bool):
    """Draw ``n`` values per label from the truncated (log-)GMMs.

    ``u_comp``/``u_val``: ``[L, n]`` uniforms on [0, 1) — the component
    pick and the truncated-normal draw.  ``low``/``high`` are (log-space
    if ``log_scale``) truncation bounds, ±inf for unbounded; ``q <= 0``
    disables quantization.

    Component selection is inverse-CDF over the components' in-bounds
    mass.  Zero-probability (padding) components occupy zero-width CDF
    intervals, which ``right=True`` search never selects.  The truncated
    normal is the inverse-CDF transform ``√2·erfinv(u)`` of a uniform
    between the erf images of the bounds, clamped inside the open
    interval — the op chain of ``jax.random.truncated_normal``, so streams
    injected from JAX give the same values to within float rounding
    (:func:`draw_param_rows`, :func:`draw_from_rows`).
    """
    x = draw_from_rows(u_comp, u_val, draw_param_rows(w, mu, sigma, low, high), log_scale)
    qq = q[:, None]
    return torch.where(qq > 0, torch.round(x / qq.clamp(min=EPS)) * qq, x)


def gmm_lpdf(x, w, mu, sigma, low, high, q, log_scale: bool, quantized: bool):
    """Log-density of ``x`` ([L, C]) under the truncated (log-)GMMs
    ([L, K]).  The ``[L, C, K]`` broadcast is evaluated in candidate
    chunks so its intermediate stays bounded at long histories."""
    sigma = sigma.clamp(min=EPS)
    lo, hi, qq = low[:, None], high[:, None], q[:, None]
    p_accept = torch.sum(w * (_cdf(hi, mu, sigma) - _cdf(lo, mu, sigma)), dim=1,
                         keepdim=True)
    chunk = max(1, _LPDF_CHUNK_ELEMS // max(1, x.shape[0] * w.shape[1]))
    parts = [
        _lpdf_block(x[:, c0:c0 + chunk], w, mu, sigma, lo, hi, qq, p_accept,
                    log_scale, quantized)
        for c0 in range(0, x.shape[1], chunk)
    ]
    return torch.cat(parts, dim=1)


def _lpdf_block(x, w, mu, sigma, lo, hi, qq, p_accept, log_scale, quantized):
    w3, mu3, s3 = w[:, None, :], mu[:, None, :], sigma[:, None, :]
    if not quantized:
        if log_scale:
            z = torch.where(x > 0, torch.log(x.clamp(min=EPS)), float("-inf"))
            jacobian = _safe_log(x)  # d(log x)/dx term of the lognormal pdf
        else:
            z = x
            jacobian = torch.zeros_like(x)
        mahal = ((z[:, :, None] - mu3) / s3) ** 2
        comp_ll = (-0.5 * mahal - torch.log(s3 * _SQRT_2PI)
                   + _log_weights(w)[:, None, :])
        ll = torch.logsumexp(comp_ll, dim=2) - jacobian - _safe_log(p_accept)
        # out-of-bounds or non-positive (log-scale) points have density 0
        if log_scale:
            in_bounds = (z >= lo) & (z < hi) & (x > 0)
        else:
            in_bounds = (x >= lo) & (x < hi)
        return torch.where(in_bounds, ll, float("-inf"))

    # quantized: integrate the bucket [x - q/2, x + q/2] ∩ bounds
    qe = qq.clamp(min=EPS)
    if log_scale:
        raw_low = torch.where(torch.isfinite(lo), torch.exp(lo), 0.0)
        raw_high = torch.where(torch.isfinite(hi), torch.exp(hi), float("inf"))
        ub = torch.minimum(x + qe / 2.0, raw_high)
        lb = torch.maximum(torch.maximum(x - qe / 2.0, raw_low), torch.zeros_like(x))
        ub_z = _log_cdf_arg(ub)
        lb_z = _log_cdf_arg(lb)
    else:
        ub_z = torch.minimum(x + qe / 2.0, hi)
        lb_z = torch.maximum(x - qe / 2.0, lo)
    prob = torch.sum(
        w3 * (_cdf(ub_z[:, :, None], mu3, s3) - _cdf(lb_z[:, :, None], mu3, s3)),
        dim=2,
    )
    return _safe_log(prob) - _safe_log(p_accept)


# ---------------------------------------------------------------------
# Categorical posterior
# ---------------------------------------------------------------------


def categorical_posterior(obs, n_obs, prior_p, prior_weight, upper: int, lf: int):
    """Posterior category probabilities ``[L, upper]``: forgetting-weighted
    counts plus ``upper · prior_weight · prior_p`` pseudocounts (reference:
    ``hyperopt/tpe.py`` — categorical posterior ~L520-570)."""
    w_chrono = linear_forgetting_weights_padded(n_obs, lf, obs.shape[1])
    obs_idx = obs.to(torch.int64).clamp(0, upper - 1)
    counts = torch.zeros(obs.shape[0], upper, dtype=torch.float32,
                         device=obs.device).scatter_add_(1, obs_idx, w_chrono)
    pseudocounts = counts + upper * prior_weight * prior_p
    return pseudocounts / pseudocounts.sum(dim=1, keepdim=True)


def categorical_sample(u, p):
    """Category indices ``[L, n]`` for uniforms ``u`` under ``p`` ([L, K]):
    an inverse-CDF draw."""
    return inverse_cdf(p, u)


def categorical_lpdf(x, p):
    return _log_weights(p).gather(1, x.to(torch.int64).clamp(0, p.shape[1] - 1))
