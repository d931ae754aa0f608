"""Numeric core of the PyTorch port against the JAX package, on the CPU:
Parzen fit, ``pair_params``, ``gmm_sample`` with JAX's own uniform
streams, ``gmm_lpdf``, the categorical kernels, and the pair-score
kernel's module (its plain version) against the Pallas kernel in
interpret mode and against ``pair_score``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from hyperopt_tpu.ops import gmm as jgmm
from hyperopt_tpu.ops import parzen as jparzen
from hyperopt_tpu.ops.pallas_gmm import pair_score_pallas_batched
from hyperopt_tpu.ops.score import pair_params as j_pair_params
from hyperopt_tpu_torch.ops import gmm as tgmm
from hyperopt_tpu_torch.ops import parzen as tparzen
from hyperopt_tpu_torch.ops.pair_kernel import pair_score_batched
from hyperopt_tpu_torch.ops.score import NEG_BIG, pair_params, pair_score

EPS32 = np.finfo(np.float32).eps


def ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def t(a):
    return torch.tensor(np.array(a))


def make_pair(K=37, seed=0, padded_tail=5):
    """The mixture pairs of tests/test_score_kernels.py."""
    rng = np.random.default_rng(seed)

    def mk():
        w = rng.uniform(0.1, 1.0, K).astype(np.float32)
        if padded_tail:
            w[-padded_tail:] = 0.0
        w /= w.sum()
        mu = rng.normal(0, 2, K).astype(np.float32)
        s = rng.uniform(0.5, 2.0, K).astype(np.float32)
        return w, mu, s

    return mk(), mk()


# -- Parzen fit and pair_params: within 1 ulp ---------------------------

@pytest.mark.parametrize("pad", [8, 16, 32])
@pytest.mark.parametrize("lf", [0, 5, 25])
def test_parzen_fit_within_1ulp(pad, lf):
    rng = np.random.default_rng(pad + lf)
    L = 4
    obs = rng.normal(0, 2, (L, pad)).astype(np.float32)
    n = np.array([0, 1, pad // 2, pad])
    pm = rng.normal(0, 1, L).astype(np.float32)
    ps = rng.uniform(0.5, 3, L).astype(np.float32)
    got = tparzen.adaptive_parzen_normal_padded(t(obs), t(n), 1.0, t(pm), t(ps), lf)
    for l in range(L):
        ref = jparzen.adaptive_parzen_normal_padded(obs[l], n[l], np.float32(1.0),
                                                    pm[l], ps[l], lf)
        for r, g in zip(ref, got):
            assert ulps(r, g[l].numpy()).max() <= 1


@pytest.mark.parametrize("K,padded_tail", [(8, 3), (37, 5), (130, 3), (137, 10), (300, 4)])
def test_pair_params_within_1ulp(K, padded_tail):
    """Rows z² and z within 1 ulp.  The constant row is
    ``log w − log σ − c − ½μ²/σ²``: torch's ``log`` and XLA's differ by
    1 ulp on some inputs, and the difference of two logs can carry two
    such errors, so that row is held to 2 ulp."""
    below, above = make_pair(K=K, padded_tail=padded_tail)
    ref = np.asarray(j_pair_params(*below, *above))
    got = pair_params(*(t(a) for a in below), *(t(a) for a in above)).numpy()
    d = ulps(ref, got)
    assert d[:2].max() <= 1
    assert d[2].max() <= 2


# -- gmm_sample with JAX's own streams ---------------------------------

@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("low,high", [(-np.inf, np.inf), (-1.0, 2.5), (0.5, np.inf)])
def test_gmm_sample_with_jax_streams(log_scale, low, high):
    """With JAX's streams (``k_comp, k_val = split(key)``, ``uniform`` on
    each, as ``tpe_device.py:769-771``), the port reproduces JAX
    ``gmm_sample(key, ...)``.  Tolerance: 2 ulp, the reference's own for
    a re-derived draw (``pallas_fused.py:56-61``), on >= 98% of draws;
    the rest differ by torch's ``log1p``/``exp`` against XLA's by an ulp,
    amplified where ``mu + sigma·t`` cancels, so every draw is held to
    2 ulp of the sample's scale (atol) and 2e-6 relative."""
    (w, mu, s), _ = make_pair(K=60, seed=7)
    n = 4096
    key = jax.random.PRNGKey(11)
    lo, hi = np.float32(low), np.float32(high)
    ref = np.asarray(jgmm.gmm_sample(key, w, mu, s, lo, hi, np.float32(0.0), n,
                                     log_scale))
    k_comp, k_val = jax.random.split(key)
    u1 = np.asarray(jax.random.uniform(k_comp, (n,), jnp.float32))
    u2 = np.asarray(jax.random.uniform(k_val, (n,), jnp.float32))
    got = tgmm.gmm_sample(t(u1)[None], t(u2)[None], t(w)[None], t(mu)[None],
                          t(s)[None], t([lo]), t([hi]), t([np.float32(0)]),
                          log_scale)[0].numpy()
    assert np.mean(ulps(ref, got) <= 2) >= 0.98
    np.testing.assert_allclose(got, ref, rtol=2e-6,
                               atol=2 * EPS32 * np.abs(ref).max())


def test_gmm_sample_quantized_and_distribution():
    (w, mu, s), _ = make_pair(K=20, seed=3, padded_tail=0)
    g = torch.Generator().manual_seed(0)
    u = torch.rand((2, 1, 20000), generator=g)
    q = np.float32(0.5)
    x = tgmm.gmm_sample(u[0], u[1], t(w)[None], t(mu)[None], t(s)[None],
                        t([np.float32(-np.inf)]), t([np.float32(np.inf)]), t([q]),
                        False)[0].numpy()
    np.testing.assert_allclose(np.round(x / q) * q, x)
    # the unquantized draw follows the mixture: KS against its CDF
    y = tgmm.gmm_sample(u[0], u[1], t(w)[None], t(mu)[None], t(s)[None],
                        t([np.float32(-np.inf)]), t([np.float32(np.inf)]),
                        t([np.float32(0)]), False)[0].numpy()

    def cdf(v):
        return np.sum(w[None] * stats.norm.cdf((v[:, None] - mu[None]) / s[None]), axis=1)

    assert stats.kstest(y, cdf).pvalue > 1e-3


@pytest.mark.parametrize("log_scale,quantized", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_gmm_lpdf_matches_jax(log_scale, quantized):
    (w, mu, s), _ = make_pair(K=30, seed=5)
    rng = np.random.default_rng(2)
    if log_scale:
        x = np.exp(rng.uniform(-2, 2, 200)).astype(np.float32)
        lo, hi = np.float32(-1.5), np.float32(np.inf)
    else:
        x = rng.uniform(-4, 4, 200).astype(np.float32)
        lo, hi = np.float32(-3.0), np.float32(3.5)
    q = np.float32(0.25 if quantized else 0.0)
    if quantized:
        x = (np.round(x / q) * q).astype(np.float32)
    ref = np.asarray(jgmm.gmm_lpdf(x, w, mu, s, lo, hi, q, log_scale, quantized))
    got = tgmm.gmm_lpdf(t(x)[None], t(w)[None], t(mu)[None], t(s)[None], t([lo]),
                        t([hi]), t([q]), log_scale, quantized)[0].numpy()
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    # ndtr/erf differ by a few ulp between torch and XLA
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-5, atol=1e-5)


def test_categorical_posterior_and_lpdf_match_jax():
    rng = np.random.default_rng(4)
    upper, pad = 5, 16
    obs = rng.integers(0, upper, (2, pad)).astype(np.float32)
    n = np.array([3, 12])
    prior = np.array([[0.1, 0.2, 0.3, 0.4, 0.0], [0.2] * 5], np.float32)
    got = tgmm.categorical_posterior(t(obs), t(n), t(prior), 1.0, upper, 25).numpy()
    for l in range(2):
        ref = np.asarray(jgmm.categorical_posterior(obs[l], n[l], prior[l],
                                                    np.float32(1.0), upper, 25))
        np.testing.assert_allclose(got[l], ref, rtol=1e-6)
    x = np.array([[0, 1, 4, 2], [4, 3, 0, 0]])
    lp = tgmm.categorical_lpdf(t(x), t(prior)).numpy()
    for l in range(2):
        np.testing.assert_array_equal(lp[l], np.asarray(jgmm.categorical_lpdf(x[l], prior[l])))


def test_categorical_sample_chi2_against_posterior():
    p = np.array([[0.1, 0.0, 0.5, 0.15, 0.25]], np.float32)
    u = torch.rand((1, 20000), generator=torch.Generator().manual_seed(1))
    draws = tgmm.categorical_sample(u, t(p))[0].numpy()
    counts = np.bincount(draws, minlength=5)
    assert counts[1] == 0  # zero-probability categories are never drawn
    keep = p[0] > 0
    assert stats.chisquare(counts[keep], p[0][keep] * len(draws)).pvalue > 1e-3


# -- the pair-score kernel's module ------------------------------------

# summation order of a long logsumexp differs between the Pallas tiles,
# the chunked matmul and the kernel: atol=1e-4, rtol=1e-5
TOL = dict(atol=1e-4, rtol=1e-5)


def _batched_case(L, C, kb, ka, seed, pad_b=0, pad_a=0):
    rng = np.random.default_rng(seed)
    zs, ps = [], []
    for l in range(L):
        wb = rng.uniform(0.1, 1, kb).astype(np.float32)
        wa = rng.uniform(0.1, 1, ka).astype(np.float32)
        if pad_b:
            wb[-pad_b:] = 0.0
        if pad_a:
            wa[-pad_a:] = 0.0
        wb /= max(wb.sum(), 1e-12)
        wa /= max(wa.sum(), 1e-12)
        mk = [rng.normal(0, 2, kb).astype(np.float32), rng.uniform(0.3, 2, kb).astype(np.float32)]
        ma = [rng.normal(0, 2, ka).astype(np.float32), rng.uniform(0.3, 2, ka).astype(np.float32)]
        ps.append(np.asarray(j_pair_params(wb, *mk, wa, *ma)))
        zs.append(rng.uniform(-4, 4, C).astype(np.float32))
    return np.stack(zs), np.stack(ps)


CASES = {
    "kb1": dict(L=2, C=70, kb=1, ka=40),
    "ragged_k": dict(L=2, C=130, kb=33, ka=257),
    "padded_regions": dict(L=2, C=64, kb=9, ka=137, pad_b=4, pad_a=10),
    "l3": dict(L=3, C=200, kb=17, ka=50, pad_a=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_score_batched_matches_pallas_interpret_and_plain(case):
    z, P = _batched_case(seed=len(case), **CASES[case])
    kb = CASES[case]["kb"]
    got = pair_score_batched(t(z), t(P), kb).numpy()
    ref = np.asarray(pair_score_pallas_batched(z, P, kb, tc=64, tk=128, interpret=True))
    np.testing.assert_allclose(got, ref, **TOL)
    plain = pair_score(t(z), t(P), kb, chunk=48).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


def test_pair_score_all_padding_region_adds_no_mass():
    """A region padded entirely with weight-0 (NEG_BIG logcoef) columns
    after its real ones scores as if the padding were absent."""
    z, P = _batched_case(L=2, C=50, kb=8, ka=30, seed=9)
    pad = np.zeros((2, 3, 64), np.float32)
    pad[:, 2, :] = NEG_BIG
    padded = np.concatenate([P, pad], axis=2)
    base = pair_score_batched(t(z), t(P), 8).numpy()
    got = pair_score_batched(t(z), t(padded), 8).numpy()
    np.testing.assert_allclose(got, base, **TOL)
    ref = np.asarray(pair_score_pallas_batched(z, padded, 8, tc=64, tk=128,
                                               interpret=True))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("bad", ["dtype", "shape", "k_below", "contiguity"])
def test_pair_score_batched_refuses_bad_input(bad):
    z, P = _batched_case(L=2, C=20, kb=4, ka=10, seed=1)
    z, P, kb = t(z), t(P), 4
    if bad == "dtype":
        z = z.double()
    elif bad == "shape":
        P = P[:1]
    elif bad == "k_below":
        kb = P.shape[2]
    else:
        z = z.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        pair_score_batched(z, P, kb)


def test_cpu_tensors_never_count_a_launch():
    z, P = _batched_case(L=2, C=20, kb=4, ka=10, seed=2)
    before = pair_score_batched.launches
    pair_score_batched(t(z), t(P), 4)
    assert pair_score_batched.launches == before
