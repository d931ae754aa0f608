"""The fused scorer tier of the PyTorch port against the JAX package, on the
CPU: the fused kernel's module (its plain version) against
``fused_suggest_pallas`` in interpret mode on the reference's shape grid,
``draw_param_rows``, ``ei_from_partials``, the tier resolvers, the port's
``tpe.suggest`` on the fused tier, and the single-label core
``_continuous_best_core`` (the module of the single-label kernel) against
JAX's with JAX's streams injected."""

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperopt_tpu.algos.tpe import _continuous_best_core as j_best_core
from hyperopt_tpu.algos.tpe_device import _ei_diag as j_ei_diag
from hyperopt_tpu.ops import gmm as jgmm
from hyperopt_tpu.ops.pallas_fused import draw_param_rows as j_draw_param_rows
from hyperopt_tpu.ops.pallas_fused import ei_from_partials as j_ei_from_partials
from hyperopt_tpu.ops.pallas_fused import fused_suggest_pallas
from hyperopt_tpu.ops.pallas_gmm import pair_score_pallas
from hyperopt_tpu.ops.score import pair_params as j_pair_params
import hyperopt_tpu_torch as T
from hyperopt_tpu_torch import diagnostics
from hyperopt_tpu_torch.algos import tpe as ttpe
from hyperopt_tpu_torch.algos import tpe_device as ttd
from hyperopt_tpu_torch.ops import fused_kernel as fk
from hyperopt_tpu_torch.ops import score
from hyperopt_tpu_torch.ops.gmm import draw_param_rows
from hyperopt_tpu_torch.ops.pair_kernel import pair_score_single
from hyperopt_tpu_torch.ops.score import pair_params, pair_score

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import fused_report  # noqa: E402  (scripts/fused_report.py: the shape grid)

EPS32 = np.finfo(np.float32).eps
SCORER_ENV = ("HYPEROPT_TPU_SCORER", "HYPEROPT_TPU_FUSED", "HYPEROPT_TPU_FUSED_DRAW")


def ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.fixture(autouse=True)
def default_tier(monkeypatch):
    for k in SCORER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(fk, "_fused_measured_default", None)


def grid_case(name, kb_real, ka_real, k, n_cand, log_scale, lo, hi, seed=0, L=2):
    """One shape of the grid, made as scripts/fused_report.py makes it:
    numpy mixtures, JAX's candidates and JAX's uniform streams."""
    rng = np.random.default_rng(seed)
    C = k * n_cand
    keys = jax.random.split(jax.random.PRNGKey(seed), L)
    mixes, cands, u1, u2 = [], [], [], []
    for li in range(L):
        below = fused_report._mk_mixture(rng, kb_real, pad=3)
        above = fused_report._mk_mixture(rng, ka_real, pad=5)
        mixes.append((below, above))
        cands.append(np.asarray(jgmm.gmm_sample(keys[li], *below, np.float32(lo),
                                                np.float32(hi), np.float32(0.0), C,
                                                log_scale)))
        k_comp, k_val = jax.random.split(keys[li])
        u1.append(np.asarray(jax.random.uniform(k_comp, (C,), jnp.float32)))
        u2.append(np.asarray(jax.random.uniform(k_val, (C,), jnp.float32)))
    below = [np.stack([np.asarray(m[0][i]) for m in mixes]) for i in range(3)]
    above = [np.stack([np.asarray(m[1][i]) for m in mixes]) for i in range(3)]
    return dict(below=below, above=above, cands=np.stack(cands), u1=np.stack(u1),
                u2=np.stack(u2), lo=np.float32(lo), hi=np.float32(hi), k=k, n_cand=n_cand,
                log_scale=log_scale, kb=below[0].shape[1], L=L)


def t(a):
    return torch.tensor(np.asarray(a))


def port_rows(case):
    L = case["L"]
    return draw_param_rows(*map(t, case["below"]), torch.full((L,), case["lo"]),
                           torch.full((L,), case["hi"])).contiguous()


def run_both(case, draw):
    """(JAX interpret-mode outputs, port outputs) as numpy, same inputs."""
    L, kb, k, ls = case["L"], case["kb"], case["k"], case["log_scale"]
    jP = jnp.stack([j_pair_params(*[jnp.asarray(x[l]) for x in case["below"]],
                                  *[jnp.asarray(x[l]) for x in case["above"]])
                    for l in range(L)])
    tP = pair_params(*map(t, case["below"]), *map(t, case["above"])).contiguous()
    if draw:
        jrows = jax.jit(jax.vmap(j_draw_param_rows))(
            *[jnp.asarray(x) for x in case["below"]], jnp.full((L,), case["lo"]),
            jnp.full((L,), case["hi"]))
        j_args = (jnp.asarray(case["u1"]), jnp.asarray(case["u2"]), jrows)
        t_args = (t(case["u1"]), t(case["u2"]), port_rows(case))
    else:
        c = jnp.asarray(case["cands"])
        j_args = (c, jnp.zeros_like(c), jnp.zeros((L, 7, kb), jnp.float32))
        t_args = (t(case["cands"]), None, None)
    j_out = fused_suggest_pallas(*j_args, jP, k_below=kb, k=k, log_scale=ls,
                                 draw_in_kernel=draw, interpret=True)
    t_out = fk.fused_suggest(*t_args, tP, kb, k, log_scale=ls, draw_in_kernel=draw)
    return [np.asarray(a) for a in j_out], [a.numpy() for a in t_out], tP


@pytest.mark.parametrize("draw", [False, True], ids=["candidates_in", "draw_in_kernel"])
@pytest.mark.parametrize("shape", fused_report.SHAPE_GRID, ids=[c[0] for c in fused_report.SHAPE_GRID])
def test_fused_plain_matches_pallas_interpret(shape, draw):
    """The fused kernel's plain version against the Pallas kernel in
    interpret mode: winners and their indices equal except at a near-tie
    (the reference's own tolerance, ``pallas_fused.py:49-61``: two
    candidates whose scores differ by float association); with the draw
    in the kernel, winner values within its 2 ulp; the EI triple within
    rtol 1e-4, atol 1e-5 (``tests/test_fused_kernel.py:191``)."""
    case = grid_case(*shape)
    (jw, jidx, *jpart), (tw, tidx, *tpart), tP = run_both(case, draw)
    L, k, n = case["L"], case["k"], case["n_cand"]
    if not np.array_equal(jidx, tidx):
        # a near-tie: the port's own scores of the two winners agree
        z = t(case["cands"])
        z = torch.log(z) if case["log_scale"] else z
        s = pair_score(z, tP, case["kb"]).numpy().reshape(L, k, n)
        for l, j in zip(*np.nonzero(jidx != tidx)):
            assert abs(s[l, j, jidx[l, j]] - s[l, j, tidx[l, j]]) < 1e-4
    else:
        assert np.all(ulps(jw, tw) <= (2 if draw else 0))
    C, n_top = k * n, min(16, k * n)
    for a, b in zip(j_ei_from_partials(*jpart, C, n_top), fk.ei_from_partials(
            *map(t, tpart), C, n_top)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tpart[2], jpart[2], rtol=1e-4, atol=1e-5)  # seg_top


@pytest.mark.parametrize("shape", fused_report.SHAPE_GRID[:6], ids=[c[0] for c in fused_report.SHAPE_GRID[:6]])
def test_draw_param_rows_match_jax(shape):
    """The port's draw table against JAX's as the reference runs it (jitted,
    vmapped over labels): mu, sigma, the erf bounds and the nextafter
    clamps within 1 ulp; the cdf row, a running sum, within 2 ulp of its
    total: each component's mass differs by up to 1 ulp (torch's and JAX's
    ndtr), and the two cumsums add in different orders."""
    case = grid_case(*shape, L=4)
    L = case["L"]
    ref = np.asarray(jax.jit(jax.vmap(j_draw_param_rows))(
        *[jnp.asarray(x) for x in case["below"]], jnp.full((L,), case["lo"]),
        jnp.full((L,), case["hi"])))
    got = port_rows(case).numpy()
    assert got.shape == ref.shape == (L, 7, case["kb"])
    assert ulps(got[:, 1:], ref[:, 1:]).max() <= 1
    total = ref[:, 0, -1:]
    assert np.all(np.abs(got[:, 0] - ref[:, 0]) <= 2 * np.spacing(total))


def test_draw_from_rows_is_gmm_sample():
    """The in-kernel draw's plain op chain is ``gmm_sample`` itself: bit for
    bit on the same uniforms."""
    from hyperopt_tpu_torch.ops import gmm

    case = grid_case(*fused_report.SHAPE_GRID[4])  # log-scale, bounded
    rows = port_rows(case)
    L = case["L"]
    ref = gmm.gmm_sample(t(case["u1"]), t(case["u2"]), *map(t, case["below"]),
                         torch.full((L,), case["lo"]), torch.full((L,), case["hi"]),
                         torch.zeros(L), True)
    got = gmm.draw_from_rows(t(case["u1"]), t(case["u2"]), rows, True)
    assert torch.equal(got, ref)


def test_ei_from_partials_matches_dense_and_jax():
    """Per-segment partials combined = the dense ``_ei_diag`` reductions;
    and the port's combine = JAX's on the same partials."""
    rng = np.random.default_rng(0)
    L, k, n_cand, n_top = 3, 4, 37, 16
    scores = rng.normal(0, 3, (L, k, n_cand)).astype(np.float32)
    m = scores.max(axis=2)
    s = np.exp(scores - m[:, :, None]).sum(axis=2).astype(np.float32)
    top = -np.sort(-scores, axis=2)[:, :, :n_top]
    got = [a.numpy() for a in fk.ei_from_partials(t(m), t(s), t(top), k * n_cand, n_top)]
    dense = [a.numpy() for a in ttd._ei_diag(t(scores.reshape(L, k * n_cand)))]
    jgot = [np.asarray(a) for a in j_ei_from_partials(jnp.asarray(m), jnp.asarray(s),
                                                      jnp.asarray(top), k * n_cand, n_top)]
    jdense = [np.asarray(a) for a in j_ei_diag(jnp.asarray(scores.reshape(L, k * n_cand)))]
    for g, d, jg, jd in zip(got, dense, jgot, jdense):
        np.testing.assert_allclose(g, d, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)


def test_fused_ties_keep_the_first_index():
    """Equal scores resolve to the first candidate (torch.argmax and
    jnp.argmax alike), within a segment and with k segments."""
    rng = np.random.default_rng(3)
    K = 8
    w = np.full(K, 1.0 / K, np.float32)
    mu = rng.normal(0, 1, K).astype(np.float32)
    s = np.ones(K, np.float32)
    P = pair_params(t(w)[None], t(mu)[None], t(s)[None], t(w)[None], t(mu + 0.5)[None],
                    t(s)[None]).contiguous()
    same = torch.full((1, 24 * 3), 0.25)
    win, idx, *_ = fk.fused_suggest(same, None, None, P, K, 3)
    assert idx.tolist() == [[0, 0, 0]] and win.tolist() == [[0.25] * 3]
    jidx = np.asarray(fused_suggest_pallas(
        jnp.asarray(same.numpy()), jnp.zeros((1, 72), jnp.float32),
        jnp.zeros((1, 7, K), jnp.float32), jnp.asarray(P.numpy()), k_below=K, k=3, tc=8,
        interpret=True)[1])
    assert jidx.tolist() == idx.tolist()


@pytest.mark.parametrize("bad", ["k_not_dividing", "n_top", "rows_shape", "dtype", "split"])
def test_fused_suggest_refuses_bad_input(bad):
    x = torch.zeros(2, 12)
    P = torch.zeros(2, 3, 6)
    kw = dict(k_below=2, k=3)
    u2, rows, draw = None, None, False
    if bad == "k_not_dividing":
        kw["k"] = 5
    elif bad == "n_top":
        kw["n_top"] = 0
    elif bad == "rows_shape":
        u2, rows, draw = torch.zeros(2, 12), torch.zeros(2, 7, 3), True
    elif bad == "dtype":
        x = x.double()
    elif bad == "split":
        kw["k_below"] = 6
    with pytest.raises((ValueError, TypeError)):
        fk.fused_suggest(x, u2, rows, P, draw_in_kernel=draw, **kw)


def test_cpu_tensors_never_count_a_launch():
    case = grid_case(*fused_report.SHAPE_GRID[1])
    P = pair_params(*map(t, case["below"]), *map(t, case["above"])).contiguous()
    before = (fk.fused_suggest.launches, pair_score_single.launches)
    fk.fused_suggest(t(case["cands"]), None, None, P, case["kb"], case["k"])
    pair_score_single(t(case["cands"][0]), P[0], case["kb"])
    assert (fk.fused_suggest.launches, pair_score_single.launches) == before


# -- tiers --------------------------------------------------------------

def test_resolve_scorer_env_and_measured_default(monkeypatch):
    assert score.resolve_scorer() == "pallas"
    fk.set_default_fused(True)
    assert score.resolve_scorer() == "fused"
    monkeypatch.setenv("HYPEROPT_TPU_FUSED", "0")
    assert score.resolve_scorer() == "pallas"  # env beats the measured default
    monkeypatch.setenv("HYPEROPT_TPU_FUSED", "1")
    fk.set_default_fused(False)
    assert score.resolve_scorer() == "fused"
    fk.set_default_fused(None)
    for forced in score.SCORERS:
        monkeypatch.setenv("HYPEROPT_TPU_SCORER", forced)
        assert score.resolve_scorer() == forced  # a pin is honoured verbatim
    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "mxu")
    with pytest.raises(ValueError, match="HYPEROPT_TPU_SCORER"):
        score.resolve_scorer()


def test_resolve_fused_draw(monkeypatch):
    assert fk.resolve_fused_draw() is False
    monkeypatch.setenv("HYPEROPT_TPU_FUSED_DRAW", "1")
    assert fk.resolve_fused_draw() is True
    monkeypatch.setenv("HYPEROPT_TPU_FUSED_DRAW", "off")
    assert fk.resolve_fused_draw() is False


# -- the slice through tpe.suggest ---------------------------------------

SPACE = {"u": T.hp.uniform("u", -2.0, 2.0), "lu": T.hp.loguniform("lu", -4.0, 2.0),
         "n": T.hp.normal("n", 0.0, 1.0), "q": T.hp.quniform("q", 0, 10, 1),
         "c": T.hp.choice("c", [0, 1, 2])}


@pytest.fixture(scope="module")
def history():
    trials = T.Trials()
    T.fmin(lambda c: float(c["u"] ** 2 + c["n"] ** 2 + 0.1 * c["c"] + c["q"] / 100),
           SPACE, algo=partial(T.tpe.suggest, n_EI_candidates=24, device="cpu"),
           max_evals=30, trials=trials, rstate=np.random.default_rng(1),
           show_progressbar=False)
    return T.Domain(lambda c: 0.0, SPACE), trials


def suggest_on(monkeypatch, history, env, seed=5):
    domain, trials = history
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    docs = T.tpe.suggest([900], domain, trials, seed, n_EI_candidates=40, device="cpu")
    snap = diagnostics.last_suggest_diag()
    for k in env:
        monkeypatch.delenv(k)
    return docs[0]["misc"]["vals"], snap


@pytest.mark.parametrize("env", [
    {"HYPEROPT_TPU_SCORER": "fused"},
    {"HYPEROPT_TPU_SCORER": "fused", "HYPEROPT_TPU_FUSED_DRAW": "1"},
    {"HYPEROPT_TPU_FUSED": "1"},
    {"HYPEROPT_TPU_SCORER": "xla"},
], ids=["fused", "fused_draw", "fused_promoted", "xla"])
def test_suggest_docs_equal_default_tier(monkeypatch, history, env):
    """The fused tier's (and the plain tier's) trial docs equal the default
    tier's for one history and seed, and the search-health row keeps its
    labels, counts and EI columns (rtol 1e-4, atol 1e-5), mirroring
    ``tests/test_fused_kernel.py:144-225``."""
    ref_vals, ref_snap = suggest_on(monkeypatch, history, {})
    vals, snap = suggest_on(monkeypatch, history, env)
    assert vals == ref_vals
    assert snap["labels"].keys() == ref_snap["labels"].keys() == set(SPACE)
    for lb, r in ref_snap["labels"].items():
        g = snap["labels"][lb]
        assert (g["kind"], g["nb"], g["na"]) == (r["kind"], r["nb"], r["na"])
        for col in ("ei_max", "ei_flatness", "ei_top_mass"):
            np.testing.assert_allclose(g[col], r[col], rtol=1e-4, atol=1e-5)


def test_fused_draw_static_only_on_fused_programs(monkeypatch, history):
    """Only fused continuous programs carry ``fused_draw``; every request
    carries the tier resolved once for the suggest."""
    captured = []
    real = ttd.multi_family_suggest_async

    def capture(requests):
        captured.append(requests)
        return real(requests)

    monkeypatch.setattr(ttd, "multi_family_suggest_async", capture)
    suggest_on(monkeypatch, history, {})
    suggest_on(monkeypatch, history, {"HYPEROPT_TPU_SCORER": "fused"})
    default, fused = ([st for kind, _, st in reqs if kind == "cont"] for reqs in captured)
    assert all("fused_draw" not in st and st["scorer"] == "pallas" for st in default)
    assert all(st["fused_draw"] is False and st["scorer"] == "fused" for st in fused)
    assert all("scorer" not in st for kind, _, st in captured[0] if kind == "idx")


def test_exact_tier_scores_by_normalized_lpdf(monkeypatch, history):
    """``HYPEROPT_TPU_SCORER=exact``: unquantized labels score by the
    normalized lpdf difference, which differs from the pair score by a
    per-label constant, so the winners equal the default tier's."""
    ref_vals, _ = suggest_on(monkeypatch, history, {})
    vals, _ = suggest_on(monkeypatch, history, {"HYPEROPT_TPU_SCORER": "exact"})
    for lb in ref_vals:
        np.testing.assert_allclose(vals[lb], ref_vals[lb], rtol=1e-5)


# -- the single-label core ------------------------------------------------

def entry_args(PB=16, nb=10, PA=64, na=40, n=256, seed=0, log_scale=False, q=0.0):
    """__graft_entry__.entry's arguments, with the key's two uniform streams
    drawn by JAX as its gmm_sample draws them."""
    below = np.zeros(PB, np.float32)
    below[:nb] = np.linspace(-1.0, 1.0, nb)
    above = np.zeros(PA, np.float32)
    above[:na] = np.linspace(-4.0, 4.0, na)
    lo, hi = (np.float32(-3.0), np.float32(1.5)) if log_scale else (np.float32(-5.0),
                                                                     np.float32(5.0))
    key = jax.random.PRNGKey(seed)
    k_comp, k_val = jax.random.split(key)
    u1 = np.asarray(jax.random.uniform(k_comp, (n,), jnp.float32))
    u2 = np.asarray(jax.random.uniform(k_val, (n,), jnp.float32))
    rest = (np.float32(1.0), np.float32(0.0), np.float32(10.0), lo, hi, np.float32(q))
    return key, u1, u2, below, nb, above, na, rest


@pytest.mark.parametrize("variant", [
    dict(seed=0), dict(seed=1), dict(seed=2, n=64), dict(seed=3, log_scale=True),
    dict(seed=4, q=0.5), dict(seed=5, PB=32, nb=25, PA=512, na=400, n=1024),
], ids=["entry0", "entry1", "entry_n64", "log_scale", "quantized", "wide"])
def test_continuous_best_core_matches_jax(variant):
    """The port's single-label core, fed JAX's streams, returns JAX's
    winners (rtol 1e-5: the draws agree to 2 ulp)."""
    log_scale = variant.get("log_scale", False)
    quantized = variant.get("q", 0.0) > 0
    key, u1, u2, below, nb, above, na, rest = entry_args(**variant)
    n = len(u1)
    kw = dict(k=1, n_cand=n, lf=25, log_scale=log_scale, quantized=quantized)
    ref = np.asarray(j_best_core(key, below, np.int32(nb), above, np.int32(na), *rest, **kw))
    got = ttpe._continuous_best_core(t(u1), t(u2), t(below), nb, t(above), na,
                                     *map(float, rest), **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_continuous_best_core_k_segments_and_tiers(monkeypatch):
    """k > 1 winners, one per segment; the plain (``xla``) tier gives the
    same winners as the default single-label scorer on the CPU."""
    key, u1, u2, below, nb, above, na, rest = entry_args(n=4 * 64, seed=7)
    args = (t(u1), t(u2), t(below), nb, t(above), na, *map(float, rest))
    kw = dict(k=4, n_cand=64, lf=25, log_scale=False, quantized=False)
    got = ttpe._continuous_best_core(*args, **kw)
    ref = np.asarray(j_best_core(key, below, np.int32(nb), above, np.int32(na), *rest, **kw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    monkeypatch.setenv("HYPEROPT_TPU_SCORER", "xla")
    assert torch.equal(ttpe._continuous_best_core(*args, **kw), got)


@pytest.mark.parametrize("padded_tail", [0, 5])
def test_pair_score_single_matches_pallas_interpret(padded_tail):
    """The single-label wrapper (its plain version here) against the JAX
    package's single-label Pallas kernel in interpret mode."""
    rng = np.random.default_rng(padded_tail)

    def mk(K):
        w = rng.uniform(0.1, 1.0, K).astype(np.float32)
        if padded_tail:
            w[-padded_tail:] = 0.0
        w /= w.sum()
        return w, rng.normal(0, 2, K).astype(np.float32), rng.uniform(0.5, 2, K).astype(
            np.float32)

    B, A = mk(20), mk(70)
    P = np.asarray(j_pair_params(*B, *A))
    z = rng.normal(0, 2, 300).astype(np.float32)
    ref = np.asarray(pair_score_pallas(z, P, 20, tc=64, tk=128, interpret=True))
    got = pair_score_single(t(z), t(P), 20).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        pair_score_single(t(z)[None], t(P), 20)
