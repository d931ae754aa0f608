"""The slice as a whole: the port's device history and ``tpe.suggest``
against the JAX package's on one history, and serial ``fmin`` end to end.
Everything runs on the CPU (``device="cpu"``); JAX stays on the CPU too,
where its suggest scores with the plain ``pair_score``."""

import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu.algos import tpe_device as jtd
from hyperopt_tpu.algos.tpe import _host_label_keys
from hyperopt_tpu_torch.algos import tpe as ttpe
from hyperopt_tpu_torch.algos import tpe_device as ttd
from hyperopt_tpu_torch.ops import gmm as tgmm
from hyperopt_tpu_torch.ops import parzen as tparzen
from hyperopt_tpu_torch.ops.score import pair_params, pair_score

N_HISTORY = 300
N_CAND = 64
SEEDS = range(20)
UNQUANTIZED = ("lr", "momentum", "sigma", "z")


def bench_space(hp):
    """The 5-label mixed space of bench.py's build_history_trials."""
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1.0)),
        "momentum": hp.uniform("momentum", 0.0, 1.0),
        "width": hp.quniform("width", 32, 1024, 32),
        "sigma": hp.lognormal("sigma", 0.0, 1.0),
        "z": hp.normal("z", 0.0, 3.0),
    }


def quickstart(hp):
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1e-1)),
        "layers": hp.uniformint("layers", 1, 8),
        "arch": hp.choice("arch", [
            {"kind": "mlp", "width": hp.quniform("width", 64, 1024, 64)},
            {"kind": "cnn", "kernel": hp.choice("kernel", [3, 5, 7])},
        ]),
    }


def done_doc(tid, config, loss):
    return {
        "tid": tid, "spec": None,
        "result": {"status": "ok", "loss": loss},
        "misc": {"tid": tid, "cmd": None,
                 "idxs": {k: [tid] for k in config},
                 "vals": {k: [v] for k, v in config.items()}},
        "state": 2, "owner": None, "book_time": None, "refresh_time": None,
        "exp_key": None,
    }


def history(pkg, n=N_HISTORY, seed=0):
    """``n`` completed trials over the bench space; values drawn by the
    JAX sampler so both packages hold the same trial docs."""
    jdom = J.Domain(lambda c: 0.0, bench_space(J.hp))
    vals, _ = jdom.space.sample_batch(seed, n)
    losses = np.random.default_rng(seed).standard_normal(n)
    trials = pkg.Trials()
    trials._insert_trial_docs([
        done_doc(i, {k: float(vals[k][i]) for k in vals}, float(losses[i]))
        for i in range(n)
    ])
    trials.refresh()
    return pkg.Domain(lambda c: 0.0, bench_space(pkg.hp)), trials


def jax_streams(seed, n_labels, n, device):
    """JAX's per-label uniforms for ``gmm_sample``: the label key of
    ``_host_label_keys``, split into (k_comp, k_val), ``uniform`` on each."""
    out = []
    for key in _host_label_keys(int(seed), n_labels):
        k_comp, k_val = jax.random.split(jnp.asarray(key))
        out.append(np.stack([
            np.asarray(jax.random.uniform(k_comp, (n,), jnp.float32)),
            np.asarray(jax.random.uniform(k_val, (n,), jnp.float32)),
        ]))
    return torch.tensor(np.stack(out), device=device)


def winners(docs):
    return {lb: v[0] for lb, v in docs[0]["misc"]["vals"].items()}


def port_label_scores(domain, trials, label, values):
    """The port's scores ``log l − log g`` of raw ``values`` for one label
    at the history's state: the plain pair score for unquantized labels,
    the exact quantized lpdf difference otherwise."""
    dh = ttd.device_history_for(trials, domain.space, "cpu")
    fam = next(f for f in dh.families.values() if label in f.labels)
    i = fam.labels.index(label)
    n = len(trials.history.losses)
    n_below = min(int(np.ceil(0.25 * np.sqrt(n))), 25)
    ranks = ttd._loss_ranks(dh.losses, dh.keep_mask(None))
    inf = torch.full((fam.L,), float("inf"))
    below, nb, above, na = ttd._split_pack(
        fam.obs, fam.pos, fam.counts, ranks, dh.keep_mask(None), n_below,
        torch.zeros(fam.L), inf, tparzen.bucket(n_below), lock_fallback=False)
    pri = torch.tensor(fam.default_priors)
    B = tparzen.adaptive_parzen_normal_padded(below, nb, 1.0, pri[:, 0], pri[:, 1], 25)
    A = tparzen.adaptive_parzen_normal_padded(above, na, 1.0, pri[:, 0], pri[:, 1], 25)
    x = torch.tensor([values], dtype=torch.float32).repeat(fam.L, 1)
    if fam.quantized:
        lo, hi, q = pri[:, 2], pri[:, 3], pri[:, 4]
        s = (tgmm.gmm_lpdf(x, *B, lo, hi, q, fam.log_scale, True)
             - tgmm.gmm_lpdf(x, *A, lo, hi, q, fam.log_scale, True))
    else:
        z = torch.log(x) if fam.log_scale else x
        s = pair_score(z, pair_params(*B, *A), B[0].shape[1])
    return s[i].numpy()


@pytest.fixture(scope="module")
def suggests():
    """JAX and port winners per seed, the port fed JAX's streams."""
    jdom, jtrials = history(J)
    tdom, ttrials = history(T)
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(ttpe, "_label_uniforms", jax_streams)
    try:
        for seed in SEEDS:
            jw = winners(J.tpe.suggest([N_HISTORY], jdom, jtrials, seed,
                                       n_EI_candidates=N_CAND))
            tw = winners(T.tpe.suggest([N_HISTORY], tdom, ttrials, seed,
                                       n_EI_candidates=N_CAND, device="cpu"))
            out[seed] = (jw, tw)
    finally:
        mp.undo()
    return tdom, ttrials, out


@pytest.mark.parametrize("labels", [UNQUANTIZED, ("width",)], ids=["unquantized", "width"])
def test_suggest_winners_match_jax(suggests, labels):
    """With JAX's streams injected, the port's winners equal JAX's to
    rtol=1e-5 on >= 95% of (seed, label) pairs; every mismatch is a
    near-tie: the port's own scorer puts the two winners within 1e-4."""
    tdom, ttrials, out = suggests
    mismatches = []
    for seed, (jw, tw) in out.items():
        for lb in labels:
            if not np.isclose(tw[lb], jw[lb], rtol=1e-5, atol=0):
                mismatches.append((lb, jw[lb], tw[lb]))
    n_pairs = len(out) * len(labels)
    assert len(mismatches) <= 0.05 * n_pairs, mismatches
    for lb, jv, tv in mismatches:
        sj, st = port_label_scores(tdom, ttrials, lb, [jv, tv])
        assert abs(sj - st) < 1e-4, (lb, jv, tv, sj, st)


def test_suggest_docs_are_well_formed(suggests):
    _, _, out = suggests
    for jw, tw in out.values():
        assert set(tw) == set(jw)
        assert float(tw["width"]) % 32 == 0 and 32 <= tw["width"] <= 1024
        assert 1e-5 <= tw["lr"] <= 1.0 and 0.0 <= tw["momentum"] <= 1.0
        assert tw["sigma"] > 0


def test_suggest_without_injection_is_deterministic():
    tdom, ttrials = history(T)
    algo = partial(T.tpe.suggest, n_EI_candidates=N_CAND, device="cpu")
    a = winners(algo([N_HISTORY], tdom, ttrials, 5))
    b = winners(algo([N_HISTORY], tdom, ttrials, 5))
    c = winners(algo([N_HISTORY], tdom, ttrials, 6))
    assert a == b and a != c


def test_device_history_matches_jax_and_load_numpy():
    """The port's synced buffers equal JAX's; ``load_numpy`` of JAX's
    state scores the same winners as the port's own sync."""
    jdom, jtrials = history(J, n=150)
    tdom, ttrials = history(T, n=150)
    jdh = jtd.DeviceHistory(jdom.space.specs)
    jdh.sync(jtrials.history)
    tdh = ttd.DeviceHistory(tdom.space.specs, device="cpu")
    tdh.sync(ttrials.history)
    assert list(tdh.families) == list(jdh.families)
    state = {}
    for key, jf in jdh.families.items():
        tf = tdh.families[key]
        obs, pos, counts = (np.asarray(a) for a in (jf.obs, jf.pos, jf.counts))
        np.testing.assert_array_equal(tf.obs.numpy(), obs)
        np.testing.assert_array_equal(tf.pos.numpy(), pos)
        np.testing.assert_array_equal(tf.counts.numpy(), counts)
        state[key] = (obs, pos, counts)
    np.testing.assert_array_equal(tdh.losses.numpy(), np.asarray(jdh.losses))
    loaded = ttd.DeviceHistory(tdom.space.specs, device="cpu")
    loaded.load_numpy(state, np.asarray(jdh.losses))
    u = torch.rand((2, 2, 256), generator=torch.Generator().manual_seed(0))
    key = ("cont", False, False)
    for dh in (tdh, loaded):
        fam = dh.families[key]
        win, diag = ttd._family_suggest_core(
            u, fam.obs, fam.pos, fam.counts, dh.losses, dh.keep_mask(None), 4, 1.0,
            torch.tensor(fam.default_priors), torch.zeros(2), torch.full((2,), np.inf),
            cap_b=8, k=1, n_cand=256, lf=25, log_scale=False, quantized=False)
        if dh is tdh:
            ref = win
        else:
            np.testing.assert_array_equal(win.numpy(), ref.numpy())
    assert diag.shape == (2, ttd.DIAG_COLS)


def test_device_history_append_equals_rebuild():
    tdom, ttrials = history(T, n=70)
    grown = history(T, n=110)[1]
    dh = ttd.DeviceHistory(tdom.space.specs, device="cpu")
    ttrials._insert_trial_docs(grown.trials[70:110])
    hist0 = ttrials.history
    dh.sync(hist0)
    ttrials.refresh()
    dh.sync(ttrials.history)  # append path: 40 new rows, same buckets
    assert dh.full_rebuilds == 1
    ref = ttd.DeviceHistory(tdom.space.specs, device="cpu")
    ref.sync(grown.history)
    np.testing.assert_array_equal(dh.losses.numpy(), ref.losses.numpy())
    for key, fam in dh.families.items():
        n = fam.counts.numpy()
        for l in range(fam.L):
            np.testing.assert_array_equal(fam.obs[l, :n[l]].numpy(),
                                          ref.families[key].obs[l, :n[l]].numpy())
            np.testing.assert_array_equal(fam.pos[l, :n[l]].numpy(),
                                          ref.families[key].pos[l, :n[l]].numpy())


def test_scatter_drops_out_of_range_indices():
    buf = torch.zeros(4)
    ttd._scatter_drop(buf, (np.array([0, 4, -1, 3]),), np.array([1.0, 2.0, 3.0, 4.0]))
    np.testing.assert_array_equal(buf.numpy(), [1.0, 0.0, 0.0, 4.0])
    buf2 = torch.zeros(2, 3)
    ttd._scatter_drop(buf2, (np.array([0, 2, 1]), np.array([1, 0, 3])), np.array([5.0, 6.0, 7.0]))
    np.testing.assert_array_equal(buf2.numpy(), [[0, 5, 0], [0, 0, 0]])


def test_index_family_posterior_chi2():
    """Index labels of a hp.choice space: the port's posterior equals
    JAX's, and ``categorical_sample`` follows it (chi-square)."""
    space = {"c": None}
    jdom = J.Domain(lambda c: 0.0, {"c": J.hp.choice("c", ["a", "b", "c", "d"])})
    vals, _ = jdom.space.sample_batch(1, 200)
    losses = np.random.default_rng(1).standard_normal(200)
    del space
    trials = T.Trials()
    trials._insert_trial_docs([done_doc(i, {"c": int(vals["c"][i])}, float(losses[i]))
                               for i in range(200)])
    trials.refresh()
    tdom = T.Domain(lambda c: 0.0, {"c": T.hp.choice("c", ["a", "b", "c", "d"])})
    dh = ttd.device_history_for(trials, tdom.space, "cpu")
    dh.sync(trials.history)
    fam = dh.families[("idx",)]
    n_below = int(np.ceil(0.25 * np.sqrt(200)))
    ranks = ttd._loss_ranks(dh.losses, dh.keep_mask(None))
    below, nb, _, _ = ttd._split_pack(
        fam.obs, fam.pos, fam.counts, ranks, dh.keep_mask(None), n_below,
        torch.zeros(1), torch.full((1,), float("inf")), 8, lock_fallback=True)
    pp = torch.tensor(fam.prior_p)
    pb = tgmm.categorical_posterior(below, nb, pp, 1.0, fam.upper, 25)
    ref = np.asarray(J.algos.tpe_device.gmm_ops.categorical_posterior(
        below[0].numpy(), int(nb[0]), fam.prior_p[0], np.float32(1.0), fam.upper, 25))
    np.testing.assert_allclose(pb[0].numpy(), ref, rtol=1e-6)
    u = torch.rand((1, 40000), generator=torch.Generator().manual_seed(3))
    draws = tgmm.categorical_sample(u, pb)[0].numpy()
    counts = np.bincount(draws, minlength=fam.upper)
    assert stats.chisquare(counts, pb[0].numpy() * len(draws)).pvalue > 1e-3


def test_serial_fmin_quickstart_space():
    trials = T.Trials()
    best = T.fmin(
        lambda c: (np.log(c["lr"]) + 7.0) ** 2 + c["layers"]
        + c["arch"].get("width", 0) / 1024.0,
        quickstart(T.hp),
        algo=partial(T.tpe.suggest, device="cpu", n_startup_jobs=10),
        max_evals=40, trials=trials, rstate=np.random.default_rng(0),
        show_progressbar=False,
    )
    assert len(trials.trials) == 40
    for doc in trials.trials:
        v = {k: x[0] for k, x in doc["misc"]["vals"].items() if x}
        assert 1e-5 <= v["lr"] <= 1e-1
        assert 1 <= v["layers"] <= 8 and int(v["layers"]) == v["layers"]
        assert v["arch"] in (0, 1)
        if v["arch"] == 0:
            assert "kernel" not in v and v["width"] % 64 == 0
            assert 64 <= v["width"] <= 1024
        else:
            assert "width" not in v and v["kernel"] in (0, 1, 2)
    assert set(best) <= {"lr", "layers", "arch", "width", "kernel"}
    assert isinstance(T.space_eval(quickstart(T.hp), best), dict)


def test_fmin_resumes_from_pickle(tmp_path):
    path = str(tmp_path / "trials.pkl")
    algo = partial(T.rand.suggest, device="cpu")
    space = {"x": T.hp.uniform("x", -1, 1)}
    T.fmin(lambda c: c["x"] ** 2, space, algo=algo, max_evals=5,
           trials_save_file=path, rstate=np.random.default_rng(0),
           show_progressbar=False)
    with open(path, "rb") as f:
        assert len(pickle.load(f).trials) == 5
    T.fmin(lambda c: c["x"] ** 2, space, algo=algo, max_evals=8,
           trials_save_file=path, rstate=np.random.default_rng(1),
           show_progressbar=False)
    with open(path, "rb") as f:
        assert len(pickle.load(f).trials) == 8


@pytest.mark.parametrize("kwargs", [
    # speculation is ported; with a keyword that is not, fmin still raises
    {"max_speculation": 2, "retry_policy": object()}, {"validate_space": True},
    {"retry_policy": object()},
    {"fault_stats": object()}, {"trials_save_file": "run.orbax"},
])
def test_unported_keywords_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.fmin(lambda c: 0.0, {"x": T.hp.uniform("x", 0, 1)},
               algo=partial(T.rand.suggest, device="cpu"), max_evals=1,
               show_progressbar=False, **kwargs)


def test_numpy_facing_wrappers_match_jax():
    rng = np.random.default_rng(8)
    mus = rng.normal(0, 1, 13)
    for a, b in zip(T.tpe.adaptive_parzen_normal(mus, 1.0, 0.2, 2.0, device="cpu"),
                    J.tpe.adaptive_parzen_normal(mus, 1.0, 0.2, 2.0)):
        np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)
    w, m, s = J.tpe.adaptive_parzen_normal(mus, 1.0, 0.2, 2.0)
    x = np.linspace(-2, 2, 9)
    for fn in ("GMM1_lpdf", "LGMM1_lpdf"):
        xs = np.exp(x) if fn.startswith("L") else x
        got = getattr(T.tpe, fn)(xs, w, m, s, low=-1.5, high=1.5, device="cpu")
        ref = getattr(J.tpe, fn)(xs, w, m, s, low=-1.5, high=1.5)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    draws = T.tpe.GMM1(w, m, s, low=-1.0, high=1.0, q=0.5, rng=0, size=(500,),
                       device="cpu")
    assert draws.shape == (500,) and np.all(np.abs(draws) <= 1.0)
    np.testing.assert_allclose(np.round(draws / 0.5) * 0.5, draws)
    assert T.tpe.LGMM1(w, m, s, rng=np.random.default_rng(1), device="cpu") > 0
    losses = rng.standard_normal(50)
    assert T.tpe.ap_split_trials(np.arange(50), losses, 0.25) == \
        J.tpe.ap_split_trials(np.arange(50), losses, 0.25)
