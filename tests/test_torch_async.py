"""The port's asynchronous suggest plane on the CPU (``device="cpu"``):
``DeviceHistory.hypothetical_append`` against the JAX package's,
``tpe.suggest_async``/``suggest_prepare`` against the port's own blocking
``suggest``, and the batched multi-study dispatch.  JAX stays on the CPU."""

from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu.algos import tpe_device as jtd
from hyperopt_tpu_torch.algos import tpe_device as ttd
from hyperopt_tpu_torch.diagnostics import DIAG_COLS

N_CAND = 48


def bench_space(hp):
    """The 5-label mixed space of bench.py's build_history_trials."""
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1.0)),
        "momentum": hp.uniform("momentum", 0.0, 1.0),
        "width": hp.quniform("width", 32, 1024, 32),
        "sigma": hp.lognormal("sigma", 0.0, 1.0),
        "z": hp.normal("z", 0.0, 3.0),
    }


def quickstart_space(hp):
    """Conditional labels and index families (README quick start)."""
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1e-1)),
        "layers": hp.uniformint("layers", 1, 8),
        "arch": hp.choice("arch", [
            {"kind": "mlp", "width": hp.quniform("width", 64, 1024, 64)},
            {"kind": "cnn", "kernel": hp.choice("kernel", [3, 5, 7])},
        ]),
    }


SPACES = {"bench": bench_space, "quickstart": quickstart_space}


def sampled_vals(space, n, seed):
    """``n`` configurations drawn by the JAX sampler, as ``misc["vals"]``
    dicts holding only each trial's active labels."""
    vals, active = J.Domain(lambda c: 0.0, SPACES[space](J.hp)).space.sample_batch(seed, n)
    return [{k: ([float(vals[k][i])] if active[k][i] else []) for k in vals}
            for i in range(n)]


def done_doc(tid, vals, loss):
    return {
        "tid": tid, "spec": None,
        "result": {"status": "ok", "loss": loss},
        "misc": {"tid": tid, "cmd": None,
                 "idxs": {k: [tid] * len(v) for k, v in vals.items()},
                 "vals": {k: list(v) for k, v in vals.items()}},
        "state": 2, "owner": None, "book_time": None, "refresh_time": None,
        "exp_key": None,
    }


def history(pkg, space="bench", n=150, seed=0):
    """``(domain, trials)`` of ``pkg`` over one set of trial docs."""
    losses = np.random.default_rng(seed).standard_normal(n)
    trials = pkg.Trials()
    trials._insert_trial_docs([done_doc(i, v, float(losses[i]))
                               for i, v in enumerate(sampled_vals(space, n, seed))])
    trials.refresh()
    return pkg.Domain(lambda c: 0.0, SPACES[space](pkg.hp)), trials


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def live_state(dh):
    return [dh.losses.clone()] + [t.clone() for f in dh.families.values()
                                  for t in (f.obs, f.pos, f.counts)]


# -- hypothetical_append ------------------------------------------------------

@pytest.mark.parametrize("space,n,n_pending", [
    ("bench", 150, 1),      # inside the live buckets
    ("bench", 150, 3),
    ("bench", 256, 1),      # 257 rows: past the loss bucket, rebuilt on the host
    ("bench", 254, 3),
    ("quickstart", 100, 2),  # conditional labels: some families gain nothing
    ("quickstart", 128, 1),
], ids=["in_bucket", "in_bucket_3", "overflow", "overflow_3", "conditional",
        "conditional_overflow"])
def test_hypothetical_append_matches_jax(space, n, n_pending):
    """The view equals the JAX package's exactly, family by family, and the
    port's live buffers are bit-identical before and after."""
    jdom, jtrials = history(J, space, n)
    tdom, ttrials = history(T, space, n)
    pending = sampled_vals(space, n_pending, seed=99)
    jdh = jtd.DeviceHistory(jdom.space.specs)
    jdh.sync(jtrials.history)
    tdh = ttd.DeviceHistory(tdom.space.specs, device="cpu")
    tdh.sync(ttrials.history)
    before = live_state(tdh)

    jl, jviews, jkeep = jdh.hypothetical_append(jtrials.history, pending)
    tl, tviews, tkeep = tdh.hypothetical_append(ttrials.history, pending)

    np.testing.assert_array_equal(host(tl), host(jl))
    np.testing.assert_array_equal(host(tkeep), host(jkeep))
    assert set(tviews) == set(jviews) and tviews
    for key in jviews:
        for t, j in zip(tviews[key], jviews[key]):
            assert t.shape == tuple(np.shape(j))
            np.testing.assert_array_equal(host(t), host(j))
    after = live_state(tdh)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    # the grown row count is in the view and nowhere else
    assert int((tl < ttd._BIG).sum()) == n
    if n + n_pending > tdh.capt:
        assert tl.shape[0] == 2 * tdh.capt


# -- suggest_async / suggest_prepare --------------------------------------------

KW = dict(n_EI_candidates=N_CAND, device="cpu")


def winners(docs):
    return [d["misc"]["vals"] for d in docs]


@pytest.mark.parametrize("space,n,ids", [
    ("bench", 150, [150]), ("bench", 150, [150, 151]), ("quickstart", 60, [60]),
    ("bench", 10, [10]),  # random-search startup: the resolver is a constant
])
def test_suggest_async_matches_suggest(space, n, ids):
    dom, trials = history(T, space, n)
    eager = T.tpe.suggest(ids, dom, trials, 123, **KW)
    resolve = T.tpe.suggest_async(ids, dom, trials, 123, **KW)
    assert callable(resolve)
    assert winners(resolve()) == winners(eager)


@pytest.mark.parametrize("space,n", [("bench", 150), ("bench", 256), ("quickstart", 64)],
                         ids=["in_bucket", "overflow", "conditional_overflow"])
def test_pending_suggest_equals_serial_after_completion(space, n):
    """A suggest fit with one trial pending equals the serial suggest made
    after that trial completed with a loss that ranks above (worse than)
    every loss of the below set."""
    dom, trials = history(T, space, n)
    (pending,) = sampled_vals(space, 1, seed=7)
    spec = T.tpe.suggest_async([n + 1], dom, trials, 5, pending=[pending], **KW)()
    trials._insert_trial_docs([done_doc(n, pending, 1e6)])
    trials.refresh()
    assert winners(T.tpe.suggest([n + 1], dom, trials, 5, **KW)) == winners(spec)


def test_pending_refused_with_trial_filter():
    dom, trials = history(T)
    with pytest.raises(ValueError, match="trial_filter"):
        T.tpe.suggest_async([150], dom, trials, 1, pending=[sampled_vals("bench", 1, 3)[0]],
                            trial_filter=np.ones(150, bool), **KW)


def test_plugin_attributes():
    assert T.tpe.suggest.async_variant is T.tpe.suggest_async
    assert T.tpe.suggest.prepare_variant is T.tpe.suggest_prepare
    assert T.tpe.suggest.speculation_policy == J.tpe.suggest.speculation_policy
    assert T.rand.suggest.speculation_policy == J.rand.suggest.speculation_policy


def test_prepare_is_none_off_the_device_plane():
    dom, trials = history(T, n=10)
    assert T.tpe.suggest_prepare([10], dom, trials, 1, **KW) is None


# -- multi-study batching -------------------------------------------------------

STUDIES = [("bench", 150, [150], 77), ("quickstart", 60, [60, 61], 88),
           ("bench", 40, [40], 99)]


def test_multi_study_equals_unbatched():
    """One batched dispatch: each group's winners and diag rows equal its
    unbatched dispatch, and each finish gives the unbatched docs
    (mirrors tests/test_device_history.py:263 and
    tests/test_diagnostics.py:179)."""
    setups = [(history(T, sp, n, seed=n), ids, seed) for sp, n, ids, seed in STUDIES]
    refs = []
    for (dom, trials), ids, seed in setups:
        requests, _ = T.tpe.suggest_prepare(ids, dom, trials, seed, **KW)
        refs.append(ttd.multi_family_suggest(requests))
    preps = [T.tpe.suggest_prepare(ids, dom, trials, seed, **KW)
             for (dom, trials), ids, seed in setups]
    resolvers = ttd.multi_study_suggest_async([req for req, _ in preps])
    for resolve, (ref_wins, ref_diags), (_, finish), ((dom, trials), ids, seed) in zip(
            reversed(resolvers), reversed(refs), reversed(preps), reversed(setups)):
        wins = resolve()
        assert len(wins) == len(ref_wins) == len(resolve.diag)
        for w, r, d, rd in zip(wins, ref_wins, resolve.diag, ref_diags):
            np.testing.assert_array_equal(w, r)
            np.testing.assert_array_equal(d, rd)
            assert d.shape == (w.shape[0], DIAG_COLS)
        assert finish.accepts_diag
        docs = finish(wins, diag=resolve.diag)
        assert winners(docs) == winners(T.tpe.suggest(ids, dom, trials, seed, **KW))


def test_canonical_group_order_matches_jax():
    """The same statics and shapes give the JAX package's order, for the
    port's real request lists and for synthetic ones."""
    setups = [(history(T, sp, n, seed=n), ids, seed) for sp, n, ids, seed in STUDIES]
    groups = [T.tpe.suggest_prepare(ids, dom, trials, seed, **KW)[0]
              for (dom, trials), ids, seed in setups]
    groups = groups + groups[:1]
    as_numpy = [[(kind, tuple(np.zeros(tuple(np.shape(a)), np.float32) for a in args), st)
                 for kind, args, st in g] for g in groups]
    assert ttd.canonical_group_order(groups) == jtd.canonical_group_order(as_numpy)
    rng = np.random.default_rng(0)
    synthetic = [
        [(kind, (np.zeros((int(rng.integers(1, 4)), int(rng.integers(8, 40)))),
                 np.int32(3)), {"k": int(rng.integers(1, 3)), "cap_b": 8})
         for kind in rng.permutation(["cont", "idx"])[: int(rng.integers(1, 3))]]
        for _ in range(7)
    ]
    assert ttd.canonical_group_order(synthetic) == jtd.canonical_group_order(synthetic)


def test_multi_family_suggest_is_the_resolved_async():
    dom, trials = history(T)
    requests, _ = T.tpe.suggest_prepare([150], dom, trials, 4, **KW)
    wins, diags = ttd.multi_family_suggest(requests)
    resolve = ttd.multi_family_suggest_async(requests)
    got = resolve()
    for a, b, c, d in zip(wins, got, diags, resolve.diag):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)


def test_fmin_with_prepare_batched_algo_runs():
    """A suggest made from suggest_prepare + the batched dispatch drives
    fmin like tpe.suggest does (same trials, same rstate)."""
    def batched(new_ids, domain, trials, seed):
        prep = T.tpe.suggest_prepare(new_ids, domain, trials, seed, n_startup_jobs=5,
                                     **KW)
        if prep is None:
            return T.tpe.suggest(new_ids, domain, trials, seed, n_startup_jobs=5, **KW)
        (resolve,) = ttd.multi_study_suggest_async([prep[0]])
        return prep[1](resolve(), diag=resolve.diag)

    def run(algo):
        trials = T.Trials()
        T.fmin(lambda c: (c["x"] - 1.0) ** 2, {"x": T.hp.uniform("x", -3, 3)}, algo=algo,
               max_evals=12, trials=trials, rstate=np.random.default_rng(2),
               show_progressbar=False, max_speculation=0)
        return winners(trials.trials)

    assert run(batched) == run(partial(T.tpe.suggest, n_startup_jobs=5, **KW))
