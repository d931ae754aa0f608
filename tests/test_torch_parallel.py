"""``TorchTrials``, the port's in-process parallel backend, on the CPU: the
six behaviours of the JAX package's ``JaxTrials`` tests
(``tests/test_parallel.py``), its plane counters, and the multi-id
suggests the backend's queue hands to ``tpe.suggest`` against the JAX
package's.  No assert reads a clock: concurrency is shown with a barrier,
and every wait has its own timeout, so no test can hang the suite.
"""

import copy
import os
import sys
import threading
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu.models import domains as jdomains
from hyperopt_tpu_torch.algos import tpe as ttpe
from hyperopt_tpu_torch.models import domains
from hyperopt_tpu_torch.parallel import TorchTrials
from test_torch_tpe import jax_streams  # JAX's uniforms, for injection

CPU_RAND = partial(T.rand.suggest, device="cpu")
CPU_TPE = partial(T.tpe.suggest, device="cpu")
WAIT_S = 60  # the bound of every wait below; none is reached when the code is right


def run(fn, space, trials, algo=CPU_RAND, max_evals=8, **kw):
    return T.fmin(fn, space, algo=algo, max_evals=max_evals, trials=trials,
                  rstate=np.random.default_rng(0), show_progressbar=False, verbose=False,
                  **kw)


def branin_torch(c):
    x, y = c["x"], c["y"]
    a, b, cc = 1.0, 5.1 / (4 * np.pi ** 2), 5.0 / np.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
    return a * (y - b * x ** 2 + cc * x - r) ** 2 + s * (1 - t) * torch.cos(x) + s


# -- the reference backend's six behaviours ---------------------------------


def test_parallel_fmin_runs_all_trials():
    d = domains.get("quadratic1")
    trials = TorchTrials(parallelism=4, device="cpu")
    best = run(d.fn, d.space, trials, max_evals=20)
    assert len(trials) == 20
    assert all(t["state"] == T.JOB_STATE_DONE for t in trials.trials)
    assert "x" in best
    assert trials.host_trials == 20 and trials.device_batches == 0


def test_trials_actually_run_concurrently():
    """Each objective waits at a barrier of ``parallelism`` parties: the run
    completes without error only if that many objectives are in flight at
    once, every generation of the barrier."""
    parallelism = 4
    barrier = threading.Barrier(parallelism, timeout=WAIT_S)

    def together(c):
        barrier.wait()
        return (c["x"] - 3) ** 2

    trials = TorchTrials(parallelism=parallelism, device="cpu")
    run(together, {"x": T.hp.uniform("x", -5, 5)}, trials, max_evals=2 * parallelism,
        return_argmin=False)
    states = [t["state"] for t in trials.trials]
    assert states == [T.JOB_STATE_DONE] * (2 * parallelism), [
        t["misc"].get("error") for t in trials.trials]


def test_trial_timeout_cancels():
    """Objectives at x > 0 wait on an event that is set only after the run:
    each is cancelled by ``trial_timeout``; the others finish."""
    release = threading.Event()

    def sometimes_hangs(c):
        if c["x"] > 0:
            release.wait(WAIT_S)
        return abs(c["x"])

    trials = TorchTrials(parallelism=4, trial_timeout=2.0, device="cpu")
    try:
        run(sometimes_hangs, {"x": T.hp.uniform("x", -5, 5)}, trials, max_evals=8,
            timeout=WAIT_S, return_argmin=False)
    finally:
        release.set()
    by_sign = {(t["misc"]["vals"]["x"][0] > 0): t["state"] for t in trials._dynamic_trials}
    assert by_sign == {True: T.JOB_STATE_CANCEL, False: T.JOB_STATE_DONE}
    for t in trials._dynamic_trials:
        assert t["state"] == (T.JOB_STATE_CANCEL if t["misc"]["vals"]["x"][0] > 0
                              else T.JOB_STATE_DONE)


def test_objective_error_recorded():
    def sometimes_fails(c):
        if c["x"] < 0:
            raise RuntimeError("neg")
        return c["x"]

    trials = TorchTrials(parallelism=2, device="cpu")
    run(sometimes_fails, {"x": T.hp.uniform("x", -5, 5)}, trials,
        catch_eval_exceptions=True, return_argmin=False)
    errs = [t for t in trials._dynamic_trials if t["state"] == T.JOB_STATE_ERROR]
    assert errs and all("neg" in t["misc"]["error"][1] for t in errs)
    assert all((t["state"] == T.JOB_STATE_ERROR) == (t["misc"]["vals"]["x"][0] < 0)
               for t in trials._dynamic_trials)


def test_device_plane_vectorized_eval():
    """A dense space goes to the device plane only: one vmapped call per
    claimed batch, each loss equal to the host objective to rel 1e-4
    (float32 against float64)."""
    d = domains.get("branin")
    trials = TorchTrials(parallelism=8, device_fn=branin_torch, device="cpu")
    run(d.fn, d.space, trials, max_evals=24, return_argmin=False)
    assert len(trials) == 24
    assert trials.device_batches > 0 and trials.host_trials == 0
    for t in trials.trials:
        assert t["state"] == T.JOB_STATE_DONE
        cfg = {k: v[0] for k, v in t["misc"]["vals"].items()}
        assert t["result"]["loss"] == pytest.approx(d.fn(cfg), rel=1e-4)


def test_tpe_with_parallel_backend():
    d = domains.get("quadratic1")
    trials = TorchTrials(parallelism=4, device="cpu")
    run(d.fn, d.space, trials, algo=CPU_TPE, max_evals=40, return_argmin=False)
    assert len(trials) == 40
    assert min(trials.losses()) < 0.5


# -- planes, ids per suggest, arguments --------------------------------------


def test_conditional_space_goes_to_host_threads():
    """Ragged configs (two branches) leave the device plane for host
    threads; every trial finishes with the host objective's loss."""
    d = domains.get("q1_choice")

    def leaf(c):  # a batch that happens to be dense holds one branch
        x = c["xl"] if "xl" in c else c["xr"]
        return (x - 3.0) ** 2

    trials = TorchTrials(parallelism=8, device_fn=leaf, device="cpu")
    run(d.fn, d.space, trials, max_evals=24, return_argmin=False)
    assert trials.host_trials > 0
    for t in trials.trials:
        assert t["state"] == T.JOB_STATE_DONE
        point = {k: v[0] for k, v in t["misc"]["vals"].items() if v}
        assert t["result"]["loss"] == pytest.approx(
            d.fn(T.space_eval(d.space, point)), rel=1e-4)


def test_failed_device_batch_marks_its_trials_error():
    def broken(c):
        raise ValueError("no device objective")

    d = domains.get("branin")
    trials = TorchTrials(parallelism=4, device_fn=broken, device="cpu")
    run(d.fn, d.space, trials, return_argmin=False)
    assert trials.device_batches > 0 and trials.host_trials == 0
    assert all(t["state"] == T.JOB_STATE_ERROR and "no device objective" in t["misc"]["error"][1]
               for t in trials.trials)


def test_many_threads_lose_no_update():
    """Twice as many threads as cores and a 1 µs switch interval: every
    trial ends DONE with its own objective's loss, and ``host_trials``
    counts each trial once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trials = TorchTrials(parallelism=2 * (os.cpu_count() or 4), device="cpu")
        run(lambda c: c["x"], {"x": T.hp.uniform("x", -5, 5)}, trials, max_evals=64,
            timeout=WAIT_S, return_argmin=False)
    finally:
        sys.setswitchinterval(old)
    assert len(trials) == 64 and trials.host_trials == 64
    for t in trials.trials:
        assert t["state"] == T.JOB_STATE_DONE
        assert t["result"]["loss"] == t["misc"]["vals"]["x"][0]


def test_queue_depth_gives_multi_id_suggests():
    """The queue is kept ``parallelism`` deep, so one suggest call gets
    several ids."""
    ids_per_call = []

    def counting(new_ids, domain, trials, seed):
        ids_per_call.append(len(new_ids))
        return T.rand.suggest(new_ids, domain, trials, seed, device="cpu")

    d = domains.get("quadratic1")
    trials = TorchTrials(parallelism=4, device="cpu")
    run(d.fn, d.space, trials, algo=counting, max_evals=12, return_argmin=False)
    assert len(trials) == 12 and sum(ids_per_call) == 12 and max(ids_per_call) == 4


def test_arguments():
    assert TorchTrials(device="cpu").parallelism == 1
    assert TorchTrials(parallelism=1000, device="cpu").parallelism == 128
    with pytest.raises(NotImplementedError, match="item 7"):
        TorchTrials(mesh=object(), device="cpu")
    trials = TorchTrials(device="cpu")
    for kw in ({"retry_policy": object()}, {"fault_stats": object()}):
        with pytest.raises(NotImplementedError, match="item 8"):
            trials.fmin(lambda c: 0.0, {"x": T.hp.uniform("x", 0, 1)}, algo=CPU_RAND,
                        max_evals=1, **kw)


# -- a 4-id suggest against the JAX package's --------------------------------


def test_four_id_suggest_winners_match_jax(monkeypatch):
    """``tpe.suggest`` with 4 ids (the k segments of one family program)
    fed JAX's streams: the winners equal JAX's to rtol 1e-5 on >= 95% of
    (seed, id, label) values, and the docs' idxs are equal."""
    jd = jdomains.get("many_dists")
    jt = J.Trials()
    J.fmin(jd.fn, jd.space, algo=J.rand.suggest, max_evals=150, trials=jt,
           rstate=np.random.default_rng(4), show_progressbar=False, verbose=False)
    tt = T.trials_from_docs(copy.deepcopy(jt.trials))
    jdom = J.Domain(jd.fn, jd.space)
    tdom = T.Domain(domains.get("many_dists").fn, domains.get("many_dists").space)
    monkeypatch.setattr(ttpe, "_label_uniforms", jax_streams)
    ids = [500, 501, 502, 503]
    n, close = 0, 0
    for seed in range(6):
        jdocs = J.tpe.suggest(ids, jdom, jt, seed, n_EI_candidates=64)
        tdocs = T.tpe.suggest(ids, tdom, tt, seed, n_EI_candidates=64, device="cpu")
        assert [d["misc"]["idxs"] for d in tdocs] == [d["misc"]["idxs"] for d in jdocs]
        for jdoc, tdoc in zip(jdocs, tdocs):
            for lb, jv in jdoc["misc"]["vals"].items():
                n += 1
                close += bool(np.isclose(tdoc["misc"]["vals"][lb][0], jv[0], rtol=1e-5, atol=0))
    assert close >= 0.95 * n, (close, n)
